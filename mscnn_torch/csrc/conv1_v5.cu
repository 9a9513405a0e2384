// conv1 block with a selectable MMA schedule (K3), forward: conv1_1 (3->64,
// 3x3, pad 1) + ReLU -> conv1_2 (64->64, 3x3, pad 1) + ReLU -> 2x2/2
// ceil-mode max pool. bf16 NHWC in and out.
//
// Replaces: examples/profile_conv1_v5.py::conv1_v5 (:160; body `_kernel_v5`
// :31), the Pallas TPU probe that asks whether another tap-contraction
// schedule beats the production conv1 kernel (K2). Its plain version is
// mscnn_torch/ops/kernels/conv1_v5_kernel.py::conv1_v5_plain.
//
// Bound on an H100: operations, 77,184 FLOP an input pixel: 0.153 ms at
// [1, 768, 2560, 3] at the 989 TFLOP/s bf16 peak (0.022 ms for the bytes).
//
// Design: K2's persistent wgmma schedule, conv1_block.cuh (one 512-thread
// CTA per SM walking the tiles in row-major order; w1 and w2 resident in
// shared memory in the 128-byte swizzle, packed by
// `conv1_kernel.py::pack_conv1_weights`; conv1_1 on wgmma m64n64k16 with a
// gathered register A; conv1_2 on wgmma m64n32k16 with the channels as M
// and the pixels as N, a tap's B a descriptor into the swizzled y1 tile at
// a shifted pixel row; the next halo loaded under the current tile's math,
// the pooled copy-out overlapping the next tile's conv1_1), with the
// probe's rounding points as the template's policies:
//
//   serial, mc, flat -- K2's function with the probe's f32 bias: one f32
//       sum over the taps (`AccF32`), the f32 bias added to it, ReLU, one
//       rounding (`BiasF32`). On the TPU the modes differ in how Mosaic is
//       handed the tap dots (six [M,128]x[128,128] dots, one
//       multi-contraction dot, one [M,768] dot over a copied operand); on
//       Hopper they are one instantiation. The schedule already runs one
//       unbroken K = 576 chain from shifted descriptors, which is the flat
//       contraction without the copy. A flat operand copied out per output
//       row (576 x 32 bf16 = 36,864 B a row, one row a warpgroup: 147,456
//       B) does not fit beside the resident w2 (73,728 B) and the y1 tile
//       in 227 KB of shared memory, so there is no im2col path.
//   bf16 -- the probe's bf16 accumulator (`AccBf16`): for each kernel row
//       dy a "center" partial (dx 1 + 2 for even output columns, dx 0 + 1
//       for odd) and a "mixed" one (dx 0 even, dx 2 odd), each rounded to
//       bf16 and added to the accumulator with a bf16 rounding, six
//       rounding points per conv; then the f32 bias, ReLU, one rounding
//       (`BiasF32`). conv1_2 keeps one f32 accumulator set per dx and forms
//       the partials in registers by column parity, so it runs one output
//       row a round: at 128 registers a thread one row already leaves
//       ptxas 16-28 bytes of spills (three loop-invariant addresses,
//       reloaded once a tile, none inside the wgmma chains).
//
// Tiles (tile_h conv1_2 output rows x tile_q pooled output columns a
// tile), each a compiled instantiation:
//   * tile_q is 16: conv1_2's N is one output row of 32 pixels (m64n32, 16
//     accumulators a row). A 64-pixel row (tile_q 32) doubles the
//     accumulators of a round to 64, the count at which K2's four-row
//     rounds spilled, and at tile_h 16 its y1 tile alone takes 152 KB
//     beside w2;
//   * tile_h is a multiple of 8, so that each of the four warpgroups owns
//     whole pooled rows: 8 (one pooled row a warpgroup, the most tiles), 16
//     (K2's 16 x 32 tile, the default) and 24, the tallest whose y1 tile
//     (26 x 34 pixels x 128 B) fits beside w2: 229,248 B of 232,448. At 32
//     it would take 273 KB.
//
// Edges (profile_conv1_v5.py:117-157): conv1_1 outside the image is 0
// before conv1_2; conv1_2 outside the image is -inf, so it loses every pool
// max; every pooled output has an in-image element, so the probe's final
// max(pooled, 0) changes nothing after the ReLU.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a tile or mode not
// compiled.

#include "conv1_block.cuh"

namespace {

using conv1_block::AccBf16;
using conv1_block::AccF32;
using conv1_block::BiasF32;

template <int TH>
int launch_mode(int mode, const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int batch, int H, int W, cudaStream_t s) {
  switch (mode) {
    case 0:   // serial
    case 1:   // mc
    case 2:   // flat: the same schedule on Hopper
      return conv1_block::launch<TH, AccF32, BiasF32>(x, w1, b1, w2, b2, out, batch, H, W, s);
    case 3:
      return conv1_block::launch<TH, AccBf16, BiasF32>(x, w1, b1, w2, b2, out, batch, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B, H, W, 3] bf16; w1, w2 as `pack_conv1_weights` packs them (see
// conv1_block.cuh::launch); b1, b2 [64] f32, not rounded; out [B, ceil(H/2),
// ceil(W/2), 64] bf16. mode: 0 serial, 1 mc, 2 flat, 3 bf16; (tile_h,
// tile_q) one of (8, 16), (16, 16), (24, 16).
extern "C" int mscnn_conv1_v5(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int batch, int H, int W,
                              int tile_h, int tile_q, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_q != 16) return (int)cudaErrorInvalidValue;
  switch (tile_h) {
    case 8:
      return launch_mode<8>(mode, x, w1, b1, w2, b2, out, batch, H, W, s);
    case 16:
      return launch_mode<16>(mode, x, w1, b1, w2, b2, out, batch, H, W, s);
    case 24:
      return launch_mode<24>(mode, x, w1, b1, w2, b2, out, batch, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
