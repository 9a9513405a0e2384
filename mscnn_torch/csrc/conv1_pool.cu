// Fused VGG conv1 block, forward (K2): conv1_1 (3->64, 3x3, pad 1) + ReLU ->
// conv1_2 (64->64, 3x3, pad 1) + ReLU -> 2x2/2 ceil-mode max pool.
// bf16 NHWC in and out, bf16 weights, f32 accumulation.
//
// Replaces: mscnn_tpu/ops/pallas/conv1_kernel.py:280 `conv1_pool_fused`
// (via `_conv1_pool_pallas` and its `_kernel`), the Pallas TPU kernel that
// runs the trunk's first block in the bf16 deploy configuration
// (pallas_conv1=True). Its plain version is `_conv1_pool_xla`, ported as
// mscnn_torch/ops/kernels/conv1_kernel.py::conv1_pool_plain. Like the JAX
// kernel (conv1_kernel.py:235, `_tap_weights(w1, bf16)`) it takes w1 rounded
// to bf16, and it rounds conv1_1's output to bf16 before conv1_2 (:142).
//
// What bounds it on an H100: operations, 0.614 ms at [4, 768, 2560, 3] at
// the 989 TFLOP/s bf16 peak, against 0.08 ms for the bytes (47 MB in, 252
// MB pooled out).
//
// Design: the persistent wgmma schedule of conv1_block.cuh (shared with
// K3, conv1_v5.cu) at 16 x 32 conv1_2 outputs a tile, with one f32 sum
// over the taps (`AccF32`, two output rows a round) and the bias added
// where the plain version adds it (`BiasBf16`: conv.py rounds the conv's
// output to bf16, then adds the bf16 bias in bf16), so the pooled values
// are bf16 values and the max is exact.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.

#include "conv1_block.cuh"

// x [B, H, W, 3] bf16; w1 [64 co][64 k] bf16, k = dy * 16 + dx * 4 + c (zero
// where dx or c is 3 and for k >= 48); w2 9 x [64 co][64 ci] bf16; both in
// the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7));
// b1, b2 [64] f32 (bf16-valued); out [B, ceil(H/2), ceil(W/2), 64] bf16. All
// pointers 16-byte aligned.
extern "C" int mscnn_conv1_pool(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int batch,
                                int H, int W, void* stream) {
  return conv1_block::launch<16, conv1_block::AccF32, conv1_block::BiasBf16>(
      x, w1, b1, w2, b2, out, batch, H, W, static_cast<cudaStream_t>(stream));
}
