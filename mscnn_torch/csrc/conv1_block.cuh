// The fused VGG conv1 block's schedule on Hopper, shared by K2
// (conv1_pool.cu) and K3 (conv1_v5.cu): conv1_1 (3->64, 3x3, pad 1) + ReLU
// -> conv1_2 (64->64, 3x3, pad 1) + ReLU -> 2x2/2 ceil-mode max pool. bf16
// NHWC in and out, bf16 weights, f32 tensor-core sums. The two kernels
// differ only in where they round, which the kernel template takes as two
// policies:
//
//   * an epilogue policy, the bias add (`BiasBf16`: the conv's output
//     rounded to bf16, then a bf16 add of the bf16 bias, as
//     mscnn_tpu/ops/conv.py::conv2d rounds -- K2; `BiasF32`: the f32 bias
//     added to the f32 sum and rounded once, as the conv1_v5 probe does --
//     K3), then ReLU, in bf16 pairs;
//   * an accumulation policy (`AccF32`: one f32 sum over all taps;
//     `AccBf16`: K3's mode bf16, a bf16 accumulator with six rounding
//     points per conv).
//
// Bound on an H100: operations. Per input pixel conv1_1 is 2*27*64 = 3,456
// FLOP and conv1_2 2*576*64 = 73,728: 77,184 FLOP a pixel, 0.153 ms a
// 768x2560 image at the 989 TFLOP/s bf16 peak, against 0.02 ms for its
// bytes (4.7 MB in, 63 MB pooled out). Unfused, the two full-resolution
// activations (252 MB each at batch 4) would cross device memory twice.
//
// Schedule:
//   * a persistent grid: one CTA per SM (512 threads, four warpgroups)
//     walks tiles of TH x 32 conv1_2 outputs over all 64 channels in
//     row-major order (image, tile row, tile column), so that the CTAs in
//     flight work on neighbouring tiles and their input halos meet in L2;
//   * each CTA loads its weights once: w2 (73,728 B) stays resident in
//     shared memory as 9 taps x [64 co x 64 ci] bf16 blocks and w1 as
//     [64 co x 64 k], both K-major in the 128-byte swizzle (the wrapper,
//     `conv1_kernel.py::pack_conv1_weights`, writes those layouts, so the
//     copies are linear);
//   * conv1_1 on wgmma.mma_async m64n64k16 bf16 -> f32 over the tile and
//     its 1-pixel ring ((TH + 2) x 34 positions, 64-position M blocks): A
//     is gathered per lane from the staged bf16 halo (pixels of 4
//     channels, the 4th zero) as the register A fragment -- with k = dx * 4
//     + c each fragment register is one aligned 32-bit load and holds one
//     dx -- and B is w1, one 16-deep slice per kernel row dy (dx = 3 and
//     c = 3 carry zero weights and are not read). It writes bf16 into the
//     y1 tile in shared memory; ring positions outside the image are
//     stored as 0 (conv1_2's zero padding), not as conv1_1 of the padded
//     input;
//   * conv1_2 on wgmma.mma_async m64n32k16 bf16 -> f32, K = 9 taps x 64,
//     with the output channels as M and the pixels as N: D [64 co x 32 px]
//     = W2_tap [64 co x 16 ci] . Y1_shifted [16 ci x 32 px]. A tap is the y1
//     tile shifted by one pixel. y1 is stored as 128-byte rows (one pixel,
//     64 channels) in the 128-byte swizzle, so a run of 32 pixels of one y1
//     row, starting at any pixel, is a K-major B operand: its descriptor
//     starts at that pixel's row (the swizzle follows the address bits, so
//     the base offset stays 0). No im2col copy, no shifted copies. A, the
//     tap's weights, comes from registers (ldmatrix.x4 from w2 gives each
//     warp its 16 output channels, the m16n8k16 A fragment, which is
//     wgmma's per-warp register layout) and serves the wgmmas of all the
//     output rows of a round. The next k-step's A is loaded while the
//     current step's wgmmas run (two register buffers; wgmma.wait_group 1
//     before a buffer is reused). Each warpgroup owns TH / 4 output rows;
//     `AccF32` runs two a round (32 f32 accumulators a thread: at 512
//     threads a thread has 128 registers, and four rows a round spill),
//     `AccBf16` one (three accumulator sets, see below);
//   * overlap: the next tile's input halo is loaded into registers before
//     this tile's conv1_1 and stored to shared memory after its conv1_2, so
//     its latency hides behind the math. (TMA cannot fetch it: a 3-channel
//     bf16 pixel is 6 bytes, and an odd W gives rows that are not 16-byte
//     multiples; cp.async needs 4-byte aligned sources, which odd W breaks
//     too.) The pooled tile's copy to device memory overlaps the next
//     tile's conv1_1, and four warpgroups keep the tensor cores busy while
//     others gather or run an epilogue. There is no mbarrier: two
//     __syncthreads a tile order the phases;
//   * the epilogues work in registers on bf16 pairs. A conv1_2 thread holds
//     two channels of pixels x, x + 1 of output rows y and y + 1, so the
//     2x2 window is its own: bias and ReLU (the epilogue policy, rounded to
//     bf16), -inf at conv1_2 outputs outside the image, then the max. The
//     max of bf16 values is exact, and where the reference pools f32
//     values and rounds once (K3), rounding first gives the same value:
//     round-to-nearest is monotone. With odd H or W the last pooled row or
//     column is a ceil-mode partial window (its missing half is -inf). The
//     pooled tile ((TH / 2) x 16 pixels x 64 channels) is staged in shared
//     memory and written with 16-byte stores, 2 KB contiguous a pooled row.
//
// `AccBf16` (K3's mode bf16, examples/profile_conv1_v5.py:63, :70-78):
// for each kernel row dy, a "center" partial (taps dx 1 + 2 for an even
// output column, dx 0 + 1 for an odd one) and a "mixed" one (dx 0 even,
// dx 2 odd), each rounded to bf16 and added to a bf16 accumulator with a
// bf16 rounding: six rounding points per conv. In conv1_1 the positions
// are M, so a row's A fragment is masked by dx per position parity (a
// fragment register holds one dx) and one wgmma gives each partial. In
// conv1_2 the pixels are N and a thread's D fragment holds an even and an
// odd column of each pair, so each dx gets its own f32 accumulator set
// (P0, P1, P2, four k-steps each) and the partials are formed in
// registers by column parity: up to 48 accumulators for one output row, so
// a round is one row. The round's row is folded into the staged pooled
// tile at once rather than held in registers across the next row's
// wgmma chain (held there, it came out wrong).
//
// Shared memory (one CTA an SM) at TH = 16: w2 73,728 B + w1 8,192 B + y1
// with its ring 612 x 128 B = 78,336 B + input halo 720 x 8 B = 5,760 B +
// pooled tile 16,384 B + biases 512 B = 182,912 B, plus 1 KB to align the
// base; at TH = 24, 228,224 B.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace conv1_block {

constexpr int C = 64;                      // conv1 channels
constexpr int TW = 32;                     // conv1_2 output columns a tile (one N block)
constexpr int WGS = 4;                     // warpgroups: each owns TH / WGS output rows
constexpr int THREADS = 128 * WGS;
constexpr int STEPS = 9 * (C / 16);        // conv1_2 k-steps: 9 taps x 4

template <int TH>
struct Tile {
  static constexpr int YH = TH + 2, YW = TW + 2;   // conv1_1 tile with its ring
  static constexpr int XH = TH + 4, XW = TW + 4;   // input halo
  static constexpr int NP = YH * YW;               // conv1_1 positions
  static constexpr int NX = XH * XW;               // halo pixels
  static constexpr int RPW = TH / WGS;             // conv1_2 output rows a warpgroup
  static constexpr int XPT = (NX + THREADS - 1) / THREADS;   // halo pixels a thread
  static constexpr int ST_PIX = (TH / 2) * (TW / 2);         // pooled pixels a tile
  // shared memory from a 1,024-aligned base (the swizzle atom)
  static constexpr int SZ_W2 = 9 * C * C * 2;                // 73,728
  static constexpr int OFF_W1 = SZ_W2;                       // [64 co][64 k] bf16
  static constexpr int OFF_Y1 = OFF_W1 + C * 128;            // [NP positions][64] bf16
  static constexpr int OFF_X = OFF_Y1 + NP * 128;            // [NX pixels][4] bf16
  static constexpr int OFF_ST = OFF_X + NX * 8;              // [ST_PIX][64] bf16
  static constexpr int OFF_B = OFF_ST + ST_PIX * 128;        // b1, b2 f32
  static constexpr int SMEM = OFF_B + 2 * C * 4 + 1024;
  static_assert(TH % (2 * WGS) == 0, "whole pooled rows for every warpgroup");
  static_assert(OFF_Y1 % 1024 == 0 && OFF_X % 16 == 0 && OFF_ST % 16 == 0, "aligned regions");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  static_assert(ST_PIX * 8 % THREADS == 0, "whole copy-out rounds");
};

// byte offset of 16-byte chunk c of 128-byte row r in the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(uint32_t r, uint32_t c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_reg(r[e]);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one step of the bf16 accumulator: acc = bf16(acc + bf16(partial)) (`_rn`
// intrinsics, so nvcc cannot contract)
__device__ __forceinline__ __nv_bfloat16 bf16_acc(__nv_bfloat16 acc, float partial) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(acc), bf16r(partial)));
}

// Shared-memory descriptor of a K-major B operand: rows of 128 bytes (64
// bf16), 8-row core groups 1,024 bytes apart, 128-byte swizzle (layout 1).
// The swizzle phase comes from the address bits themselves, so a start at
// any row of a 1,024-aligned swizzled buffer takes base offset 0 (on the
// H100, base offset (address >> 7) & 7 reads the wrong chunks). Adding n to
// the descriptor moves its start by 16 n bytes (the address field has room
// for all of shared memory).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d = a * b (SCALE_D 0) or d += a * b (1): wgmma m64n32k16, bf16 in, f32
// accumulate; A (this warp's 16 rows) from registers, B K-major from shared
// memory.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, %21, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SCALE_D));
}

// d = a * b: wgmma m64n64k16, bf16 in, f32 accumulate, A from registers,
// B K-major from shared memory (SCALE_D 0 overwrites d, 1 adds to it).
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, %37, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SCALE_D));
}

// ---- epilogue policies: bias + ReLU of an f32 pair, as a bf16 pair ----------

// K2: the conv's output rounded to bf16, then a bf16 add of the bf16 bias
// (mscnn_tpu/ops/conv.py::conv2d; the sum of two bf16 values rounds the
// same in one step as through float), then ReLU.
struct BiasBf16 {
  using Bias = __nv_bfloat162;
  static __device__ __forceinline__ Bias pair(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ __nv_bfloat162 apply(float a, float b, Bias bias) {
    return __hmax2(__hadd2(__floats2bfloat162_rn(a, b), bias), __float2bfloat162_rn(0.f));
  }
};

// K3: the f32 bias added to the f32 sum, ReLU, one rounding to bf16
// (examples/profile_conv1_v5.py:115, :141).
struct BiasF32 {
  using Bias = float2;
  static __device__ __forceinline__ Bias pair(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ __nv_bfloat162 apply(float a, float b, Bias bias) {
    return __floats2bfloat162_rn(fmaxf(__fadd_rn(a, bias.x), 0.f),
                                 fmaxf(__fadd_rn(b, bias.y), 0.f));
  }
};

// ---- accumulation policies ----------------------------------------------------

// One f32 sum over every tap (K2; K3's modes serial, mc and flat).
struct AccF32 {
  static constexpr int ROWS = 2;   // conv1_2 output rows a round
  static constexpr bool BIAS_IN_REGS = true;   // conv1_1's bias pairs

  // conv1_1 of one 64-position M block: y = sum over dy of A[dy] . w1[dy].
  __device__ static __forceinline__ void conv1_1(float (&y)[32], const uint32_t (&a)[3][4],
                                                 uint64_t w1d, const bool (&)[2], int) {
    wgmma_fence();
    wgmma_n64<0>(y, a[0], w1d);
    wgmma_n64<1>(y, a[1], w1d + 2);
    wgmma_n64<1>(y, a[2], w1d + 4);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
  }

  // conv1_2 of ROWS output rows: step s is tap s / 4, input channels
  // (s % 4) * 16 ..; N block nb is output row nb of the round, all 32
  // columns. w2b: w2's base; y1b: the round's first y1 row (the tap dy =
  // 0, dx = 0 view); a_off[kc]: this lane's ldmatrix offset in a tap block.
  template <int YW>
  __device__ static __forceinline__ void conv1_2(float (&acc)[ROWS][16], uint32_t w2b,
                                                 uint32_t y1b, const uint32_t (&a_off)[4]) {
    const uint64_t d0 = b_desc(y1b);
    uint32_t af[2][4];
    ldsm_x4(w2b + a_off[0], af[0]);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int tap = s / 4, kc = s % 4, dy = tap / 3, dx = tap % 3;
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < ROWS; ++nb) {
        const uint64_t db = d0 + ((((nb + dy) * YW + dx) * 128 + kc * 32) >> 4);
        if (s == 0)
          wgmma_n32<0>(acc[nb], af[0], db);   // the first step overwrites
        else
          wgmma_n32<1>(acc[nb], af[s & 1], db);
      }
      wgmma_commit();
      if (s + 1 < STEPS) {
        wgmma_wait<1>();   // step s - 1 has retired: its A buffer is free
        const int tn = (s + 1) / 4, kn = (s + 1) % 4;
        ldsm_x4(w2b + tn * C * 128 + a_off[kn], af[(s + 1) & 1]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < ROWS; ++nb) fence_regs(acc[nb]);
  }
};

// K3's mode bf16: a bf16 accumulator, for each dy += bf16(center) then +=
// bf16(mixed), each add rounded to bf16 (see the notes at the top). The
// accumulator is kept as bf16 pairs (elements 2 i, 2 i + 1 of a fragment)
// and returned as f32 holding bf16 values.
struct AccBf16 {
  static constexpr int ROWS = 1;
  static constexpr bool BIAS_IN_REGS = false;

  // odd[hh]: position row hh of this lane (g8 + 8 hh) is an odd image
  // column. A fragment register reg holds k = 2 t4 + 8 (reg >> 1) .. + 1
  // of its row: one tap, dx = (t4 >> 1) + 2 (reg >> 1) (dx = 3 is zero).
  __device__ static __forceinline__ void conv1_1(float (&y)[32], const uint32_t (&a)[3][4],
                                                 uint64_t w1d, const bool (&odd)[2], int t4) {
    __nv_bfloat162 acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int part = 0; part < 2; ++part) {   // center, mixed
        uint32_t am[4];
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const int dx = (t4 >> 1) + 2 * (reg >> 1);
          const bool o = odd[reg & 1];
          const bool keep = part == 0 ? (o ? dx <= 1 : dx >= 1) : (o ? dx == 2 : dx == 0);
          am[reg] = keep ? a[dy][reg] : 0u;
        }
        float f[32];
        wgmma_fence();
        wgmma_n64<0>(f, am, w1d + 2 * dy);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(f);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          acc[i].x = bf16_acc(acc[i].x, f[2 * i]);
          acc[i].y = bf16_acc(acc[i].y, f[2 * i + 1]);
        }
      }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      y[2 * i] = __low2float(acc[i]);
      y[2 * i + 1] = __high2float(acc[i]);
    }
  }

  // d[0..3] += A . B over four k-steps (16 input channels each) of tap
  // `tap`, from y1 descriptor start d0 (the tap's shifted view); A is
  // loaded into the two register buffers af ahead of its step. The bases
  // pass through an empty asm, so the addresses of the row's 36 steps are
  // not all computed ahead into registers.
  __device__ static __forceinline__ void tap_steps(float (&d)[16], uint32_t w2b, int tap,
                                                   uint64_t d0, const uint32_t (&a_off)[4]) {
    uint32_t wb = w2b + tap * C * 128;
    uint64_t db = d0;
    asm volatile("" : "+r"(wb), "+l"(db));
    uint32_t af[2][4];
    ldsm_x4(wb + a_off[0], af[0]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_fence();
      if (kc == 0)
        wgmma_n32<0>(d, af[0], db);
      else
        wgmma_n32<1>(d, af[kc & 1], db + 2 * kc);
      wgmma_commit();
      if (kc < 3) {
        wgmma_wait<1>();
        ldsm_x4(wb + a_off[kc + 1], af[(kc + 1) & 1]);
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
  }

  // One output row. Per dy the three taps' sums P0, P1, P2 (f32, four
  // k-steps each), taken apart by column parity: element e = 4 j + 2 hh +
  // u of a D fragment is column 8 j + 2 t4 + u, even for u = 0 (tiles start
  // at even columns). P1 and P0 come first: the odd columns' center (P0 +
  // P1) goes into the accumulator at once and the even columns keep their
  // halves of P0 and P1 (16 registers, not 32) until P2.
  template <int YW>
  __device__ static __forceinline__ void conv1_2(float (&acc)[ROWS][16], uint32_t w2b,
                                                 uint32_t y1b, const uint32_t (&a_off)[4]) {
    const uint64_t d0 = b_desc(y1b);
    __nv_bfloat162 ap[8];   // (even, odd) column pairs
#pragma unroll
    for (int i = 0; i < 8; ++i) ap[i] = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint64_t dd = d0 + ((dy * YW * 128) >> 4);   // + 8 a dx (128 bytes)
      float p0e[8], p1e[8];
      {
        float p0[16], p1[16];
        tap_steps(p1, w2b, 3 * dy + 1, dd + 8, a_off);
        tap_steps(p0, w2b, 3 * dy, dd, a_off);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          p0e[i] = p0[2 * i];
          p1e[i] = p1[2 * i];
          ap[i].y = bf16_acc(ap[i].y, __fadd_rn(p0[2 * i + 1], p1[2 * i + 1]));
        }
      }
      float p2[16];
      tap_steps(p2, w2b, 3 * dy + 2, dd + 16, a_off);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ap[i].x = bf16_acc(bf16_acc(ap[i].x, __fadd_rn(p1e[i], p2[2 * i])), p0e[i]);
        ap[i].y = bf16_acc(ap[i].y, p2[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[0][2 * i] = __low2float(ap[i]);
      acc[0][2 * i + 1] = __high2float(ap[i]);
    }
  }
};

// ---- the kernel -----------------------------------------------------------------

struct Grid {
  int H, W, OH, OW, tiles_x, tiles_y, tiles;
};

template <int TH>
__device__ __forceinline__ void tile_origin(const Grid& g, int t, int& b, int& r0, int& c0) {
  const int tx = t % g.tiles_x;
  const int r = t / g.tiles_x;
  b = r / g.tiles_y;
  r0 = (r - b * g.tiles_y) * TH;
  c0 = tx * TW;
}

// The input halo of tile t (tile + 2 px each side, 0 outside the image or
// past the last tile) into registers: thread i holds pixels i + THREADS k.
template <int TH>
__device__ __forceinline__ void halo_load(const Grid& g, const unsigned short* __restrict__ x,
                                          int t, int i0, uint32_t (&h)[Tile<TH>::XPT][2]) {
  using T = Tile<TH>;
  int b = 0, r0 = 0, c0 = 0;
  if (t < g.tiles) tile_origin<TH>(g, t, b, r0, c0);
#pragma unroll
  for (int k = 0; k < T::XPT; ++k) {
    const int i = i0 + k * THREADS;
    const int gr = r0 - 2 + i / T::XW, gc = c0 - 2 + i % T::XW;
    h[k][0] = h[k][1] = 0u;
    if (t < g.tiles && i < T::NX && gr >= 0 && gr < g.H && gc >= 0 && gc < g.W) {
      const unsigned short* p = x + (((size_t)b * g.H + gr) * g.W + gc) * 3;
      h[k][0] = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 16);
      h[k][1] = (uint32_t)__ldg(p + 2);
    }
  }
}

// ... and from registers into the staged halo (bf16, channel stride 4).
template <int TH>
__device__ __forceinline__ void halo_store(unsigned short* s_x, int i0,
                                           const uint32_t (&h)[Tile<TH>::XPT][2]) {
#pragma unroll
  for (int k = 0; k < Tile<TH>::XPT; ++k) {
    const int i = i0 + k * THREADS;
    if (i < Tile<TH>::NX) *reinterpret_cast<uint2*>(s_x + i * 4) = make_uint2(h[k][0], h[k][1]);
  }
}

template <int TH, class Acc, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
conv1_block_kernel(const unsigned short* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                   const Grid g) {
  using T = Tile<TH>;
  constexpr int YW = T::YW, XW = T::XW, NP = T::NP, RPW = T::RPW, NB = Acc::ROWS;
  static_assert(NB == 1 || NB == 2, "a round's rows lie in one pooled row");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp within it
  const int g8 = lane >> 2, t4 = lane & 3;   // mma fragment row group, column pair
  const int q = lane >> 3, r8 = lane & 7;    // ldmatrix: matrix q, row r8
  unsigned char* s_y1 = smem + T::OFF_Y1;
  unsigned short* s_x = reinterpret_cast<unsigned short*>(smem + T::OFF_X);
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem + T::OFF_W1);
  unsigned char* s_st = smem + T::OFF_ST;
  float* s_b1 = reinterpret_cast<float*>(smem + T::OFF_B);
  float* s_b2 = s_b1 + C;

  // weights, once per CTA (w2 is already in the swizzled layout), and the
  // first tile's halo
  for (int i = tid; i < T::SZ_W2 / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(w2)[i];
  for (int i = tid; i < C * 8; i += THREADS)
    reinterpret_cast<uint4*>(s_w1)[i] = reinterpret_cast<const uint4*>(w1)[i];
  if (tid < C) {
    s_b1[tid] = b1[tid];
    s_b2[tid] = b2[tid];
  }
  uint32_t h[T::XPT][2];
  halo_load<TH>(g, x, blockIdx.x, tid, h);
  halo_store<TH>(s_x, tid, h);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // w1 -> wgmma's reads
  __syncthreads();

  const uint64_t w1d = b_desc(smem_u32(s_w1));   // conv1_1's B; + 2 per dy (32 bytes)
  // conv1_1's bias for channels 8 j + 2 t4, + 1: kept in registers where the
  // accumulation policy leaves room for them (reading them from shared
  // memory in each conv1_1 epilogue costs K2 6%), else read at each use
  typename Epi::Bias b1p[Acc::BIAS_IN_REGS ? 8 : 1];
  if constexpr (Acc::BIAS_IN_REGS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) b1p[j] = Epi::pair(s_b1[8 * j + 2 * t4], s_b1[8 * j + 2 * t4 + 1]);
  }
  typename Epi::Bias b2p[2];   // conv1_2's bias for channel 16 wq + g8 + 8 hh (both pixels)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float v = s_b2[16 * wq + g8 + 8 * hh];
    b2p[hh] = Epi::pair(v, v);
  }
  // conv1_2's A: warp wq's output channels 16 wq .. + 15; ldmatrix matrix q
  // holds channels (q & 1) * 8 .., k chunk (q >> 1) of a 16-deep step, at
  // byte a_off[kc] of a tap's block
  const int a_row = 16 * wq + (q & 1) * 8 + r8;
  uint32_t a_off[4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) a_off[kc] = swz(a_row, 2 * kc + (q >> 1));

  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int b, r0, c0;
    tile_origin<TH>(g, t, b, r0, c0);
    halo_load<TH>(g, x, t + gridDim.x, tid, h);   // the next tile's halo, in flight
    const bool edge = r0 + TH > g.H || c0 + TW > g.W;   // masks needed

    // 1. conv1_1 + bias + ReLU over the tile and its ring, on wgmma: M
    //    block blk = 64 consecutive positions (row-major over YH x YW), warp
    //    wq's 16 of them gathered per lane from the staged halo as the A
    //    fragment, one m64n64k16 per kernel row dy against w1
#pragma unroll 1
    for (int blk = wg; blk < (NP + 63) / 64; blk += WGS) {
      int pos[2], base[2];
      bool odd[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pos[hh] = blk * 64 + 16 * wq + g8 + hh * 8;
        const int p = pos[hh] < NP ? pos[hh] : NP - 1;
        base[hh] = ((p / YW) * XW + p % YW) * 4;
        odd[hh] = (p % YW) % 2 == 0;   // image column c0 - 1 + p % YW, c0 even
      }
      // a[dy][reg]: rows g8 + 8 (reg & 1), k 2 t4 + 8 (reg >> 1) .. + 1 of
      // kernel row dy, k = dx * 4 + c: one aligned 32-bit load each; k 12 ..
      // 15 (dx = 3) has zero weights and is not read
      uint32_t a[3][4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const unsigned short* px = s_x + base[reg & 1] + dy * XW * 4 + 2 * t4 + 8 * (reg >> 1);
          a[dy][reg] = (reg < 2 || t4 < 2) ? *reinterpret_cast<const uint32_t*>(px) : 0u;
        }
      float y[32];
      Acc::conv1_1(y, a, w1d, odd, t4);
      // bias + ReLU, 0 outside the image (conv1_2's zero padding), bf16,
      // into y1 row pos (128 bytes, swizzled)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (pos[hh] >= NP) continue;
        const int gr = r0 - 1 + pos[hh] / YW, gc = c0 - 1 + pos[hh] % YW;
        const bool in = gr >= 0 && gr < g.H && gc >= 0 && gc < g.W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          typename Epi::Bias bias;
          if constexpr (Acc::BIAS_IN_REGS) {
            bias = b1p[j];
          } else {
            const float2 f = *reinterpret_cast<const float2*>(s_b1 + 8 * j + 2 * t4);
            bias = Epi::pair(f.x, f.y);
          }
          const __nv_bfloat162 v = Epi::apply(y[4 * j + 2 * hh], y[4 * j + 2 * hh + 1], bias);
          *reinterpret_cast<uint32_t*>(s_y1 + swz(pos[hh], j) + 4 * t4) = in ? as_u32(v) : 0u;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // y1 -> wgmma's reads
    __syncthreads();   // y1 complete; the staged halo and the pooled tile are free

    // 2. conv1_2 on wgmma, NB output rows a round. The bases pass through
    //    an empty asm each round, so the compiler builds the descriptors and
    //    A addresses from them as immediates instead of hoisting them into
    //    registers.
#pragma unroll 1
    for (int rr = 0; rr < RPW; rr += NB) {
      uint32_t w2b = smem_u32(smem), y1b = smem_u32(s_y1) + (RPW * wg + rr) * YW * 128;
      asm volatile("" : "+r"(w2b), "+r"(y1b));
      float acc[NB][16];
      Acc::template conv1_2<YW>(acc, w2b, y1b, a_off);

      // 3. epilogue: the thread holds channels 16 wq + g8 (+ 8) of columns
      //    8 j + 2 t4, + 1 of each of the round's rows: bias + ReLU (bf16
      //    pairs), -inf outside the image, the max over the pair and the
      //    round's rows, into the staged pooled tile (swizzled by pixel). A
      //    round of one row keeps the top row's max there (each thread owns
      //    its pooled values) and folds the bottom row in next round, so no
      //    row is held in registers across the next round's wgmmas.
      const int orow = r0 + RPW * wg + rr;   // the round's first output row
      const int prl = (RPW * wg + rr) / 2;   // pooled row in the tile
      const bool bottom = NB == 1 && (rr & 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 8 * j + 2 * t4;
        const int pix = prl * (TW / 2) + 4 * j + t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int co = 16 * wq + g8 + 8 * hh;
          __nv_bfloat162 m;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            __nv_bfloat162 v =
                Epi::apply(acc[nb][4 * j + 2 * hh], acc[nb][4 * j + 2 * hh + 1], b2p[hh]);
            if (edge) {   // -inf loses every max: the ceil-mode partial windows
              const __nv_bfloat16 ninf = __float2bfloat16_rn(-INFINITY);
              if (col >= g.W) v.x = ninf;
              if (col + 1 >= g.W) v.y = ninf;
              if (orow + nb >= g.H) v.x = v.y = ninf;
            }
            m = nb == 0 ? v : __hmax2(m, v);
          }
          __nv_bfloat16* dst =
              reinterpret_cast<__nv_bfloat16*>(s_st + swz(pix, co >> 3) + 2 * (co & 7));
          const __nv_bfloat16 mx = __hmax(m.x, m.y);
          *dst = bottom ? __hmax(*dst, mx) : mx;
        }
      }
    }
    halo_store<TH>(s_x, tid, h);   // every warp is past this tile's conv1_1
    __syncthreads();   // the pooled tile and the next halo are staged; y1 is free

    // the pooled tile to device memory, 16 bytes a thread, rows contiguous
#pragma unroll
    for (int k = 0; k < T::ST_PIX * 8 / THREADS; ++k) {
      const int i = tid + k * THREADS;
      const int pix = i >> 3, c = i & 7;
      const int prow = (r0 >> 1) + pix / (TW / 2), pcol = (c0 >> 1) + pix % (TW / 2);
      if (prow < g.OH && pcol < g.OW)
        *reinterpret_cast<uint4*>(out + (((size_t)b * g.OH + prow) * g.OW + pcol) * C + 8 * c) =
            *reinterpret_cast<const uint4*>(s_st + swz(pix, c));
    }
  }
}

inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

// x [B, H, W, 3] bf16; w1 [64 co][64 k] bf16, k = dy * 16 + dx * 4 + c (zero
// where dx or c is 3 and for k >= 48); w2 9 x [64 co][64 ci] bf16; both in
// the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)), as
// `pack_conv1_weights` writes them; b1, b2 [64] f32; out [B, ceil(H/2),
// ceil(W/2), 64] bf16. All pointers 16-byte aligned. Returns
// cudaGetLastError() after the launch.
template <int TH, class Acc, class Epi>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int batch, int H, int W, cudaStream_t stream) {
  Grid g;
  g.H = H;
  g.W = W;
  g.OH = (H + 1) / 2;
  g.OW = (W + 1) / 2;
  g.tiles_x = (W + TW - 1) / TW;
  g.tiles_y = (H + TH - 1) / TH;
  const long long tiles = (long long)g.tiles_x * g.tiles_y * batch;
  if (tiles <= 0 || tiles > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  auto kern = conv1_block_kernel<TH, Acc, Epi>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<TH>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = g.tiles < sm_count() ? g.tiles : sm_count();
  kern<<<grid, THREADS, Tile<TH>::SMEM, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace conv1_block
