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
// What bounds it on an H100: operations. Per input pixel conv1_1 is
// 2*27*64 = 3,456 FLOP and conv1_2 2*576*64 = 73,728: 77,184 FLOP a pixel,
// 0.614 ms at [4, 768, 2560, 3] at the 989 TFLOP/s bf16 peak, against
// 0.08 ms for the bytes (47 MB in, 252 MB pooled out). Unfused, the two
// full-resolution activations (252 MB each) would cross device memory twice.
//
// Design:
//   * a persistent grid: one CTA per SM (512 threads, four warpgroups)
//     walks tiles of 16 x 32 conv1_2 outputs over all 64 channels in
//     row-major order (image, tile row, tile column), so that the CTAs in
//     flight work on neighbouring tiles and their input halos meet in L2;
//   * each CTA loads its weights once: w2 (73,728 B) stays resident in
//     shared memory as 9 taps x [64 co x 64 ci] bf16 blocks and w1 as
//     [64 co x 64 k], both K-major in the 128-byte swizzle (the wrapper,
//     `pack_conv1_weights`, writes those layouts, so the copies are linear);
//   * conv1_1 on wgmma.mma_async m64n64k16 bf16 -> f32 over the tile and
//     its 1-pixel ring (18 x 34 positions, ten 64-position M blocks): A is
//     gathered per lane from the staged bf16 halo (pixels of 4 channels,
//     the 4th zero) as the register A fragment -- with k = dx * 4 + c each
//     fragment register is one aligned 32-bit load -- and B is w1, one
//     16-deep slice per kernel row dy (dx = 3 and c = 3 carry zero weights
//     and are not read). It writes bf16 into the y1 tile in shared memory;
//     ring positions outside the image are stored as 0 (conv1_2's zero
//     padding), not as conv1_1 of the padded input (conv1_kernel.py:122-142);
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
//     before a buffer is reused). Each warpgroup owns four output rows, in
//     two rounds of two (32 f32 accumulators a thread: at 512 threads a
//     thread has 128 registers, and four rows a round spill);
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
//     2x2 window is its own: bias, ReLU and -inf at conv1_2 outputs outside
//     the image, then the max. Both convs add their bias where the plain
//     version does (conv.py: the conv's bf16 output, then a bf16 add of the
//     bf16 bias), so the pooled values are bf16 values and the max is exact
//     (pooling before one final rounding would equal round-then-pool as
//     well: round-to-nearest is monotone). With odd H or W the last pooled
//     row or column is a ceil-mode partial window (its missing half is
//     -inf). The pooled tile (8 x 16 pixels x 64 channels) is staged in
//     shared memory and written with 16-byte stores, 2 KB contiguous a
//     pooled row.
//
// Shared memory (one CTA an SM): w2 73,728 B + w1 8,192 B + y1 with its
// ring 612 x 128 B = 78,336 B + input halo 720 x 8 B = 5,760 B + pooled
// tile 16,384 B + biases 512 B = 182,912 B, plus 1 KB to align the base.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 64;                      // conv1 channels
constexpr int TH = 16, TW = 32;            // conv1_2 outputs a tile
constexpr int YH = TH + 2, YW = TW + 2;    // conv1_1 tile with its ring
constexpr int XH = TH + 4, XW = TW + 4;    // input halo
constexpr int NP = YH * YW;                // conv1_1 positions: 612
constexpr int NX = XH * XW;                // halo pixels: 720
constexpr int WGS = 4;                     // warpgroups: each owns TH / WGS output rows
constexpr int THREADS = 128 * WGS;
constexpr int RPW = TH / WGS;              // conv1_2 output rows a warpgroup: 4
constexpr int NB = 2;                      // conv1_2 output rows a round (128 registers
                                           // a thread at 512 threads: 4 rows spill)
constexpr int XPT = (NX + THREADS - 1) / THREADS;   // halo pixels a thread
constexpr int STEPS = 9 * (C / 16);        // conv1_2 k-steps: 9 taps x 4

// shared memory from a 1,024-aligned base (the swizzle atom)
constexpr int SZ_W2 = 9 * C * C * 2;                // 73,728
constexpr int OFF_W1 = SZ_W2;                       // [64 co][64 k] bf16, 8,192
constexpr int OFF_Y1 = OFF_W1 + C * 128;            // [612 positions][64] bf16, 78,336
constexpr int OFF_X = OFF_Y1 + NP * 128;            // [720 pixels][4] bf16, 5,760
constexpr int OFF_ST = OFF_X + NX * 8;              // [8 x 16 pixels][64] bf16, 16,384
constexpr int OFF_B = OFF_ST + (TH / 2) * (TW / 2) * 128;   // b1, b2 f32
constexpr int SMEM = OFF_B + 2 * C * 4 + 1024;
static_assert(OFF_Y1 % 1024 == 0 && OFF_X % 16 == 0 && OFF_ST % 16 == 0, "aligned regions");
static_assert(SMEM <= 232448, "shared memory of one CTA");
static_assert(RPW % NB == 0 && NB % 2 == 0, "rounds of whole pooled rows");

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// A conv output pair with its bias, rounded where the plain version rounds
// (conv.py: the conv's bf16 output, then a bf16 add of the bf16 bias; the
// sum of two bf16 values rounds the same in one step as through float),
// then ReLU.
__device__ __forceinline__ __nv_bfloat162 bias_relu(float a, float b, __nv_bfloat162 bias) {
  return __hmax2(__hadd2(__floats2bfloat162_rn(a, b), bias), __float2bfloat162_rn(0.f));
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

struct Grid {
  int H, W, OH, OW, tiles_x, tiles_y, tiles;
};

__device__ __forceinline__ void tile_origin(const Grid& g, int t, int& b, int& r0, int& c0) {
  const int tx = t % g.tiles_x;
  const int r = t / g.tiles_x;
  b = r / g.tiles_y;
  r0 = (r - b * g.tiles_y) * TH;
  c0 = tx * TW;
}

// The input halo of tile t (tile + 2 px each side, 0 outside the image or
// past the last tile) into registers: thread i holds pixels i + THREADS k.
__device__ __forceinline__ void halo_load(const Grid& g, const unsigned short* __restrict__ x,
                                          int t, int i0, uint32_t (&h)[XPT][2]) {
  int b = 0, r0 = 0, c0 = 0;
  if (t < g.tiles) tile_origin(g, t, b, r0, c0);
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
    const int i = i0 + k * THREADS;
    const int gr = r0 - 2 + i / XW, gc = c0 - 2 + i % XW;
    h[k][0] = h[k][1] = 0u;
    if (t < g.tiles && i < NX && gr >= 0 && gr < g.H && gc >= 0 && gc < g.W) {
      const unsigned short* p = x + (((size_t)b * g.H + gr) * g.W + gc) * 3;
      h[k][0] = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 16);
      h[k][1] = (uint32_t)__ldg(p + 2);
    }
  }
}

// ... and from registers into the staged halo (bf16, channel stride 4).
__device__ __forceinline__ void halo_store(unsigned short* s_x, int i0,
                                           const uint32_t (&h)[XPT][2]) {
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
    const int i = i0 + k * THREADS;
    if (i < NX) *reinterpret_cast<uint2*>(s_x + i * 4) = make_uint2(h[k][0], h[k][1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv1_pool_kernel(const unsigned short* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                  const Grid g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp within it
  const int g8 = lane >> 2, t4 = lane & 3;   // mma fragment row group, column pair
  const int q = lane >> 3, r8 = lane & 7;    // ldmatrix: matrix q, row r8
  unsigned char* s_y1 = smem + OFF_Y1;
  unsigned short* s_x = reinterpret_cast<unsigned short*>(smem + OFF_X);
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W1);
  unsigned char* s_st = smem + OFF_ST;
  float* s_b1 = reinterpret_cast<float*>(smem + OFF_B);
  float* s_b2 = s_b1 + C;

  // weights, once per CTA (w2 is already in the swizzled layout), and the
  // first tile's halo
  for (int i = tid; i < SZ_W2 / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(w2)[i];
  for (int i = tid; i < C * 8; i += THREADS)
    reinterpret_cast<uint4*>(s_w1)[i] = reinterpret_cast<const uint4*>(w1)[i];
  if (tid < C) {
    s_b1[tid] = b1[tid];
    s_b2[tid] = b2[tid];
  }
  uint32_t h[XPT][2];
  halo_load(g, x, blockIdx.x, tid, h);
  halo_store(s_x, tid, h);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // w1 -> wgmma's reads
  __syncthreads();

  const uint64_t w1d = b_desc(smem_u32(s_w1));   // conv1_1's B; + 2 per dy (32 bytes)
  __nv_bfloat162 b1p[8];   // conv1_1's bias for channels 8 j + 2 t4, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j)
    b1p[j] = __floats2bfloat162_rn(s_b1[8 * j + 2 * t4], s_b1[8 * j + 2 * t4 + 1]);
  // conv1_2's A: warp wq's output channels 16 wq .. + 15; ldmatrix matrix q
  // holds channels (q & 1) * 8 .., k chunk (q >> 1) of a 16-deep step, at
  // byte a_off[kc] of a tap's block
  const int a_row = 16 * wq + (q & 1) * 8 + r8;
  uint32_t a_off[4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) a_off[kc] = swz(a_row, 2 * kc + (q >> 1));

  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int b, r0, c0;
    tile_origin(g, t, b, r0, c0);
    halo_load(g, x, t + gridDim.x, tid, h);   // the next tile's halo, in flight
    const bool edge = r0 + TH > g.H || c0 + TW > g.W;   // masks needed

    // 1. conv1_1 + bias + ReLU over the tile and its ring, on wgmma: M
    //    block blk = 64 consecutive positions (row-major over YH x YW), warp
    //    wq's 16 of them gathered per lane from the staged halo as the A
    //    fragment, one m64n64k16 per kernel row dy against w1
#pragma unroll 1
    for (int blk = wg; blk < (NP + 63) / 64; blk += WGS) {
      int pos[2], base[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pos[hh] = blk * 64 + 16 * wq + g8 + hh * 8;
        const int p = pos[hh] < NP ? pos[hh] : NP - 1;
        base[hh] = ((p / YW) * XW + p % YW) * 4;
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
      wgmma_fence();
      wgmma_n64<0>(y, a[0], w1d);
      wgmma_n64<1>(y, a[1], w1d + 2);
      wgmma_n64<1>(y, a[2], w1d + 4);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) fence_reg(y[e]);
      // bias + ReLU, 0 outside the image (conv1_2's zero padding), bf16,
      // into y1 row pos (128 bytes, swizzled)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (pos[hh] >= NP) continue;
        const int gr = r0 - 1 + pos[hh] / YW, gc = c0 - 1 + pos[hh] % YW;
        const bool in = gr >= 0 && gr < g.H && gc >= 0 && gc < g.W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 v = bias_relu(y[4 * j + 2 * hh], y[4 * j + 2 * hh + 1], b1p[j]);
          *reinterpret_cast<uint32_t*>(s_y1 + swz(pos[hh], j) + 4 * t4) = in ? as_u32(v) : 0u;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // y1 -> wgmma's reads
    __syncthreads();   // y1 complete; the staged halo and the pooled tile are free

    // 2. conv1_2 on wgmma, NB output rows at a time: step s is tap s / 4,
    //    input channels (s % 4) * 16 ..; N block nb is output row RPW wg +
    //    NB half + nb, all 32 columns. The bases pass through an empty asm
    //    each round, so the compiler builds the descriptors and A addresses
    //    from them as immediates instead of hoisting them into registers.
#pragma unroll 1
    for (int half = 0; half < RPW / NB; ++half) {
      uint32_t w2b = smem_u32(smem), y1b = smem_u32(s_y1) + (RPW * wg + NB * half) * YW * 128;
      asm volatile("" : "+r"(w2b), "+r"(y1b));
      const uint64_t d0 = b_desc(y1b);
      float acc[NB][16];
      uint32_t af[2][4];
      ldsm_x4(w2b + a_off[0], af[0]);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int tap = s / 4, kc = s % 4, dy = tap / 3, dx = tap % 3;
        wgmma_fence();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
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
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 16; ++e) fence_reg(acc[nb][e]);

      // 3. epilogue: the thread holds channels 16 wq + g8 (+ 8) of columns
      //    8 j + 2 t4, + 1 of each output row: bias + ReLU (bf16 pairs),
      //    -inf outside the image, the 2x2 max, into the staged pooled
      //    tile (swizzled by pixel)
#pragma unroll
      for (int pr = 0; pr < NB / 2; ++pr) {
        const int prl = (RPW / 2) * wg + (NB / 2) * half + pr;   // pooled row in the tile
        const int orow = r0 + 2 * prl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + 8 * j + 2 * t4;
          const int pix = prl * (TW / 2) + 4 * j + t4;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int co = 16 * wq + g8 + 8 * hh;
            const __nv_bfloat162 bias = __float2bfloat162_rn(s_b2[co]);
            __nv_bfloat162 top = bias_relu(acc[2 * pr][4 * j + 2 * hh],
                                           acc[2 * pr][4 * j + 2 * hh + 1], bias);
            __nv_bfloat162 bot = bias_relu(acc[2 * pr + 1][4 * j + 2 * hh],
                                           acc[2 * pr + 1][4 * j + 2 * hh + 1], bias);
            if (edge) {   // -inf loses every max: the ceil-mode partial windows
              const __nv_bfloat16 ninf = __float2bfloat16_rn(-INFINITY);
              if (col >= g.W) top.x = bot.x = ninf;
              if (col + 1 >= g.W) top.y = bot.y = ninf;
              if (orow >= g.H) top.x = top.y = ninf;
              if (orow + 1 >= g.H) bot.x = bot.y = ninf;
            }
            const __nv_bfloat162 m = __hmax2(top, bot);
            *reinterpret_cast<__nv_bfloat16*>(s_st + swz(pix, co >> 3) + 2 * (co & 7)) =
                __hmax(m.x, m.y);
          }
        }
      }
    }
    halo_store(s_x, tid, h);   // every warp is past this tile's conv1_1
    __syncthreads();   // the pooled tile and the next halo are staged; y1 is free

    // the pooled tile to device memory, 16 bytes a thread, rows contiguous
#pragma unroll
    for (int k = 0; k < (TH / 2) * (TW / 2) * 8 / THREADS; ++k) {
      const int i = tid + k * THREADS;
      const int pix = i >> 3, c = i & 7;
      const int prow = (r0 >> 1) + pix / (TW / 2), pcol = (c0 >> 1) + pix % (TW / 2);
      if (prow < g.OH && pcol < g.OW)
        *reinterpret_cast<uint4*>(out + (((size_t)b * g.OH + prow) * g.OW + pcol) * C + 8 * c) =
            *reinterpret_cast<const uint4*>(s_st + swz(pix, c));
    }
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

}  // namespace

// x [B, H, W, 3] bf16; w1 [64 co][64 k] bf16, k = dy * 16 + dx * 4 + c (zero
// where dx or c is 3 and for k >= 48); w2 9 x [64 co][64 ci] bf16; both in
// the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7));
// b1, b2 [64] f32 (bf16-valued); out [B, ceil(H/2), ceil(W/2), 64] bf16. All
// pointers 16-byte aligned.
extern "C" int mscnn_conv1_pool(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int batch,
                                int H, int W, void* stream) {
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
  cudaError_t e = cudaFuncSetAttribute(conv1_pool_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = g.tiles < sm_count() ? g.tiles : sm_count();
  conv1_pool_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}
