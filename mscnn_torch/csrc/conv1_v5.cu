// conv1 block with a selectable MMA schedule (K3), forward: conv1_1 (3->64,
// 3x3, pad 1) + ReLU -> conv1_2 (64->64, 3x3, pad 1) + ReLU -> 2x2/2
// ceil-mode max pool. bf16 NHWC in and out.
//
// Replaces: examples/profile_conv1_v5.py::conv1_v5 (:160; body `_kernel_v5`
// :31), the Pallas TPU probe that asks whether another tap-contraction
// schedule beats the production conv1 kernel (K2). Its plain version is
// mscnn_torch/ops/kernels/conv1_v5_kernel.py::conv1_v5_plain.
//
// Modes (the probe's):
//   serial, mc -- K2's function, f32 accumulation. On the TPU the two differ
//       in how Mosaic is handed the tap dots (six [M,128]x[128,128] dots or
//       one multi-contraction dot); on Hopper both are one implicit GEMM
//       that reads conv1_2's A operand for one tap at a time straight from
//       the shifted conv1_1 tile with ldmatrix (K2's schedule), so they
//       share one instantiation.
//   flat -- the same function with conv1_2's A operand staged as an
//       explicit im2col tile: each warp copies [16 pixels, 3 taps x 64 ch]
//       (one kernel row, K = 192) into its own shared buffer and runs the
//       K loop over it, 3 chunks for K = 576. This is the K-major layout a
//       wgmma kernel would read; the chunk is sized so that 8 warps'
//       buffers (51,200 B) fit beside w2 (82,944 B) and the conv1_1 tile.
//   bf16 -- the serial schedule with a bf16 accumulator: for each kernel
//       row dy, one fresh f32 fragment per tap dx, combined per output
//       column parity into a "center" (dx 1+2 even, dx 0+1 odd) and a
//       "mixed" (dx 0 even, dx 2 odd) partial, each rounded to bf16 and
//       added to the accumulator with a bf16 rounding (acc = bf16(acc +
//       bf16(partial)), `_rn` intrinsics so nvcc cannot contract). The bias
//       follows in f32, then ReLU. Both convs.
//
// conv1_1 runs on the tensor cores in every mode, as the TPU probe runs it
// on the MXU (K2 runs it on the CUDA cores): mma.sync m16n8k16 bf16 with an
// f32 accumulator, K = 27 padded to 48 -- one 16-deep chunk per kernel row
// dy holding dx * 3 + c -- so that mode bf16 can take a row's three taps
// apart by masking A. The A fragments are gathered per lane from the
// staged input halo (bf16, channel stride 4): each lane's four k slots map
// to fixed (dx, c), so no im2col tile and no unaligned ldmatrix rows
// (a 27-wide row is not 16-byte aligned).
//
// Bound at [B, 768, 2560, 3] on an H100: compute. Per input pixel conv1_1
// is 2*27*64 = 3,456 FLOP and conv1_2 2*576*64 = 73,728, 77,184 in all:
// 152 GFLOP a 768x2560 image, 0.153 ms at 989 TFLOP/s (bf16 dense); the
// bytes (4.7 MB in, 63 MB out a image) take 0.022 ms at 3.35 TB/s. The
// design keeps both activations out of device memory (one CTA owns a
// tile_h x 2*tile_q conv1_2 tile over all 64 channels) and puts both convs
// on the tensor cores; it is mma.sync, not wgmma, with no TMA and no
// pipelining across tiles, so it stays well below the bound: a later PR's
// work, which this kernel's schedules and tiles inform.
//
// Tiles: tile_h conv1_2 output rows x tile_q pooled output columns
// (2*tile_q conv1_2 columns) per CTA, 256 threads. Compiled: every pair of
// {8, 16, 32} x {8, 16, 32} whose shared memory fits 227 KB in all modes:
// (8,8) (8,16) (8,32) (16,8) (16,16) (32,8). The probe's 32x128 does not
// fit a CTA. The default (16,16) is K2's tile: 512 conv1_2 outputs, 4
// m-tiles per warp, so each B fragment feeds 4 MMAs; smaller tiles reload
// w2 (83 KB) from L2 for fewer outputs.
//
// Edges (profile_conv1_v5.py:117-157): conv1_1 outside the image is 0
// before conv1_2; conv1_2 outside the image is -inf, so it loses every pool
// max; every pooled output has an in-image element, so the probe's final
// max(pooled, 0) changes nothing after the ReLU.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a tile or mode not
// compiled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // conv1 channels
constexpr int RS = C + 8;      // padded row stride (bf16) of [*][64] tiles
constexpr int RS1 = 56;        // row stride of the packed w1 [co][48 + 8]
constexpr int CS = 3 * C + 8;  // row stride of a flat-mode im2col chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX = 232448;
enum { SERIAL = 0, FLAT = 2, BF16 = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 bf16x8_max(uint4 a, uint4 b) {
  uint32_t* pa = reinterpret_cast<uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(pa + i),
                                     *reinterpret_cast<const __nv_bfloat162*>(pb + i));
    pa[i] = *reinterpret_cast<const uint32_t*>(&m);
  }
  return a;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one step of the bf16 accumulator: acc = bf16(acc + bf16(partial))
__device__ __forceinline__ float bf16_acc(float acc, float partial) {
  return bf16r(__fadd_rn(acc, bf16r(partial)));
}

template <int TH, int TW, int MODE>
struct Cfg {
  static constexpr int YH = TH + 2, YW = TW + 2;    // conv1_1 tile + ring
  static constexpr int XH = TH + 4, XW = TW + 4;    // input halo
  static constexpr int NP = YH * YW;                // conv1_1 positions
  static constexpr int MT = TH * TW / 16 / WARPS;   // conv1_2 m-tiles a warp
  static constexpr int SEGS = TW / 16;              // m-tiles a row
  static constexpr int SZ_W2 = 9 * C * RS * 2;
  static constexpr int SZ_Y1 = NP * RS * 2;
  static constexpr int SZ_X = XH * XW * 4 * 2;
  static constexpr int SZ_W1 = C * RS1 * 2;
  static constexpr int SZ_COL = WARPS * 16 * CS * 2;
  static constexpr int SZ_SCR = (MODE == FLAT && SZ_COL > SZ_X + SZ_W1) ? SZ_COL
                                                                        : SZ_X + SZ_W1;
  static constexpr int OFF_Y1 = SZ_W2;
  static constexpr int OFF_X = OFF_Y1 + SZ_Y1;      // x, w1; flat: im2col over them
  static constexpr int OFF_W1 = OFF_X + SZ_X;
  static constexpr int OFF_B = OFF_X + SZ_SCR;
  static constexpr int SMEM = OFF_B + 2 * C * 4;
  static_assert(TH * TW % (16 * WARPS) == 0, "whole m-tiles for every warp");
  static_assert(TW % 16 == 0 && TH % 2 == 0, "tile shape");
  static_assert(TH * TW * RS * 2 <= SZ_W2, "the output tile fits over w2");
  static_assert(SZ_X % 16 == 0 && SZ_Y1 % 16 == 0, "16-byte aligned regions");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one CTA");
};

template <int TH, int TW, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
conv1_v5_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H,
                int W, int OH, int OW) {
  using K = Cfg<TH, TW, MODE>;
  constexpr int YW = K::YW, XW = K::XW, XH = K::XH, NP = K::NP, MT = K::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_y1 = reinterpret_cast<__nv_bfloat16*>(smem + K::OFF_Y1);
  unsigned short* s_x = reinterpret_cast<unsigned short*>(smem + K::OFF_X);
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem + K::OFF_W1);
  float* s_b1 = reinterpret_cast<float*>(smem + K::OFF_B);
  float* s_b2 = s_b1 + C;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group, column pair
  const int q = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix q, row r8
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH;           // first conv1_2 output row of the tile
  const int c0 = blockIdx.x * TW;           // first conv1_2 output column (even)

  // 1. weights and the input halo (bf16, channel stride 4, 0 outside the image)
  for (int i = tid; i < 9 * C * (C / 8); i += THREADS)
    *reinterpret_cast<uint4*>(s_w2 + (i >> 3) * RS + (i & 7) * 8) =
        reinterpret_cast<const uint4*>(w2)[i];
  for (int i = tid; i < K::SZ_W1 / 16; i += THREADS)
    reinterpret_cast<uint4*>(s_w1)[i] = reinterpret_cast<const uint4*>(w1)[i];
  if (tid < C) {
    s_b1[tid] = b1[tid];
    s_b2[tid] = b2[tid];
  }
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (size_t)b * H * W * 3;
  for (int i = tid; i < XH * XW; i += THREADS) {
    const int gr = r0 - 2 + i / XW, gc = c0 - 2 + i % XW;
    uint2 v = make_uint2(0u, 0u);
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      const unsigned short* p = xb + ((size_t)gr * W + gc) * 3;
      v.x = (uint32_t)p[0] | ((uint32_t)p[1] << 16);
      v.y = (uint32_t)p[2];
    }
    *reinterpret_cast<uint2*>(s_x + i * 4) = v;
  }
  __syncthreads();

  // 2. conv1_1 + bias + ReLU over the tile and its ring, on the tensor cores.
  //    m-tile = 16 consecutive positions (row-major over YH x YW); lane
  //    slot s of its A fragment holds k = 2*t4 + (s & 1) + (s >> 1) * 8 of a
  //    dy chunk, i.e. the fixed (dx, c) = (k / 3, k % 3) for k < 9.
  {
    int koff[4], kdx[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 2 * t4 + (s & 1) + (s >> 1) * 8;
      kdx[s] = k < 9 ? k / 3 : -1;
      koff[s] = k < 9 ? (k / 3) * 4 + k % 3 : 0;
    }
    const uint32_t b_base = smem_u32(s_w1 + (r8 + (q >> 1) * 8) * RS1 + (q & 1) * 8);
    for (int m = warp; m < (NP + 15) / 16; m += WARPS) {
      int pos[2], base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pos[h] = m * 16 + g + h * 8;
        const int p = pos[h] < NP ? pos[h] : NP - 1;
        base[h] = ((p / YW) * XW + p % YW) * 4;
      }
      // a[dy][reg]: reg = (row half h = reg & 1, k half = reg >> 1)
      uint32_t a[3][4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const int h = reg & 1, s0 = (reg >> 1) * 2;
          const unsigned short* px = s_x + base[h] + dy * XW * 4;
          const uint32_t lo = kdx[s0] >= 0 ? px[koff[s0]] : 0u;
          const uint32_t hi = kdx[s0 + 1] >= 0 ? px[koff[s0 + 1]] : 0u;
          a[dy][reg] = lo | (hi << 16);
        }
      float y[8][4];
      if constexpr (MODE != BF16) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bf[4];
            ldsm_x4(b_base + jj * 16 * RS1 * 2 + dy * 32, bf);
            mma_bf16(y[2 * jj], a[dy], bf[0], bf[1]);
            mma_bf16(y[2 * jj + 1], a[dy], bf[2], bf[3]);
          }
      } else {
        bool even[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pos[h] < NP ? pos[h] : NP - 1;
          even[h] = ((c0 - 1 + p % YW) & 1) == 0;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[j][e] = 0.f;   // bf16-valued accumulator
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float f[3][8][4];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            uint32_t am[4];
#pragma unroll
            for (int reg = 0; reg < 4; ++reg) {
              const int s0 = (reg >> 1) * 2;
              am[reg] = a[dy][reg] & ((kdx[s0] == dx ? 0xFFFFu : 0u) |
                                      (kdx[s0 + 1] == dx ? 0xFFFF0000u : 0u));
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) f[dx][j][e] = 0.f;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              uint32_t bf[4];
              ldsm_x4(b_base + jj * 16 * RS1 * 2 + dy * 32, bf);
              mma_bf16(f[dx][2 * jj], am, bf[0], bf[1]);
              mma_bf16(f[dx][2 * jj + 1], am, bf[2], bf[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ev = even[e >> 1];
              const float center = ev ? __fadd_rn(f[1][j][e], f[2][j][e])
                                      : __fadd_rn(f[0][j][e], f[1][j][e]);
              const float mixed = ev ? f[0][j][e] : f[2][j][e];
              y[j][e] = bf16_acc(bf16_acc(y[j][e], center), mixed);
            }
        }
      }
      // bias + ReLU, 0 outside the image (conv1_2's zero padding), bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pos[h] >= NP) continue;
        const int yr = pos[h] / YW, yc = pos[h] % YW;
        const int gr = r0 - 1 + yr, gc = c0 - 1 + yc;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ch = j * 8 + 2 * t4;
          const float v0 = in ? fmaxf(__fadd_rn(y[j][2 * h], s_b1[ch]), 0.f) : 0.f;
          const float v1 = in ? fmaxf(__fadd_rn(y[j][2 * h + 1], s_b1[ch + 1]), 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(s_y1 + pos[h] * RS + ch) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();   // y1 complete; x and w1 are dead (flat mode reuses them)

  // 3. conv1_2 on the tensor cores. Warp w owns m-tiles w*MT .. +MT-1; m-tile
  //    i covers output row i / SEGS, columns (i % SEGS) * 16 .. +15, and all
  //    8 n-tiles of 8 channels.
  float acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // B: matrix q holds channels (q >> 1) * 8 .., k (q & 1) * 8 ..
  const uint32_t b_base = smem_u32(s_w2 + (r8 + (q >> 1) * 8) * RS + (q & 1) * 8);
  auto tile_row = [&](int i) { return (warp * MT + i) / K::SEGS; };
  auto tile_col = [&](int i) { return ((warp * MT + i) % K::SEGS) * 16; };

  if constexpr (MODE == FLAT) {
    __nv_bfloat16* col = reinterpret_cast<__nv_bfloat16*>(smem + K::OFF_X) + warp * 16 * CS;
    const uint32_t a_base = smem_u32(col + (r8 + (q & 1) * 8) * CS + (q >> 1) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int lr = tile_row(i), lc = tile_col(i);
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        __syncwarp();
        // im2col chunk: row rr = pixel (lr, lc + rr); k = dx * 64 + ci
        for (int v = lane; v < 16 * 3 * (C / 8); v += 32) {
          const int rr = v / 24, dx = (v % 24) >> 3, ck = v & 7;
          *reinterpret_cast<uint4*>(col + rr * CS + dx * C + ck * 8) =
              *reinterpret_cast<const uint4*>(
                  s_y1 + ((lr + dy) * YW + lc + rr + dx) * RS + ck * 8);
        }
        __syncwarp();
#pragma unroll
        for (int kc = 0; kc < 12; ++kc) {
          uint32_t a[4];
          ldsm_x4(a_base + kc * 32, a);
          const uint32_t b_off = (uint32_t)(((dy * 3 + kc / 4) * C * RS + (kc % 4) * 16) * 2);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bf[4];
            ldsm_x4(b_base + b_off + jj * 16 * RS * 2, bf);
            mma_bf16(acc[i][2 * jj], a, bf[0], bf[1]);
            mma_bf16(acc[i][2 * jj + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
  } else {
    uint32_t a_base[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)   // A: matrix q holds rows (q & 1) * 8 .., k (q >> 1) * 8 ..
      a_base[i] = smem_u32(s_y1 + (tile_row(i) * YW + tile_col(i) + r8 + (q & 1) * 8) * RS +
                           (q >> 1) * 8);
    if constexpr (MODE == BF16) {
      const bool even = (g & 1) == 0;   // output column c0 + tile_col + g (+8)
      // the bf16 accumulator, packed (64 registers at MT = 4, not 128)
      __nv_bfloat162 accp[MT][8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) accp[i][j][0] = accp[i][j][1] = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll 1
        for (int dy = 0; dy < 3; ++dy) {
          float f[3][8][4];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) f[dx][j][e] = 0.f;
            const int tap = dy * 3 + dx;
            const uint32_t a_off = (uint32_t)((dy * YW + dx) * RS * 2);
            const uint32_t b_off = (uint32_t)(tap * C * RS * 2);
#pragma unroll
            for (int kc = 0; kc < C / 16; ++kc) {
              uint32_t a[4];
              ldsm_x4(a_base[i] + a_off + kc * 32, a);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                uint32_t bf[4];
                ldsm_x4(b_base + b_off + jj * 16 * RS * 2 + kc * 32, bf);
                mma_bf16(f[dx][2 * jj], a, bf[0], bf[1]);
                mma_bf16(f[dx][2 * jj + 1], a, bf[2], bf[3]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v[2] = {__low2float(accp[i][j][h]), __high2float(accp[i][j][h])};
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int e = 2 * h + u;
                const float center = even ? __fadd_rn(f[1][j][e], f[2][j][e])
                                          : __fadd_rn(f[0][j][e], f[1][j][e]);
                const float mixed = even ? f[0][j][e] : f[2][j][e];
                v[u] = bf16_acc(bf16_acc(v[u], center), mixed);
              }
              accp[i][j][h] = __floats2bfloat162_rn(v[0], v[1]);   // exact: bf16 values
            }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[i][j][2 * h] = __low2float(accp[i][j][h]);
            acc[i][j][2 * h + 1] = __high2float(accp[i][j][h]);
          }
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t a_off = (uint32_t)(((tap / 3) * YW + tap % 3) * RS * 2);
        const uint32_t b_off = (uint32_t)(tap * C * RS * 2);
#pragma unroll
        for (int kc = 0; kc < C / 16; ++kc) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) ldsm_x4(a_base[i] + a_off + kc * 32, a[i]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bf[4];
            ldsm_x4(b_base + b_off + jj * 16 * RS * 2 + kc * 32, bf);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_bf16(acc[i][2 * jj], a[i], bf[0], bf[1]);
              mma_bf16(acc[i][2 * jj + 1], a[i], bf[2], bf[3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();   // every warp is done with w2 and y1

  // 4. bias + ReLU, -inf outside the image, bf16 into the output tile (over w2)
  __nv_bfloat16* o = s_w2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int lr = tile_row(i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = tile_col(i) + g + h * 8;
      const bool in = (r0 + lr) < H && (c0 + lc) < W;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = j * 8 + 2 * t4;
        const float v0 = in ? fmaxf(__fadd_rn(acc[i][j][2 * h], s_b2[ch]), 0.f) : -INFINITY;
        const float v1 =
            in ? fmaxf(__fadd_rn(acc[i][j][2 * h + 1], s_b2[ch + 1]), 0.f) : -INFINITY;
        *reinterpret_cast<__nv_bfloat162*>(o + (lr * TW + lc) * RS + ch) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  // 2x2 pool: item -> one pooled pixel, 8 of its 64 channels (16 bytes)
  for (int it = tid; it < (TH / 2) * (TW / 2) * 8; it += THREADS) {
    const int pp = it >> 3, v = it & 7;
    const int pr = pp / (TW / 2), pc = pp % (TW / 2);
    const int prow = (r0 >> 1) + pr, pcol = (c0 >> 1) + pc;
    if (prow >= OH || pcol >= OW) continue;
    const __nv_bfloat16* p00 = o + ((2 * pr) * TW + 2 * pc) * RS + v * 8;
    const uint4 m = bf16x8_max(
        bf16x8_max(*reinterpret_cast<const uint4*>(p00),
                   *reinterpret_cast<const uint4*>(p00 + RS)),
        bf16x8_max(*reinterpret_cast<const uint4*>(p00 + TW * RS),
                   *reinterpret_cast<const uint4*>(p00 + TW * RS + RS)));
    *reinterpret_cast<uint4*>(out + (((size_t)b * OH + prow) * OW + pcol) * C + v * 8) = m;
  }
}

template <int TH, int TQ, int MODE>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int batch, int H, int W, cudaStream_t stream) {
  constexpr int TW = 2 * TQ;
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const int smem = Cfg<TH, TW, MODE>::SMEM;
  auto kern = conv1_v5_kernel<TH, TW, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((OW + TQ - 1) / TQ, (OH + TH / 2 - 1) / (TH / 2), batch);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), H, W, OH, OW);
  return (int)cudaGetLastError();
}

template <int TH, int TQ>
int launch_mode(int mode, const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int batch, int H, int W, cudaStream_t s) {
  switch (mode) {
    case 0:   // serial
    case 1:   // mc: the same schedule on Hopper
      return launch<TH, TQ, SERIAL>(x, w1, b1, w2, b2, out, batch, H, W, s);
    case 2:
      return launch<TH, TQ, FLAT>(x, w1, b1, w2, b2, out, batch, H, W, s);
    case 3:
      return launch<TH, TQ, BF16>(x, w1, b1, w2, b2, out, batch, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B, H, W, 3] bf16; w1 [64][56] bf16 (co, k = dy * 16 + dx * 3 + c, zero
// padded); b1 [64] f32; w2 [3][3][64][64] bf16 (dy, dx, co, ci); b2 [64] f32;
// out [B, ceil(H/2), ceil(W/2), 64] bf16. mode: 0 serial, 1 mc, 2 flat,
// 3 bf16; (tile_h, tile_q) one of the compiled pairs.
extern "C" int mscnn_conv1_v5(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int batch, int H, int W,
                              int tile_h, int tile_q, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_TILE(th, tq)                                                              \
  if (tile_h == th && tile_q == tq)                                                  \
    return launch_mode<th, tq>(mode, x, w1, b1, w2, b2, out, batch, H, W, s);
  K3_TILE(8, 8)
  K3_TILE(8, 16)
  K3_TILE(8, 32)
  K3_TILE(16, 8)
  K3_TILE(16, 16)
  K3_TILE(32, 8)
#undef K3_TILE
  return (int)cudaErrorInvalidValue;
}
