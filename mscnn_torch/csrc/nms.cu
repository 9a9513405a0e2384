// Batched greedy NMS (select-and-suppress) as a sorted-order scan, one CTA
// per independent problem.
//
// Replaces: mscnn_tpu/ops/pallas/nms_kernel.py:98 `nms_pallas` (body
// `_kernel`), the Pallas TPU kernel behind every NMS of the deploy graph.
// Contract: mscnn_tpu/ops/nms.py::nms_xywh -- for min(max_out, N) steps,
// select the live box of highest score (lowest index on ties), emit it, and
// kill every box whose IoU with it exceeds the threshold; a box is live when
// it is valid and its score is > NEG_INF / 2; the slots after the last
// selection are zero.
//
// The same function as a scan: order the live boxes by (score descending,
// index ascending) and walk that order, keeping a box if no earlier kept box
// suppresses it. The greedy step's arg-max (lowest index on ties) is then
// always the first box in the order that is neither kept nor suppressed:
// every box before it was kept or killed earlier, and suppression only
// removes boxes. The selected box is the row of each IoU (iofu divides by
// its area, so the relation is not symmetric).
//
// What bounds it on an H100: latency, not bytes or operations. A problem is
// small (N = 2000 boxes is 40 KB) but greedy NMS is a chain: whether a box
// is kept depends on every box kept before it. A select-and-suppress step
// computes one IoU per live box, max_out times (256 x 2000 for propose),
// though the scan reaches only the first few hundred boxes of the order
// before it has max_out of them. Design (one kernel, one 1024-thread CTA
// per problem, all problems of a call in one launch):
//   1. keys (score, index) -> a 64-bit key that sorts ascending in the scan
//      order (non-live boxes and the padding to a power of two last), then
//      a bitonic sort of the keys in shared memory, skipped when the keys
//      are in order already -- propose's input comes sorted from
//      topk_candidates, postprocess's per-class input does not;
//   2. the boxes and scores gathered into scan order in shared memory;
//   3. the scan, 32 positions a round, two __syncthreads a round: the CTA
//      computes in parallel the IoU of every (kept box, chunk box) pair and
//      of every (chunk box j, chunk box i > j) pair, and sets bits for those
//      above the threshold (shared atomics); then one warp resolves the
//      chunk in order in registers -- box j is kept if no earlier kept box
//      and no kept chunk box before it suppresses it -- and appends the kept
//      ones to the output. Only boxes up to the last kept one are ever
//      tested, each against the boxes kept before it.
// The scan stops at min(max_out, N) kept boxes or when no live box is left,
// and zero-fills the remaining output rows.
//
// Exactness: the IoU is computed with the same rounded operations, in the
// same order, as the plain PyTorch version (ops/boxes.py::iou_xywh); the
// __f*_rn intrinsics keep nvcc from contracting them into FMAs. The score
// key maps -0.0 to +0.0, so equal scores tie as they do under arg-max.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success; cudaErrorInvalidValue for N > 4096 or a bad mode.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 4096;
constexpr int THREADS = 1024;
constexpr float kLive = -5e29f;   // ops/nms.py: live when score > NEG_INF / 2

// IoU of the selected box a against candidate b; MODE 0 iou (union),
// 1 iomu (min area), 2 iofu (the selected box's own area).
template <int MODE>
__device__ __forceinline__ float iou_row(float4 a, float area_a, float4 b) {
  const float tlx = fmaxf(a.x, b.x);
  const float tly = fmaxf(a.y, b.y);
  const float brx = fminf(__fadd_rn(a.x, a.z), __fadd_rn(b.x, b.z));
  const float bry = fminf(__fadd_rn(a.y, a.w), __fadd_rn(b.y, b.w));
  const float over = __fmul_rn(fmaxf(__fsub_rn(brx, tlx), 0.f),
                               fmaxf(__fsub_rn(bry, tly), 0.f));
  const float area_b = __fmul_rn(b.z, b.w);
  float denom;
  if (MODE == 1) {
    denom = fminf(area_a, area_b);
  } else if (MODE == 2) {
    denom = area_a;
  } else {
    denom = __fsub_rn(__fadd_rn(area_a, area_b), over);
  }
  const bool ok = a.z > 0.f && a.w > 0.f && b.z > 0.f && b.w > 0.f && denom > 0.f;
  return ok ? __fdiv_rn(over, denom) : 0.f;
}

// Ascending key = scan order: live scores descending, then index ascending.
__device__ __forceinline__ unsigned long long sort_key(float s, bool live, int i) {
  uint32_t hi = 0xffffffffu;
  if (live) {
    const uint32_t bits = __float_as_uint(s == 0.f ? 0.f : s);
    const uint32_t up = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);   // ascending
    hi = ~up;
  }
  return ((unsigned long long)hi << 32) | (uint32_t)i;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const uint8_t* __restrict__ valid, float4* __restrict__ out_boxes,
           float* __restrict__ out_scores, uint8_t* __restrict__ out_valid, int n,
           int n_pad, int max_out, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);   // [n_pad]
  float4* sb = reinterpret_cast<float4*>(keys + n_pad);                     // [n] sorted boxes
  float* ss = reinterpret_cast<float*>(sb + n);                             // [n] sorted scores
  int* kpos = reinterpret_cast<int*>(ss + n);                               // [n] kept positions
  __shared__ uint32_t s_rows[32];   // chunk box j suppresses chunk boxes (bits)
  __shared__ uint32_t s_supp;       // chunk boxes suppressed by an earlier kept box
  __shared__ int s_live, s_kept;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t p = blockIdx.x;
  boxes += p * n;
  scores += p * n;
  valid += p * n;
  out_boxes += p * max_out;
  out_scores += p * max_out;
  out_valid += p * max_out;

  // 1. keys and the bitonic sort
  if (tid == 0) {
    s_live = s_kept = 0;
    s_supp = 0u;
  }
  if (tid < 32) s_rows[tid] = 0u;
  __syncthreads();
  int live_here = 0;
  for (int i = tid; i < n_pad; i += THREADS) {
    unsigned long long k = ~0ull;
    if (i < n) {
      const float s = scores[i];
      const bool live = valid[i] && s > kLive;
      live_here += live;
      k = sort_key(s, live, i);
    }
    keys[i] = k;
  }
  if (live_here) atomicAdd(&s_live, live_here);
  __syncthreads();
  bool in_order = true;   // propose's candidates come sorted: no sort needed
  for (int i = tid; i + 1 < n_pad; i += THREADS) in_order &= keys[i] <= keys[i + 1];
  if (!__syncthreads_and(in_order)) for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_pad; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // 2. boxes and scores in scan order
  const int n_live = s_live;
  for (int i = tid; i < n_live; i += THREADS) {
    const int src = (int)(uint32_t)keys[i];
    sb[i] = boxes[src];
    ss[i] = scores[src];
  }
  __syncthreads();

  // 3. the scan, 32 positions a round
  const int steps = min(max_out, n);
  int nk = 0;
  for (int c0 = 0; c0 < n_live && nk < steps; c0 += 32) {
    const int nc = min(32, n_live - c0);
    // every (earlier kept box, chunk box) and (chunk box j, chunk box i > j)
    // pair, spread over the CTA; the earlier box is the IoU's row
    const int pairs = (nk + nc) * 32;
    for (int q = tid; q < pairs; q += THREADS) {
      const int r = q >> 5, i = q & 31;
      if (i >= nc) continue;
      const bool from_kept = r < nk;
      const int row = from_kept ? kpos[r] : c0 + (r - nk);
      if (!from_kept && row >= c0 + i) continue;
      const float4 a = sb[row];
      if (iou_row<MODE>(a, __fmul_rn(a.z, a.w), sb[c0 + i]) > thr)
        atomicOr(from_kept ? &s_supp : &s_rows[r - nk], 1u << i);
    }
    __syncthreads();
    if (warp == 0) {   // resolve the chunk in order, in registers
      const uint32_t rowbits = s_rows[lane];
      uint32_t alive = ~s_supp & (nc == 32 ? 0xffffffffu : ((1u << nc) - 1u));
      uint32_t kept = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t rj = __shfl_sync(0xffffffffu, rowbits, j);
        if ((alive >> j) & 1u) {
          kept |= 1u << j;
          alive &= ~rj;
        }
      }
      const int rank = nk + __popc(kept & ((1u << lane) - 1u));
      if (((kept >> lane) & 1u) && rank < steps) {
        kpos[rank] = c0 + lane;
        out_boxes[rank] = sb[c0 + lane];
        out_scores[rank] = ss[c0 + lane];
        out_valid[rank] = 1;
      }
      s_rows[lane] = 0u;
      if (lane == 0) {
        s_supp = 0u;
        s_kept = min(steps, nk + __popc(kept));
      }
    }
    __syncthreads();
    nk = s_kept;
  }
  for (int r = nk + tid; r < max_out; r += THREADS) {
    out_boxes[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    out_scores[r] = 0.f;
    out_valid[r] = 0;
  }
}

template <int MODE>
cudaError_t launch(const void* boxes, const void* scores, const void* valid,
                   void* out_boxes, void* out_scores, void* out_valid, int problems,
                   int n, int max_out, float thr, cudaStream_t stream) {
  int n_pad = 32;
  while (n_pad < n) n_pad <<= 1;
  const size_t smem = 8 * (size_t)n_pad + 24 * (size_t)n;
  static bool ready[64] = {};   // per device: the attribute holds for every N
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(nms_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             32 * MAX_N);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) ready[dev] = true;
  }
  nms_kernel<MODE><<<problems, THREADS, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<float4*>(out_boxes),
      static_cast<float*>(out_scores), static_cast<uint8_t*>(out_valid), n, n_pad,
      max_out, thr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mscnn_nms_xywh(const void* boxes, const void* scores,
                              const void* valid, void* out_boxes,
                              void* out_scores, void* out_valid, int problems,
                              int n, int max_out, float thr, int mode,
                              void* stream) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return (int)launch<0>(boxes, scores, valid, out_boxes, out_scores,
                            out_valid, problems, n, max_out, thr, st);
    case 1:
      return (int)launch<1>(boxes, scores, valid, out_boxes, out_scores,
                            out_valid, problems, n, max_out, thr, st);
    case 2:
      return (int)launch<2>(boxes, scores, valid, out_boxes, out_scores,
                            out_valid, problems, n, max_out, thr, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
