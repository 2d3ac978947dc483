// Streaming top-N scan for ALS serving, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of oryx_tpu/ops/pallas_topn.py:
//
//   topn_scan + topn_merge        <- pallas_topn._topn_kernel            (B1)
//   topn_candidates + topn_merge  <- pallas_topn._topn_candidates_kernel (B2)
//
// What they compute. Queries q [b, kf] (f32; for bf16 handles already
// rounded to bf16) are scored against a feature-major item plane
// mat [kf, n_pad] (f32, bf16 or int8 codes) with f32 accumulation, then
// the aux row applies: the item norms for cosine on an unquantized
// plane, or the per-item int8 scale (cosine norms already folded in by
// the caller) on a quantized one, in exactly the order of
// pallas_topn._score_tile. Columns >= n_items never enter. Every query
// keeps its best m (value descending, ties to the lowest item id).
//
// The TPU kernel carries its running top-m across a grid that runs in
// order on one core. CTAs here run in parallel and in no order, so the
// work splits two ways:
//   - topn_scan (B1): grid = query tiles x item splits, the split count
//     chosen to fill the card. Each CTA walks its contiguous 1/splits of
//     the plane in 256-item tiles and keeps a sorted per-query top-m list
//     in shared memory across the whole walk. The gate of the TPU kernel
//     survives as a warp ballot: a score takes the insertion path only if
//     it beats the list's m-th entry (or ties it with a lower id); with a
//     randomly ordered plane almost every tile after the first few skips
//     selection entirely. Each CTA writes its list to [splits, b, m].
//   - topn_candidates (B2): grid = query tiles x fixed 16384-item blocks;
//     no state crosses blocks. Each CTA writes its block's top-m to
//     [blocks, b, m]. Both entry points launch the same range kernel and
//     differ only in the span and grid they pass.
//   - topn_merge: one CTA per query merges the sorted [S, b, m] lists into
//     [b, m] with the same tie rule (the TPU B1 merges in its own body,
//     B2 with one stable lax.top_k outside it).
//
// What bounds them on this card. Each item column is one thread; a warp
// reads 32 consecutive items of one feature row, so every load
// coalesces, and the plane is read once per query tile. A query tile
// (8 or 32 queries) sits in shared memory laid out [kf][QB] and is read
// as float4 broadcasts; the QB partial sums live in registers. At one
// query tile (b <= 32) the scan moves the plane once and is bound by
// bytes (device memory at 3.35 TB/s). At b = 256 a float32 plane is
// bound by its 2*b*kf*n f32 operations (67 TFLOP/s outside the tensor
// cores). bfloat16 and int8 planes compute a bf16 product with f32
// accumulation (int8 codes are exact in bf16; the TPU kernel runs both
// as bf16 MXU passes), whose bound is the bf16 tensor-core rate
// (989 TFLOP/s): this kernel does that work as f32 FMAs on the CUDA
// cores and stays far from it. The query tiles of one split are
// adjacent in the grid so their re-reads of the plane come from L2. The
// tensor-core form (wgmma with TMA-fed shared-memory tiles) is the
// later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA = items per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 128;  // longest list: pallas_topn.MAX_KERNEL_K
constexpr unsigned kFull = 0xffffffffu;

// scoring modes (pallas_topn._score_tile): quantized planes multiply by
// the folded per-item scale, unquantized cosine divides by norm * |q|
enum Mode { kDot = 0, kCosine = 1, kDotQuant = 2, kCosineQuant = 3 };

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ float load_item(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_item(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_item(const int8_t* p) {
  return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p)));
}

// Insert (v, id) into a warp's sorted list lv/li of length m (best
// first). Every lane holds the same (v, id). The insertion position is
// the number of entries better than the candidate; a candidate that no
// longer beats the m-th entry is dropped.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int m, float v, int id,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < kMaxM / 32; ++r) {
    const int j = lane + 32 * r;
    if (j < m && better(lv[j], li[j], v, id)) ++pos;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pos += __shfl_xor_sync(kFull, pos, o);
  if (pos >= m) return;  // warp-uniform
  float ov[kMaxM / 32];
  int oi[kMaxM / 32];
#pragma unroll
  for (int r = 0; r < kMaxM / 32; ++r) {
    const int j = lane + 32 * r;
    if (j < m && j > pos) {
      ov[r] = lv[j - 1];
      oi[r] = li[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxM / 32; ++r) {
    const int j = lane + 32 * r;
    if (j < m && j > pos) {
      lv[j] = ov[r];
      li[j] = oi[r];
    } else if (j == pos) {
      lv[j] = v;
      li[j] = id;
    }
  }
  __syncwarp();
}

// Score items [begin, end) against queries [q0, q0 + QB) and leave each
// query's top-m in out_v/out_i ([b, m] slab of this CTA's range).
template <typename T, int QB>
__device__ __forceinline__ void scan_range(const float* __restrict__ q, int b, int kf,
                                           const T* __restrict__ mat, long long n_pad,
                                           const float* __restrict__ aux, int n_items, int m,
                                           int mode, int q0, long long begin, long long end,
                                           float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kf][QB]
  float* qn_s = q_s + kf * QB;                      // [QB]
  float* sc_s = qn_s + QB;                          // [QB][kThreads]
  float* lv = sc_s + QB * kThreads;                 // [QB][m]
  int* li = reinterpret_cast<int*>(lv + QB * m);    // [QB][m]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(QB, b - q0);
  for (int e = tid; e < kf * QB; e += kThreads) {
    const int f = e / QB, r = e % QB;
    q_s[e] = r < nq ? q[(long long)(q0 + r) * kf + f] : 0.f;
  }
  for (int e = tid; e < QB * m; e += kThreads) {
    lv[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  __syncthreads();
  if (tid < QB) {
    float s = 0.f;
    for (int f = 0; f < kf; ++f) {
      const float x = q_s[f * QB + tid];
      s = fmaf(x, x, s);
    }
    qn_s[tid] = sqrtf(s);
  }
  __syncthreads();

  const bool quant = mode >= kDotQuant;
  const bool cosine = mode == kCosine || mode == kCosineQuant;
  for (long long base = begin; base < end; base += kThreads) {
    const long long col = base + tid;
    float acc[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) acc[r] = 0.f;
    if (col < end && col < n_items) {
      const T* p = mat + col;
#pragma unroll 4
      for (int f = 0; f < kf; ++f) {
        const float x = load_item(p + (long long)f * n_pad);
        const float4* w4 = reinterpret_cast<const float4*>(q_s + f * QB);
#pragma unroll
        for (int r4 = 0; r4 < QB / 4; ++r4) {
          const float4 w = w4[r4];
          acc[4 * r4 + 0] = fmaf(w.x, x, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(w.y, x, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(w.z, x, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(w.w, x, acc[4 * r4 + 3]);
        }
      }
      const float a = aux[col];
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        float s = acc[r];
        if (quant) {
          s = s * a;
          if (cosine) s = s / fmaxf(qn_s[r], 1e-12f);
        } else if (cosine) {
          s = s / fmaxf(a * qn_s[r], 1e-12f);
        }
        acc[r] = s;
      }
    }
#pragma unroll
    for (int r = 0; r < QB; ++r) sc_s[r * kThreads + tid] = acc[r];
    __syncthreads();
    // selection: warp w owns queries w, w + kWarps, ...; the ballot is the
    // gate — only scores that beat the list's current m-th entry insert
    for (int r = warp; r < nq; r += kWarps) {
      float* rv = lv + r * m;
      int* ri = li + r * m;
      for (int c = 0; c < kThreads; c += 32) {
        const long long cc = base + c + lane;
        const float v = sc_s[r * kThreads + c + lane];
        const bool hit = cc < end && cc < n_items && better(v, (int)cc, rv[m - 1], ri[m - 1]);
        unsigned pending = __ballot_sync(kFull, hit);
        while (pending) {
          const int src = __ffs(pending) - 1;
          pending &= pending - 1;
          warp_insert(rv, ri, m, __shfl_sync(kFull, v, src), __shfl_sync(kFull, (int)cc, src),
                      lane);
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nq * m; e += kThreads) {
    const int r = e / m, j = e % m;
    out_v[(long long)(q0 + r) * m + j] = lv[r * m + j];
    out_i[(long long)(q0 + r) * m + j] = li[r * m + j];
  }
}

// CTA (x, y) scans query tile x over items [y * span, (y + 1) * span) and
// writes list slab y of [grid_y, b, m]. topn_scan (B1) launches it with
// span = n_pad / splits, topn_candidates (B2) with span = one item block.
template <typename T, int QB>
__global__ void __launch_bounds__(kThreads)
    topn_range_kernel(const float* __restrict__ q, int b, int kf, const T* __restrict__ mat,
                      long long n_pad, const float* __restrict__ aux, int n_items, int m,
                      int mode, long long span, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  const long long begin = (long long)blockIdx.y * span;
  const long long end = min(begin + span, n_pad);
  const long long slab = (long long)blockIdx.y * b * m;
  scan_range<T, QB>(q, b, kf, mat, n_pad, aux, n_items, m, mode, blockIdx.x * QB, begin, end,
                    out_v + slab, out_i + slab);
}

// the better of two (value, id, list) triples; an empty slot (s < 0)
// always loses and equal entries fall to the lower list index, so every
// lane of a reduction agrees
__device__ __forceinline__ void take_better(float& v, int& i, int& s, float v2, int i2, int s2) {
  if (s2 < 0) return;
  if (s < 0 || better(v2, i2, v, i) || (!better(v, i, v2, i2) && s2 < s)) {
    v = v2;
    i = i2;
    s = s2;
  }
}

// One CTA per query row: m rounds, each taking the best head among the
// S sorted lists of [S, b, m] and advancing that list.
__global__ void __launch_bounds__(kThreads)
    topn_merge_kernel(const float* __restrict__ cv, const int* __restrict__ ci, int S, int b,
                      int m, float* __restrict__ ov, int* __restrict__ oi) {
  extern __shared__ int head[];  // [S] next unread entry of each list
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int ws[kWarps];
  __shared__ int win;
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = tid; s < S; s += kThreads) head[s] = 0;
  __syncthreads();

  float bv = -INFINITY;
  int bi = INT_MAX, bs = -1;
  auto rescan = [&]() {
    bv = -INFINITY;
    bi = INT_MAX;
    bs = -1;
    for (int s = tid; s < S; s += kThreads) {
      const int h = head[s];
      if (h < m) {
        const long long at = ((long long)s * b + row) * m + h;
        take_better(bv, bi, bs, cv[at], ci[at], s);
      }
    }
  };
  rescan();
  for (int j = 0; j < m; ++j) {
    float v = bv;
    int i = bi, s = bs;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, o);
      const int i2 = __shfl_xor_sync(kFull, i, o);
      const int s2 = __shfl_xor_sync(kFull, s, o);
      take_better(v, i, s, v2, i2, s2);
    }
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = i;
      ws[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? wv[lane] : -INFINITY;
      i = lane < kWarps ? wi[lane] : INT_MAX;
      s = lane < kWarps ? ws[lane] : -1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(kFull, v, o);
        const int i2 = __shfl_xor_sync(kFull, i, o);
        const int s2 = __shfl_xor_sync(kFull, s, o);
        take_better(v, i, s, v2, i2, s2);
      }
      if (lane == 0) {
        ov[(long long)row * m + j] = v;
        oi[(long long)row * m + j] = i;
        win = s;
      }
    }
    __syncthreads();
    const int w = win;
    if (w >= 0 && w % kThreads == tid) {
      head[w] += 1;
      rescan();
    }
    __syncthreads();
  }
}

size_t scan_smem_bytes(int qb, int kf, int m) {
  return sizeof(float) * ((size_t)kf * qb + qb + (size_t)qb * kThreads + (size_t)qb * m) +
         sizeof(int) * (size_t)qb * m;
}

template <typename T, int QB>
int launch_scan(const float* q, int b, int kf, const void* mat, long long n_pad,
                const float* aux, int n_items, int m, int mode, long long span, int grid_y,
                float* out_v, int* out_i, cudaStream_t stream) {
  auto kernel = topn_range_kernel<T, QB>;
  const size_t smem = scan_smem_bytes(QB, kf, m);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QB - 1) / QB, grid_y);
  kernel<<<grid, kThreads, smem, stream>>>(q, b, kf, static_cast<const T*>(mat), n_pad, aux,
                                           n_items, m, mode, span, out_v, out_i);
  return (int)cudaGetLastError();
}

int dispatch_scan(const float* q, int b, int kf, const void* mat, int dtype, long long n_pad,
                  const float* aux, int n_items, int m, int mode, long long span, int grid_y,
                  float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > kMaxM || b < 1 || kf < 1 || grid_y < 1) return (int)cudaErrorInvalidValue;
  const bool narrow = b <= 8;
#define ORYX_SCAN(T)                                                                          \
  return narrow ? launch_scan<T, 8>(q, b, kf, mat, n_pad, aux, n_items, m, mode, span,       \
                                    grid_y, out_v, out_i, st)                                 \
                : launch_scan<T, 32>(q, b, kf, mat, n_pad, aux, n_items, m, mode, span,      \
                                     grid_y, out_v, out_i, st)
  switch (dtype) {
    case 0:
      ORYX_SCAN(float);
    case 1:
      ORYX_SCAN(__nv_bfloat16);
    case 2:
      ORYX_SCAN(int8_t);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ORYX_SCAN
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 int8. Each returns cudaGetLastError() after its launch (0 = success).
extern "C" {

int topn_scan(const float* q, int b, int kf, const void* mat, int dtype, long long n_pad,
              const float* aux, int n_items, int m, int mode, long long span, int splits,
              float* out_v, int* out_i, void* stream) {
  return dispatch_scan(q, b, kf, mat, dtype, n_pad, aux, n_items, m, mode, span, splits, out_v,
                       out_i, stream);
}

int topn_candidates(const float* q, int b, int kf, const void* mat, int dtype, long long n_pad,
                    const float* aux, int n_items, int m, int mode, long long block,
                    int blocks, float* out_v, int* out_i, void* stream) {
  return dispatch_scan(q, b, kf, mat, dtype, n_pad, aux, n_items, m, mode, block, blocks, out_v,
                       out_i, stream);
}

int topn_merge(const float* cv, const int* ci, int lists, int b, int m, float* out_v,
               int* out_i, void* stream) {
  if (m < 1 || lists < 1 || b < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)lists;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topn_merge_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(cv, ci, lists, b,
                                                                             m, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
