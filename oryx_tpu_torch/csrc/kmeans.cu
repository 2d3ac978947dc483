// Fused Lloyd sweep for k-means, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of oryx_tpu/ops/pallas_kmeans.py:
//
//   kmeans_sweep + kmeans_reduce  <-  pallas_kmeans._sweep_kernel  (B3)
//
// What it computes. Points p [n_pad, d] f32 (rows >= n_items are padding)
// against centers c [kp, d] f32 (rows >= k_real are padding):
// d2 = |p|^2 - 2 p.c + |c|^2 in full f32 (the TPU kernel's
// Precision.HIGHEST), padded centers +inf, the first argmin (ties to the
// lowest center index), then over the valid rows the per-center sums of
// the assigned points, their counts, and the cost sum(max(min d2, 0)).
// A point with a NaN distance (a NaN or inf feature) adds NaN to the cost
// and goes to no center, as in the TPU kernel.
//
// The TPU kernel carries sums/counts/cost across grid steps that run in
// order on one core. CTAs here run in parallel and in no order, so the
// work splits in two, with no float atomics anywhere (results are
// identical from run to run):
//   - kmeans_sweep: each CTA owns a contiguous range of rows and reads
//     each point of it once from device memory. Per 64-point tile it
//     walks the centers in 16- or 64-center tiles through shared memory
//     (kp * d * 4 bytes reaches 256 KB at d = k = 256, more than a block
//     can hold), d in 32-feature chunks; each thread keeps a 4-point x
//     (1 or 4)-center block of f32 FMA dot products in registers (no TF32,
//     no tensor cores). The running (min, argmin) per point is folded over
//     center tiles in index order. Then the tile's valid points are added,
//     in a fixed order, into CTA-private f64 accumulators: thread (g, j)
//     owns feature column j for the points r = g, g + G, ... of the tile.
//     The G group copies live in shared memory when they fit (small k*d),
//     else G = 1 and the CTA's own slab of the partials output is the
//     accumulator. Counts (int) and cost (f64) ride along on column 0.
//     Each CTA writes partial sums [num_ctas, kp, d] f64, counts
//     [num_ctas, kp] int32 and cost [num_ctas] f64.
//   - kmeans_reduce: one thread per output element sums the partials over
//     the CTA axis in CTA order, and rounds to f32: sums [kp, d], counts
//     [kp], cost [1].
//
// What bounds it on this card. Least time = max(bytes, operations):
// (n*d + 2*kp*d + kp + 1) * 4 bytes over 3.35 TB/s against
// 2*n*kp*d + n*d f32 operations over 67 TFLOP/s. At d = 20, k = 10
// (kp = 16) a point carries 80 bytes and ~660 operations, so the sweep
// is bound by bytes (10M points: ~0.24 ms); at d = k = 256 a point carries
// 1 KB and ~131K operations, so it is bound by f32 operations (1M points:
// ~2.0 ms). The design reads every point once, coalesced, and keeps
// nothing per point in device memory (no [n, k] distance matrix, no
// assignment vector); at small k the 16-center tile keeps the FMA count
// near the real 2*kp*d. The f64 accumulators keep the per-CTA sums of
// millions of points within f32 rounding of the exact sum. What it does
// not do yet: tensor cores (the f32 function has no exact tensor-core
// form; 3xTF32 splitting would be the route), TMA, and at large k*d the
// per-point read-modify-write of the global slab is a latency chain.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid for the distance tile
constexpr int kTP = 64;        // points per tile: 16 point rows x 4
constexpr int kTD = 32;        // features per shared-memory chunk
constexpr int kPad = kTD + 1;  // row stride in shared memory (no bank conflicts)
constexpr unsigned kFull = 0xffffffffu;

// (v, i) ranks before (w, j): a NaN distance first, then the smaller
// distance, then the lower center. A point with a NaN distance to any real
// center ends with a NaN minimum and is summed into no center, as in the
// TPU kernel, whose equality argmin against a NaN minimum matches nothing.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  if (isnan(v) || isnan(w)) return isnan(v) && !isnan(w);
  return v < w || (v == w && i < j);
}

// Shared memory layout (dynamic), in bytes, 8-aligned sections first:
//   acc    groups * kp * d  f64  (only when groups > 0)
//   cost   kThreads         f64  (per-group cost, group order)
//   ps     kTP * kPad       f32
//   cs     TC * kPad        f32
//   pn     kTP              f32
//   cn     TC               f32
//   bestd  kTP              f32
//   besti  kTP              i32
//   cnt    G * kp           i32
size_t sweep_smem_bytes(int tc, int kp, int d, int groups) {
  const int g = groups > 0 ? groups : 1;
  size_t b = sizeof(double) * ((size_t)(groups > 0 ? groups : 0) * kp * d + kThreads);
  b += sizeof(float) * ((size_t)kTP * kPad + (size_t)tc * kPad + kTP + tc + kTP);
  b += sizeof(int) * ((size_t)kTP + (size_t)g * kp);
  return b;
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ pts, long long n_pad, int d,
                 const float* __restrict__ ctr, int kp, int k_real, long long n_items,
                 long long rows_per_cta, int groups, double* __restrict__ part_sums,
                 int* __restrict__ part_counts, double* __restrict__ part_cost) {
  constexpr int TC = 16 * CPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = groups > 0 ? groups : 1;
  double* acc_s = reinterpret_cast<double*>(smem_raw);
  double* cost_s = acc_s + (size_t)(groups > 0 ? groups : 0) * kp * d;
  float* ps = reinterpret_cast<float*>(cost_s + kThreads);
  float* cs = ps + kTP * kPad;
  float* pn = cs + TC * kPad;
  float* cn = pn + kTP;
  float* bestd = cn + TC;
  int* besti = reinterpret_cast<int*>(bestd + kTP);
  int* cnt = besti + kTP;

  const int tid = threadIdx.x;
  const int tp = tid / 16;  // point row of the distance tile
  const int tc = tid % 16;  // center column of the distance tile
  const long long kpd = (long long)kp * d;
  double* slab = part_sums + (long long)blockIdx.x * kpd;
  double* acc = groups > 0 ? acc_s : slab;  // generic pointer: shared or global

  const long long row0 = (long long)blockIdx.x * rows_per_cta;
  const long long row_end = row0 + rows_per_cta < n_pad ? row0 + rows_per_cta : n_pad;
  const long long valid_end = row_end < n_items ? row_end : n_items;

  // the sums phase: thread (g, j0) adds column j0 (+ dw, ...) of points
  // r = g, g + G, ... of each tile
  const int dw = d < kThreads ? d : kThreads;
  const int g = tid / dw;
  const int j0 = tid % dw;
  const bool summer = g < G;

  for (long long e = tid; e < (long long)G * kpd; e += kThreads) acc[e] = 0.0;
  for (int e = tid; e < G * kp; e += kThreads) cnt[e] = 0;
  double cost = 0.0;  // owned by the column-0 thread of each group
  __syncthreads();

  for (long long t0 = row0; t0 < row_end; t0 += kTP) {
    if (tid < kTP) {
      bestd[tid] = INFINITY;
      besti[tid] = INT_MAX;
    }
    for (int c0 = 0; c0 < kp; c0 += TC) {
      float dot[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) dot[i][jj] = 0.f;
      float pn_acc = 0.f, cn_acc = 0.f;
      for (int f0 = 0; f0 < d; f0 += kTD) {
        const int w = d - f0 < kTD ? d - f0 : kTD;
        __syncthreads();  // the previous chunk's readers are done
        for (int e = tid; e < kTP * w; e += kThreads) {
          const int r = e / w, f = e % w;
          const long long row = t0 + r;
          ps[r * kPad + f] = row < row_end ? __ldg(pts + row * d + f0 + f) : 0.f;
        }
        for (int e = tid; e < TC * w; e += kThreads) {
          const int r = e / w, f = e % w;
          const int c = c0 + r;
          cs[r * kPad + f] = c < kp ? __ldg(ctr + (long long)c * d + f0 + f) : 0.f;
        }
        __syncthreads();
        if (c0 == 0 && tid < kTP) {
          for (int f = 0; f < w; ++f) {
            const float v = ps[tid * kPad + f];
            pn_acc = fmaf(v, v, pn_acc);
          }
        }
        if (tid < TC) {
          for (int f = 0; f < w; ++f) {
            const float v = cs[tid * kPad + f];
            cn_acc = fmaf(v, v, cn_acc);
          }
        }
#pragma unroll 4
        for (int f = 0; f < w; ++f) {
          float a[4], b[CPT];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = ps[(tp + 16 * i) * kPad + f];
#pragma unroll
          for (int jj = 0; jj < CPT; ++jj) b[jj] = cs[(tc + 16 * jj) * kPad + f];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < CPT; ++jj) dot[i][jj] = fmaf(a[i], b[jj], dot[i][jj]);
        }
      }
      if (c0 == 0 && tid < kTP) pn[tid] = pn_acc;
      if (tid < TC) cn[tid] = cn_acc;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tp + 16 * i;
        float bd = INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          const int c = c0 + tc + 16 * jj;
          float d2 = pn[p] - 2.f * dot[i][jj] + cn[tc + 16 * jj];
          if (c >= k_real) d2 = INFINITY;  // padded centers lose
          if (c < kp && better(d2, c, bd, bi)) {
            bd = d2;
            bi = c;
          }
        }
        // the 16 lanes of this point row hold the other centers of the tile
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          const float v2 = __shfl_xor_sync(kFull, bd, o);
          const int i2 = __shfl_xor_sync(kFull, bi, o);
          if (better(v2, i2, bd, bi)) {
            bd = v2;
            bi = i2;
          }
        }
        if (tc == 0 && better(bd, bi, bestd[p], besti[p])) {
          bestd[p] = bd;
          besti[p] = bi;
        }
      }
    }
    __syncthreads();  // bestd/besti final for the tile
    if (summer) {
      for (int r = g; r < kTP; r += G) {
        const long long row = t0 + r;
        if (row >= valid_end) break;
        const float m = bestd[r];
        // max(m, 0) that keeps a NaN, as the TPU kernel's cost does
        if (j0 == 0) cost += (double)(m < 0.f ? 0.f : m);
        if (isnan(m)) continue;  // no center (see better())
        const int a = besti[r];
        const float* x = pts + row * d;
        double* dst = acc + ((long long)g * kp + a) * d;
        for (int j = j0; j < d; j += dw) dst[j] += (double)__ldg(x + j);
        if (j0 == 0) cnt[g * kp + a] += 1;
      }
    }
    __syncthreads();  // the next tile resets bestd/besti
  }

  if (summer && j0 == 0) cost_s[g] = cost;
  __syncthreads();
  if (groups > 0) {
    for (long long e = tid; e < kpd; e += kThreads) {
      double s = 0.0;
      for (int h = 0; h < G; ++h) s += acc_s[(long long)h * kpd + e];
      slab[e] = s;
    }
  }
  for (int c = tid; c < kp; c += kThreads) {
    int s = 0;
    for (int h = 0; h < G; ++h) s += cnt[h * kp + c];
    part_counts[(long long)blockIdx.x * kp + c] = s;
  }
  if (tid == 0) {
    double s = 0.0;
    for (int h = 0; h < G; ++h) s += cost_s[h];
    part_cost[blockIdx.x] = s;
  }
}

__global__ void reduce_kernel(const double* __restrict__ part_sums,
                              const int* __restrict__ part_counts,
                              const double* __restrict__ part_cost, int num_ctas, int kp, int d,
                              float* __restrict__ sums, float* __restrict__ counts,
                              float* __restrict__ cost) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kpd = (long long)kp * d;
  if (e < kpd) {
    double s = 0.0;
#pragma unroll 8
    for (int b = 0; b < num_ctas; ++b) s += part_sums[(long long)b * kpd + e];
    sums[e] = (float)s;
  } else if (e < kpd + kp) {
    const int c = (int)(e - kpd);
    long long s = 0;
#pragma unroll 8
    for (int b = 0; b < num_ctas; ++b) s += part_counts[(long long)b * kp + c];
    counts[c] = (float)s;
  } else if (e == kpd + kp) {
    double s = 0.0;
    for (int b = 0; b < num_ctas; ++b) s += part_cost[b];
    cost[0] = (float)s;
  }
}

template <int CPT>
int launch_sweep(const float* pts, long long n_pad, int d, const float* ctr, int kp, int k_real,
                 long long n_items, int num_ctas, long long rows_per_cta, int groups,
                 double* part_sums, int* part_counts, double* part_cost, cudaStream_t stream) {
  auto kernel = sweep_kernel<CPT>;
  const size_t smem = sweep_smem_bytes(16 * CPT, kp, d, groups);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_ctas, kThreads, smem, stream>>>(pts, n_pad, d, ctr, kp, k_real, n_items,
                                               rows_per_cta, groups, part_sums, part_counts,
                                               part_cost);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch function returns
// cudaGetLastError() after its launch (0 = success).
extern "C" {

// Bytes of dynamic shared memory kmeans_sweep asks for; the wrapper picks
// `groups` so that this stays within the card's per-block limit.
long long kmeans_sweep_smem_bytes(int kp, int d, int groups) {
  return (long long)sweep_smem_bytes(kp <= 16 ? 16 : 64, kp, d, groups);
}

// groups > 0: that many accumulator copies in shared memory (groups *
// min(d, 256) <= 256); groups == 0: accumulate in the partials slab.
// rows_per_cta must be a multiple of 64.
int kmeans_sweep(const float* pts, long long n_pad, int d, const float* ctr, int kp, int k_real,
                 long long n_items, int num_ctas, long long rows_per_cta, int groups,
                 double* part_sums, int* part_counts, double* part_cost, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dw = d < kThreads ? d : kThreads;
  if (d < 1 || kp < 1 || k_real < 1 || k_real > kp || num_ctas < 1 || rows_per_cta < 1 ||
      rows_per_cta % kTP || groups < 0 || groups * dw > kThreads)
    return (int)cudaErrorInvalidValue;
  if (kp <= 16)
    return launch_sweep<1>(pts, n_pad, d, ctr, kp, k_real, n_items, num_ctas, rows_per_cta,
                           groups, part_sums, part_counts, part_cost, st);
  return launch_sweep<4>(pts, n_pad, d, ctr, kp, k_real, n_items, num_ctas, rows_per_cta,
                         groups, part_sums, part_counts, part_cost, st);
}

int kmeans_reduce(const double* part_sums, const int* part_counts, const double* part_cost,
                  int num_ctas, int kp, int d, float* sums, float* counts, float* cost,
                  void* stream) {
  if (num_ctas < 1 || kp < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)kp * d + kp + 1;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part_sums, part_counts, part_cost, num_ctas, kp, d, sums, counts, cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
