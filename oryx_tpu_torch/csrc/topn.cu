// Streaming top-N scan for ALS serving, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of oryx_tpu/ops/pallas_topn.py:
//
//   topn_scan + topn_merge        <- pallas_topn._topn_kernel            (B1)
//   topn_candidates + topn_merge  <- pallas_topn._topn_candidates_kernel (B2)
//
// What they compute. Queries q [b, kf] (f32; a bf16 plane scores them
// rounded to bf16, norm included) are scored against a feature-major item plane
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
//     the plane and keeps a sorted per-query top-m list in shared memory
//     across the whole walk. Each CTA writes its list to [splits, b, m].
//   - topn_candidates (B2): grid = query tiles x fixed 16384-item blocks;
//     no state crosses blocks. Each CTA writes its block's top-m to
//     [blocks, b, m]. Both entry points launch the same range kernel and
//     differ only in the span and grid they pass.
//   - topn_merge: one CTA per query merges the sorted [S, b, m] lists into
//     [b, m] with the same tie rule (the TPU B1 merges in its own body,
//     B2 with one stable lax.top_k outside it).
//
// Two range kernels, chosen by the plane's type (dispatch_scan):
//
// float32 planes: the CUDA-core scan (topn_range_kernel). Each item
// column is one thread, a warp reads 32 consecutive items of one feature
// row, and the query tile (8 or 32 queries) sits in shared memory as
// float4 broadcasts. At b <= 32 it is bound by the plane's bytes
// (3.35 TB/s); at b = 256 by its 2*b*kf*n f32 operations (67 TFLOP/s
// outside the tensor cores). float32 has no exact one-pass tensor-core
// form, so these planes stay on the CUDA cores.
//
// bfloat16 and int8 planes: the tensor-core scan (topn_tc_kernel). The
// function is a bf16 product with f32 accumulation (int8 codes are exact
// in bf16; the TPU kernel runs both as bf16 MXU passes), bound by the
// bf16 tensor-core rate, 989 TFLOP/s. What bounds it on this card, and
// what the design does about it:
//   - at b = 8 the plane's bytes: 250 features x 1M items of int8 take
//     0.077 ms at 3.35 TB/s against 0.004 ms of tensor-core work. The
//     plane streams through a ring of shared-memory stages fed by TMA
//     (cp.async.bulk.tensor, 64 features x 128 bytes of items per box,
//     128-byte swizzle), one producer warp keeping loads in flight; the
//     CTAs of one query tile read disjoint ranges, so every byte of the
//     plane is read once per query tile.
//   - at b = 256 the operations: 2*b*kf*n on the tensor cores. wgmma
//     takes a fixed M of 64 and the main path's batches are small, so A
//     and B are swapped: the item axis is M (S^T = mat^T q^T), N is the
//     query tile (8, 16, 32, 64 or 128, one template each) and K
//     steps by 16 features. Two consumer warpgroups each own 64 items of
//     a 128-item CTA tile. There is no N = 256: its staged products and
//     candidate buffers alone pass an SM's shared memory.
//   - A (items x features) is built in registers (wgmma with A from
//     registers), not handed to wgmma as a shared-memory descriptor.
//     The plane arrives item-major per feature row, and ldmatrix.trans
//     turns it into the A fragment directly. For int8 this is the point:
//     the codes convert to bf16 in registers (exact, by a float
//     magic-number trick with no conversion instruction), so no bf16
//     copy of the stage is ever written to shared memory, and each code
//     is read from shared memory once. ldmatrix.trans moves 16-bit
//     units, so an int8 warp tile maps accumulator row g to item 2g and
//     row g + 8 to item 2g + 1; bf16 keeps rows and items in order. One
//     path serves both types and the epilogue owns the item mapping.
//   - B (queries x features) is resident in shared memory for the whole
//     walk, K-major in 8 x 16-byte core matrices, zero-padded to N rows
//     and to a 64-feature multiple (the TMA box past the plane's last
//     feature reads zeros), so that every stage runs four k16 steps with
//     no branch around a wgmma. An int8 plane scores the f32 query
//     exactly: the CTA splits it into three bf16 pieces (hi + mid + lo
//     == q, split_query) as it stages B, and each K step issues three
//     wgmmas on the same A fragment, one per piece, into one accumulator.
//     So int8 does three times the tensor-core work of its bound (which
//     counts one bf16 pass) and reaches at most a third of it when bound
//     by operations. A bf16 plane scores the query rounded to bf16 (hi,
//     and the cosine norm of hi): one wgmma.
//   - Selection. The tile's products are staged in shared memory; warp w
//     takes queries w, w + 8, ..., applies aux and the mask, and appends
//     the scores that beat the query's threshold to its candidate buffer
//     (ranked by ballot, no atomics). A full buffer is sorted by a warp
//     bitonic network and cut to its best m, and the m-th becomes the
//     threshold, which only rises: the result does not depend on the
//     order of arrival, and ties go to the lowest id as everywhere else.
//     This, not the tensor cores, is what holds the kernel back at
//     b >= 16: with one or two CTAs of nine warps per SM the per-query chains of
//     shared-memory loads, ballots and compactions stay exposed. The
//     per-tile code is kept short (the sort is one out-of-line copy, the
//     MMA warps only stage raw products), since it runs from the
//     instruction cache on every tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // CUDA-core scan: threads per CTA = items per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 128;  // longest list: pallas_topn.MAX_KERNEL_K
constexpr unsigned kFull = 0xffffffffu;

// scoring modes (pallas_topn._score_tile): quantized planes multiply by
// the folded per-item scale, unquantized cosine divides by norm * |q|
enum Mode { kDot = 0, kCosine = 1, kDotQuant = 2, kCosineQuant = 3 };

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
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

// -- float32 planes: the CUDA-core scan ----------------------------------------

// Score items [begin, end) against queries [q0, q0 + QB) and leave each
// query's top-m in out_v/out_i ([b, m] slab of this CTA's range).
template <int QB>
__device__ __forceinline__ void scan_range(const float* __restrict__ q, int b, int kf,
                                           const float* __restrict__ mat, long long n_pad,
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
      const float* p = mat + col;
#pragma unroll 4
      for (int f = 0; f < kf; ++f) {
        const float x = __ldg(p + (long long)f * n_pad);
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
template <int QB>
__global__ void __launch_bounds__(kThreads)
    topn_range_kernel(const float* __restrict__ q, int b, int kf, const float* __restrict__ mat,
                      long long n_pad, const float* __restrict__ aux, int n_items, int m,
                      int mode, long long span, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  const long long begin = (long long)blockIdx.y * span;
  const long long end = min(begin + span, n_pad);
  const long long slab = (long long)blockIdx.y * b * m;
  scan_range<QB>(q, b, kf, mat, n_pad, aux, n_items, m, mode, blockIdx.x * QB, begin, end,
                 out_v + slab, out_i + slab);
}

// -- bfloat16 and int8 planes: the tensor-core scan ----------------------------

constexpr int kTcItems = 128;                  // items per CTA tile (2 warpgroups x wgmma M)
constexpr int kTcChunk = 64;                   // features per ring stage (4 k16 steps)
constexpr int kTcConsumers = 256;              // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kTcMaxStages = 6;
constexpr int kTcMinStages = 3;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr int kBarSelect = 1;       // named barrier of the consumer threads
constexpr int kScStride = kTcItems + 8;  // staged products per query row, padded

// Byte offsets of the tensor-core kernel's shared memory, from a
// 1024-aligned base (the 128-byte swizzle repeats every 1024 bytes).
struct TcLayout {
  int stages;
  int stage_bytes;
  int a, bq, sc, aux, bv, bi, tv, ti, cnt, qn, bars;
  int total;  // including the alignment slack
};

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Candidate slots per query: a power of two >= 2m and >= m + 32, so that
// a compacted buffer keeps m entries and has room for a chunk of 32.
__host__ __device__ inline int tc_slots(int m) {
  int slots = 32;
  while (slots < 2 * m || slots < m + 32) slots <<= 1;
  return slots;
}

__host__ __device__ inline TcLayout tc_layout(int n, int kfp, bool int8, int m, int stages) {
  TcLayout L;
  L.stages = stages;
  L.stage_bytes = kTcChunk * kTcItems * (int8 ? 1 : 2);
  L.a = 0;
  L.bq = stages * L.stage_bytes;
  L.sc = L.bq + (int8 ? 3 : 1) * n * kfp * 2;
  L.aux = L.sc + n * kScStride * 4;
  L.bv = L.aux + kTcItems * 4;
  L.bi = L.bv + n * tc_slots(m) * 4;
  L.tv = L.bi + n * tc_slots(m) * 4;
  L.ti = L.tv + n * 4;
  L.cnt = L.ti + n * 4;
  L.qn = L.cnt + n * 4;
  L.bars = align_up(L.qn + n * 4, 8);
  L.total = L.bars + 2 * stages * 8 + 1024;
  return L;
}

// The query tile and ring depth for b queries: the widest N bucket not
// above b's (powers of two from 8 to 128) whose resident query pieces,
// staged scores, candidate buffers and at least kTcMinStages stages fit;
// N = 8 may run on two. n = 0 when nothing fits.
struct TcPlan {
  int n;
  TcLayout layout;
};

inline TcPlan tc_plan(int b, int kf, int m, bool int8) {
  const int kfp = align_up(kf, kTcChunk);
  int n = 8;
  while (n < b && n < 128) n <<= 1;
  for (; n >= 8; n >>= 1) {
    const TcLayout fixed = tc_layout(n, kfp, int8, m, 0);
    const int stages = min(kTcMaxStages, (kSmemLimit - fixed.total) /
                                             (fixed.stage_bytes + 16));
    if (stages >= kTcMinStages || (n == 8 && stages >= 2))
      return {n, tc_layout(n, kfp, int8, m, stages)};
  }
  return {0, tc_layout(8, kfp, int8, m, 0)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one TMA box of the plane: items [x, x + box) of feature rows [f, f + 64)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int f) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(f)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Descriptor of a K-major B operand without swizzle: core matrices of
// 8 rows x 16 bytes stored as 128 contiguous bytes, the two K halves of
// a k16 step 128 bytes apart (leading offset), successive 8-row groups
// 256 bytes apart (stride offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// D[64 x N] += A[64 x 16] (registers, bf16) * B[16 x N] (shared memory, bf16)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Four int8 codes from ldmatrix.trans on 16-bit units: bytes (f, 2g),
// (f, 2g + 1), (f + 1, 2g), (f + 1, 2g + 1) as (feature, item). Returns
// the bf16 pairs (f, f + 1) of item 2g in `even` and of item 2g + 1 in
// `odd`. 0x4B0000uu is the float 2^23 + uu, so with uu = code + 128
// subtracting 2^23 + 128 leaves the code exactly; its bf16 is the
// float's high half.
__device__ __forceinline__ void codes_to_bf16(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  const float magic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - magic;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// A f32 query value as three bf16 pieces, hi + mid + lo == x exactly
// (tests/test_torch_scan.py holds the same split exact in PyTorch): each piece
// rounds to nearest even what the earlier ones left, and every
// remainder is exact in f32. A bf16 plane uses hi alone.
__device__ __forceinline__ void split_query(float x, __nv_bfloat16* piece) {
  piece[0] = __float2bfloat16_rn(x);
  const float rest = x - __bfloat162float(piece[0]);
  piece[1] = __float2bfloat16_rn(rest);
  piece[2] = __float2bfloat16_rn(rest - __bfloat162float(piece[1]));
}

// Sort a query's candidate slots bv/bi[0, count) best first with a
// warp-wide bitonic network over 32 R slots (slot r * 32 + lane in
// register r; slots past count sort last as (-inf, INT_MAX)) and write
// the best `keep` back to slots [0, keep).
template <int R>
__device__ __forceinline__ void warp_sort_keep(float* bv, int* bi, int count, int keep,
                                               int lane) {
  float v[R];
  int id[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    v[r] = e < count ? bv[e] : -INFINITY;
    id[r] = e < count ? bi[e] : INT_MAX;
  }
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = r * 32 + lane;
        if (j >= 32) {  // both slots of the pair in this lane
          const int p = r ^ (j >> 5);
          if (p > r && (((e & k) == 0) == better(v[p], id[p], v[r], id[r]))) {
            const float tv = v[r];
            const int ti = id[r];
            v[r] = v[p];
            id[r] = id[p];
            v[p] = tv;
            id[p] = ti;
          }
        } else {
          const float ov = __shfl_xor_sync(kFull, v[r], j);
          const int oi = __shfl_xor_sync(kFull, id[r], j);
          // this slot keeps the better of the pair, or the worse
          const bool keeps_better = ((e & k) == 0) == ((e & j) == 0);
          if (keeps_better == better(ov, oi, v[r], id[r])) {
            v[r] = ov;
            id[r] = oi;
          }
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < keep) {
      bv[e] = v[r];
      bi[e] = id[r];
    }
  }
  __syncwarp();
}

// not inlined: one copy of the sorting networks keeps the scan loop's
// code small (the loop runs from the instruction cache)
__device__ __noinline__ void sort_keep(float* bv, int* bi, int slots, int count, int keep,
                                       int lane) {
  switch (slots) {
    case 32:
      return warp_sort_keep<1>(bv, bi, count, keep, lane);
    case 64:
      return warp_sort_keep<2>(bv, bi, count, keep, lane);
    case 128:
      return warp_sort_keep<4>(bv, bi, count, keep, lane);
    default:
      return warp_sort_keep<8>(bv, bi, count, keep, lane);
  }
}

// One query's view of a staged tile: its kTcItems scores with aux and
// the mask applied, which of them beat its threshold, by chunk of 32.
struct TileGate {
  static constexpr int kChunks = kTcItems / 32;
  float v[kChunks];
  bool take[kChunks];
  unsigned ballot[kChunks];
  float gv;
  int gi;
  int total;

  __device__ __forceinline__ void load(const float* row, const float* aux_s, long long tile,
                                       int n_items, bool quant, bool cosine, float qn,
                                       float tv, int ti, int lane) {
    gv = tv;
    gi = ti;
    total = 0;
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int i = r * 32 + lane;
      float x = row[i];
      if (quant) {
        x = x * aux_s[i];
        if (cosine) x = x / fmaxf(qn, 1e-12f);
      } else if (cosine) {
        x = x / fmaxf(aux_s[i] * qn, 1e-12f);
      }
      v[r] = tile + i < n_items ? x : NAN;  // NaN never beats a kept entry
      take[r] = better(v[r], (int)tile + i, gv, gi);
      ballot[r] = __ballot_sync(kFull, take[r]);
      total += __popc(ballot[r]);
    }
  }

  // append the survivors to the query's buffer qv/qi (count and threshold
  // in shared memory, written back by lane 0)
  __device__ __forceinline__ void append(float* qv, int* qi, int slots, int m, long long tile,
                                         int& count_s, float& tv, int& ti, int lane) {
    const unsigned before = (1u << lane) - 1;
    int count = count_s;
    if (count + total <= slots) {
#pragma unroll
      for (int r = 0; r < kChunks; ++r) {
        if (take[r]) {
          const int slot = count + __popc(ballot[r] & before);
          qv[slot] = v[r];
          qi[slot] = (int)tile + r * 32 + lane;
        }
        count += __popc(ballot[r]);
      }
    } else {
      // chunk by chunk, compacting when a chunk would overflow
#pragma unroll
      for (int r = 0; r < kChunks; ++r) {
        const int id = (int)tile + r * 32 + lane;
        if (count + __popc(ballot[r]) > slots) {
          __syncwarp();
          sort_keep(qv, qi, slots, count, m, lane);
          count = m;
          gv = qv[m - 1];
          gi = qi[m - 1];
          take[r] = better(v[r], id, gv, gi);
          ballot[r] = __ballot_sync(kFull, take[r]);
        }
        if (take[r]) {
          const int slot = count + __popc(ballot[r] & before);
          qv[slot] = v[r];
          qi[slot] = id;
        }
        count += __popc(ballot[r]);
      }
    }
    __syncwarp();
    if (lane == 0) {
      count_s = count;
      tv = gv;
      ti = gi;
    }
  }
};

// CTAs per SM the register budget is sized for: the narrow query tiles
// need little shared memory, so several CTAs (and their warps) can share
// an SM and hide each other's latency
template <int N, bool INT8>
constexpr int tc_min_blocks() {
  return N == 8 && INT8 ? 3 : (N <= 16 ? 2 : 1);
}

// CTA (x, y) scores query tile x (N queries) against items
// [y * span, (y + 1) * span) of a bf16 (INT8 = false) or int8 plane and
// writes list slab y of [grid_y, b, m]; the same grid contract as
// topn_range_kernel, on the same f32 queries q [b, kf]. The CTA splits
// its query tile into bf16 pieces as it stages B (see split_query).
template <int N, bool INT8>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<N, INT8>())
    topn_tc_kernel(const __grid_constant__ CUtensorMap plane,
                   const float* __restrict__ q, int b, int kf,
                   const float* __restrict__ aux, int n_items, int m, int mode, long long span,
                   long long n_pad, int stages, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
  constexpr int P = INT8 ? 3 : 1;
  constexpr int kAcc = N / 2;  // accumulator registers per thread
  const int kfp = align_up(kf, kTcChunk);
  const TcLayout L = tc_layout(N, kfp, INT8, m, stages);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base + L.a;
  __nv_bfloat16* bq = reinterpret_cast<__nv_bfloat16*>(base + L.bq);
  const int slots = tc_slots(m);
  float* sc = reinterpret_cast<float*>(base + L.sc);  // [N][kScStride] tile products
  float* aux_s = reinterpret_cast<float*>(base + L.aux);  // [kTcItems] tile aux
  float* bv = reinterpret_cast<float*>(base + L.bv);  // [N][slots] candidates
  int* bi = reinterpret_cast<int*>(base + L.bi);
  float* tv = reinterpret_cast<float*>(base + L.tv);  // [N] thresholds
  int* ti = reinterpret_cast<int*>(base + L.ti);
  int* cnt = reinterpret_cast<int*>(base + L.cnt);
  float* qn = reinterpret_cast<float*>(base + L.qn);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, lane = tid & 31;
  // broadcast, so that the compiler knows the warp's role is uniform and
  // keeps the consumers' wgmmas asynchronous
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int q0 = blockIdx.x * N, nq = min(N, b - q0);
  const long long begin = (long long)blockIdx.y * span;
  const long long end = min(begin + span, n_pad);
  const int ntiles = (int)((end - begin) / kTcItems);  // span and n_pad are tile multiples
  const int nchunks = (kfp + kTcChunk - 1) / kTcChunk;
  const bool quant = mode >= kDotQuant;
  const bool cosine = mode == kCosine || mode == kCosineQuant;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query pieces as resident B operands: [P][kfp / 16][N / 8] k16 x
  // 8-row blocks, each two 128-byte core matrices (features 0-7, 8-15)
  for (int e = tid; e < N * kfp; e += kTcThreads) {
    const int k = e % kfp, n = e / kfp;
    __nv_bfloat16 piece[3];
    split_query(n < nq && k < kf ? q[(long long)(q0 + n) * kf + k] : 0.f, piece);
    const int at = (((k / 16) * (N / 8) + n / 8) * 2 + (k % 16) / 8) * 64 + (n % 8) * 8 + k % 8;
#pragma unroll
    for (int p = 0; p < P; ++p) bq[p * N * kfp + at] = piece[p];
  }
  if (tid < N) {
    cnt[tid] = 0;
    tv[tid] = -INFINITY;
    ti[tid] = INT_MAX;
    float s = 0.f;
    if (cosine && tid < nq) {
      for (int k = 0; k < kf; ++k) {
        float x = q[(long long)(q0 + tid) * kf + k];
        if (!INT8) x = __bfloat162float(__float2bfloat16_rn(x));  // the norm of hi
        s = fmaf(x, x, s);
      }
    }
    qn[tid] = sqrtf(s);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B is read by wgmma
  __syncthreads();

  const int iters = ntiles * nchunks;
  if (warp == kTcConsumers / 32) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % stages;
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], L.stage_bytes);
        const int x = (int)(begin + (long long)(it / nchunks) * kTcItems);
        const int f = (it % nchunks) * kTcChunk;
        // int8: one 64 x 128-item box; bf16: two 64 x 64-item boxes
        unsigned char* dst = ring + s * L.stage_bytes;
        tma_load(dst, &plane, &full[s], x, f);
        if (!INT8) tma_load(dst + L.stage_bytes / 2, &plane, &full[s], x + 64, f);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns items [64 wg, 64 wg + 64) of each tile,
  // its warp wq the 16 items from 64 wg + 16 wq
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  float acc[kAcc];
  int it = 0;
  for (int t = 0; t < ntiles; ++t) {
    // accumulator d[4j + 2h + e] scores query 8j + 2tq + e against tile
    // item local[h] (warp row g + 8h; for int8 item 2g + h, see
    // codes_to_bf16); the items' aux loads here, behind the K loop
    const long long tile = begin + (long long)t * kTcItems;
    int local[2];
    float av[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      local[h] = 64 * wg + 16 * wq + (INT8 ? 2 * g + h : g + 8 * h);
      av[h] = aux[tile + local[h]];  // aux spans the padded plane
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    for (int c = 0; c < nchunks; ++c, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = ring + s * L.stage_bytes;
      uint32_t a[4][4];
      if (INT8) {
        // stage = [64 features][128 items], one 16-byte column per warp;
        // each ldmatrix.x4 covers 32 features (two k16 steps)
        const int col = 4 * wg + wq;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int f = pp * 32 + (lane >> 3) * 8 + (lane & 7);
          uint32_t r[4];
          ldsm_x4_trans(r, st + f * 128 + ((col ^ (f & 7)) << 4));
          codes_to_bf16(r[0], a[2 * pp][0], a[2 * pp][1]);
          codes_to_bf16(r[1], a[2 * pp][2], a[2 * pp][3]);
          codes_to_bf16(r[2], a[2 * pp + 1][0], a[2 * pp + 1][1]);
          codes_to_bf16(r[3], a[2 * pp + 1][2], a[2 * pp + 1][3]);
        }
      } else {
        // stage = two [64 features][64 items] boxes, one per warpgroup;
        // the warp's 16 items are 16-byte columns 2 wq and 2 wq + 1
        const unsigned char* box = st + wg * (L.stage_bytes / 2);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int mat = lane >> 3;
          const int f = ks * 16 + (mat >> 1) * 8 + (lane & 7);
          const int col = 2 * wq + (mat & 1);
          ldsm_x4_trans(a[ks], box + f * 128 + ((col ^ (f & 7)) << 4));
        }
      }
      mbar_arrive(&empty[s]);  // the stage is in registers now
      fence_regs<kAcc>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kb = c * 4 + ks;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const uint32_t at = smem_addr(bq + p * N * kfp) + (kb * (N / 8) * 2) * 128;
          wgmma_rs<N>(acc, a[ks], b_desc(at));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs<kAcc>(acc);
    }

    // the tile's raw products staged [N][kScStride] by item, and its aux;
    // the selecting warps apply aux and the mask (short code: this loop
    // runs per tile from the instruction cache)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[(8 * j + 2 * tq + e) * kScStride + local[h]] = acc[4 * j + 2 * h + e];
        }
      }
    }
    if (tq == 0) {
      aux_s[local[0]] = av[0];
      aux_s[local[1]] = av[1];
    }
    bar_sync(kBarSelect, kTcConsumers);
    // warp w selects for queries w, w + 8, ...: a score survives if it
    // beats the query's threshold (the m-th best kept at the last
    // compaction, or nothing yet) and takes the next slot of its buffer,
    // ranked by ballot. A buffer that a chunk of 32 would overflow is
    // compacted first: sorted, cut to its best m, threshold raised to the
    // m-th (slots >= m + 32, so the chunk then fits).
    for (int n = warp; n < nq; n += kTcConsumers / 32) {
      TileGate gate;
      gate.load(sc + n * kScStride, aux_s, tile, n_items, quant, cosine, qn[n], tv[n], ti[n],
                lane);
      if (gate.total > 0)
        gate.append(bv + n * slots, bi + n * slots, slots, m, tile, cnt[n], tv[n], ti[n], lane);
    }
    bar_sync(kBarSelect, kTcConsumers);  // the next tile reuses sc
  }
  // each query's best m, best first: sort what its buffer holds (slots
  // past the count are (-inf, INT_MAX), as the lists start)
  for (int n = warp; n < nq; n += kTcConsumers / 32) {
    sort_keep(bv + n * slots, bi + n * slots, slots, min(cnt[n], slots), m, lane);
    const long long row = (long long)blockIdx.y * b * m + (long long)(q0 + n) * m;
    for (int j = lane; j < m; j += 32) {
      out_v[row + j] = bv[n * slots + j];
      out_i[row + j] = bi[n * slots + j];
    }
  }
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

// -- launches ------------------------------------------------------------------

size_t fma_smem_bytes(int qb, int kf, int m) {
  return sizeof(float) * ((size_t)kf * qb + qb + (size_t)qb * kThreads + (size_t)qb * m) +
         sizeof(int) * (size_t)qb * m;
}

template <int QB>
int launch_fma(const float* q, int b, int kf, const float* mat, long long n_pad,
               const float* aux, int n_items, int m, int mode, long long span, int grid_y,
               float* out_v, int* out_i, cudaStream_t stream) {
  auto kernel = topn_range_kernel<QB>;
  const size_t smem = fma_smem_bytes(QB, kf, m);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QB - 1) / QB, grid_y);
  kernel<<<grid, kThreads, smem, stream>>>(q, b, kf, mat, n_pad, aux, n_items, m, mode, span,
                                           out_v, out_i);
  return (int)cudaGetLastError();
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call. The driver is loaded in every
// process with a CUDA context, so the library looks it up there instead
// of linking against libcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The plane [rows, n_pad] as TMA boxes of kTcChunk feature rows x 128
// bytes of items, 128-byte swizzle. Rows past the plane (the K tail of a
// last stage) read as zero.
bool plane_map(CUtensorMap* map, const void* mat, bool int8, int rows, long long n_pad) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)kTcChunk};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(mat), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel's dynamic shared memory, and all of the SM's 228 KB as
// shared memory so that as many CTAs fit as tc_ctas_per_sm reports
template <int N, bool INT8>
cudaError_t tc_attributes(const TcLayout& L) {
  auto kernel = topn_tc_kernel<N, INT8>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int N, bool INT8>
int tc_ctas_per_sm(const TcLayout& L) {
  int blocks = 0;
  if (tc_attributes<N, INT8>(L) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topn_tc_kernel<N, INT8>,
                                                    kTcThreads, L.total) != cudaSuccess)
    return 0;
  return blocks;
}

template <int N, bool INT8>
int launch_tc(const CUtensorMap& map, const TcLayout& L, const float* q, int b, int kf,
              const float* aux, int n_items, int m, int mode, long long span, long long n_pad,
              int grid_y, float* out_v, int* out_i, cudaStream_t stream) {
  auto kernel = topn_tc_kernel<N, INT8>;
  const cudaError_t err = tc_attributes<N, INT8>(L);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + N - 1) / N, grid_y);
  kernel<<<grid, kTcThreads, L.total, stream>>>(map, q, b, kf, aux, n_items, m, mode, span,
                                                n_pad, L.stages, out_v, out_i);
  return (int)cudaGetLastError();
}

template <bool INT8>
int dispatch_tc(const float* q, int b, int kf, const void* mat, long long n_pad, const float* aux,
                int n_items, int m, int mode, long long span, int grid_y, float* out_v,
                int* out_i, cudaStream_t st) {
  // int8 planes pad features to 32 (two k16 steps per ldmatrix); spans
  // are whole tiles
  if ((INT8 && kf % 32) || span % kTcItems || n_pad % kTcItems)
    return (int)cudaErrorInvalidValue;
  const TcPlan plan = tc_plan(b, kf, m, INT8);
  if (plan.n == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!plane_map(&map, mat, INT8, kf, n_pad)) return (int)cudaErrorInvalidValue;
#define ORYX_TC(N)                                                                           \
  case N:                                                                                    \
    return launch_tc<N, INT8>(map, plan.layout, q, b, kf, aux, n_items, m, mode, span, n_pad, \
                              grid_y, out_v, out_i, st)
  switch (plan.n) {
    ORYX_TC(8);
    ORYX_TC(16);
    ORYX_TC(32);
    ORYX_TC(64);
    ORYX_TC(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ORYX_TC
}

// float32 planes take the CUDA-core scan, bfloat16 and int8 planes the
// tensor-core scan
int dispatch_scan(const float* q, int b, int kf, const void* mat, int dtype,
                  long long n_pad, const float* aux, int n_items, int m, int mode,
                  long long span, int grid_y, float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > kMaxM || b < 1 || kf < 1 || grid_y < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return b <= 8 ? launch_fma<8>(q, b, kf, static_cast<const float*>(mat), n_pad, aux, n_items,
                                    m, mode, span, grid_y, out_v, out_i, st)
                    : launch_fma<32>(q, b, kf, static_cast<const float*>(mat), n_pad, aux,
                                     n_items, m, mode, span, grid_y, out_v, out_i, st);
    case 1:
      return dispatch_tc<false>(q, b, kf, mat, n_pad, aux, n_items, m, mode, span, grid_y, out_v,
                                out_i, st);
    case 2:
      return dispatch_tc<true>(q, b, kf, mat, n_pad, aux, n_items, m, mode, span, grid_y, out_v,
                               out_i, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 int8. Each launch returns cudaGetLastError() (0 = success).
extern "C" {

// The tensor-core scan's plan for b queries over kf features keeping m:
// out = {query tile N, ring stages, dynamic shared memory bytes, CTAs that
// fit on one SM}; returns N, 0 when no tile fits.
int topn_tc_plan(int b, int kf, int m, int dtype, int* out) {
  const bool int8 = dtype == 2;
  const TcPlan plan = tc_plan(b, kf, m, int8);
  out[0] = plan.n;
  out[1] = plan.layout.stages;
  out[2] = plan.layout.total;
  out[3] = 0;
#define ORYX_TC(N)                                                              \
  case N:                                                                       \
    out[3] = int8 ? tc_ctas_per_sm<N, true>(plan.layout)                        \
                  : tc_ctas_per_sm<N, false>(plan.layout);                      \
    break
  switch (plan.n) {
    ORYX_TC(8);
    ORYX_TC(16);
    ORYX_TC(32);
    ORYX_TC(64);
    ORYX_TC(128);
    default:
      break;
  }
#undef ORYX_TC
  return plan.n;
}

int topn_scan(const float* q, int b, int kf, const void* mat, int dtype,
              long long n_pad, const float* aux, int n_items, int m, int mode, long long span,
              int splits, float* out_v, int* out_i, void* stream) {
  return dispatch_scan(q, b, kf, mat, dtype, n_pad, aux, n_items, m, mode, span, splits,
                       out_v, out_i, stream);
}

int topn_candidates(const float* q, int b, int kf, const void* mat, int dtype,
                    long long n_pad, const float* aux, int n_items, int m, int mode,
                    long long block, int blocks, float* out_v, int* out_i, void* stream) {
  return dispatch_scan(q, b, kf, mat, dtype, n_pad, aux, n_items, m, mode, block, blocks,
                       out_v, out_i, stream);
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
