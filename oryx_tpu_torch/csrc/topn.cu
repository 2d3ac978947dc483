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
//     the plane and keeps a per-query top-m across the whole walk. Each
//     CTA writes its list to [splits, b, m].
//   - topn_candidates (B2): grid = query tiles x fixed 16384-item blocks;
//     no state crosses blocks. Each CTA writes its block's top-m to
//     [blocks, b, m]. Both entry points launch the same scan kernel and
//     differ only in the span and grid they pass.
//   - topn_merge: one CTA per query merges the sorted [S, b, m] lists into
//     [b, m] with the same tie rule (the TPU B1 merges in its own body,
//     B2 with one stable lax.top_k outside it); see topn_merge_kernel.
//
// The scan (topn_tc_kernel) runs on the tensor cores for every plane
// type. What bounds it on this card, and what the design does about it:
//   - the function. bfloat16 and int8 planes take a bf16 product with f32
//     accumulation (int8 codes are exact in bf16; the TPU kernel runs both
//     as bf16 MXU passes), bound by the bf16 tensor-core rate, 989
//     TFLOP/s. float32 planes take an f32-accurate product, as the TPU
//     kernel's Precision.HIGHEST does with six bf16 MXU passes over
//     three-piece splits of both operands. The same six passes run here:
//     each f32 value is exactly hi + mid + lo in bf16 (split_query for
//     the queries, split_pair for the items), each bf16 x bf16 product is
//     exact in f32, and the six wgmmas of a k16 step (hi.hi, hi.mid,
//     mid.hi, hi.lo, lo.hi, mid.mid) drop only the cross terms mid.lo,
//     lo.mid and lo.lo, about 2^-24 of a product, the size of f32
//     rounding. So the least time of a float32 plane's product is six
//     passes at 989 TFLOP/s.
//   - at b = 8 the plane's bytes: 250 features x 1M items of int8 take
//     0.077 ms at 3.35 TB/s against 0.004 ms of tensor-core work. The
//     plane streams through a ring of shared-memory stages fed by TMA
//     (cp.async.bulk.tensor, boxes of 128 bytes of items, 128-byte
//     swizzle), one producer warp keeping loads in flight; the CTAs of one
//     query tile read disjoint ranges, so every byte of the plane is read
//     once per query tile. A bf16 or int8 stage is 64 features, a float32
//     one 32 (16 KB, like bf16), so that the three resident query pieces
//     of a float32 plane leave room for three stages at N = 64.
//   - at b = 256 the operations: 2*b*kf*n per pass on the tensor cores.
//     wgmma takes a fixed M of 64 and the main path's batches are small,
//     so A and B are swapped: the item axis is M (S^T = mat^T q^T), N is
//     the query tile (8, 16, 32, 64 or 128, one template each) and K
//     steps by 16 features. Two consumer warpgroups each own 64 items of
//     a 128-item CTA tile.
//   - A (items x features) is built in registers (wgmma with A from
//     registers), not handed to wgmma as a shared-memory descriptor.
//     bf16: ldmatrix.trans turns the item-major stage into the A fragment
//     directly. int8: the same, and the codes convert to bf16 in registers
//     (exact, by a float magic-number trick with no conversion
//     instruction), so no bf16 copy of the stage is written to shared
//     memory. ldmatrix.trans moves 16-bit units, so an int8 warp tile maps
//     accumulator row g to item 2g and row g + 8 to item 2g + 1. float32:
//     ldmatrix cannot build a bf16 fragment from f32 units, so each thread
//     reads its values with plain 8-byte shared loads that follow the
//     swizzle; with the int8 row mapping its two items 2g, 2g + 1 sit side
//     by side in a feature row, and split_pair turns each pair of features
//     into three bf16 fragments in registers. The epilogue owns the item
//     mapping.
//   - B (queries x features) is resident in shared memory for the whole
//     walk, K-major in 8 x 16-byte core matrices, zero-padded to N rows
//     and to a whole number of stages (the TMA box past the plane's last
//     feature reads zeros), so that every stage runs its k16 steps with no
//     branch around a wgmma. int8 and float32 planes score the f32 query
//     exactly: the CTA splits it into three bf16 pieces (split_query) as
//     it stages B. int8 issues three wgmmas per k16 step on the same A
//     fragment, one per query piece; float32 the six above; bf16 one, on
//     the query rounded to bf16 (hi, and the cosine norm of hi).
//   - Wide planes. Resident pieces take P * N * kfp * 2 bytes, which at
//     thousands of features leave no room for any query tile (the TPU
//     kernel halves its tiles instead, pallas_topn.py:491-520). Past
//     kResidentMaxFeatures, or wherever no resident plan fits, the plan
//     streams B (the QS kernels): split_queries_kernel writes each query
//     tile's pieces once to device memory, laid out per stage exactly as
//     the resident B is, and the producer brings the stage's slice of them
//     into the ring beside the items with one bulk copy on the same
//     barrier. The consumers then release a stage only after its wgmmas
//     have read it. Every plane of up to kResidentMaxFeatures features
//     keeps the resident plan it had.
//   - Selection. The tile's products are staged in shared memory; warp w
//     takes queries w, w + 8, ..., applies aux and the mask, and appends
//     the scores that beat the query's threshold to its candidate buffer
//     (ranked by ballot, no atomics). A full buffer is sorted by a warp
//     bitonic network and cut to its best m, and the m-th becomes the
//     threshold, which only rises: the result does not depend on the
//     order of arrival, and ties go to the lowest id as everywhere else.
//     This, not the tensor cores, is what holds the bf16 and int8 scans
//     back at b >= 16: with one or two CTAs of nine warps per SM the
//     per-query chains of shared-memory loads, ballots and compactions
//     stay exposed. The per-tile code is kept short (the sort is one
//     out-of-line copy, the MMA warps only stage raw products), since it
//     runs from the instruction cache on every tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kMaxM = 128;  // longest list: pallas_topn.MAX_KERNEL_K
constexpr unsigned kFull = 0xffffffffu;

// scoring modes (pallas_topn._score_tile): quantized planes multiply by
// the folded per-item scale, unquantized cosine divides by norm * |q|
enum Mode { kDot = 0, kCosine = 1, kDotQuant = 2, kCosineQuant = 3 };

// plane types, numbered as the C interface's dtype
enum Plane { kF32 = 0, kBf16 = 1, kInt8 = 2 };

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// -- the scan --------------------------------------------------------------------

constexpr int kTcItems = 128;                  // items per CTA tile (2 warpgroups x wgmma M)
constexpr int kTcConsumers = 256;              // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kTcMaxStages = 6;
constexpr int kTcMinStages = 3;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr int kBarSelect = 1;       // named barrier of the consumer threads
constexpr int kScStride = kTcItems + 8;  // staged products per query row, padded
constexpr int kResidentMaxFeatures = 1024;  // widest plane whose query pieces stay resident
constexpr int kQsSumFeatures = 256;  // features a streamed tile sums on the tensor cores alone

// features per ring stage: four k16 steps of bf16 or int8 items, two of
// float32 ones (16 KB either way for bf16 and f32)
__host__ __device__ constexpr int tc_chunk(int pt) { return pt == kF32 ? 32 : 64; }
__host__ __device__ constexpr int tc_item_bytes(int pt) {
  return pt == kF32 ? 4 : (pt == kBf16 ? 2 : 1);
}
// resident query pieces: a bf16 plane scores hi alone, the others all three
__host__ __device__ constexpr int tc_query_pieces(int pt) { return pt == kBf16 ? 1 : 3; }
// wgmmas per k16 step, and the (item piece, query piece) of pass p:
// float32 hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid; int8 the codes
// times each query piece; bf16 one pass
__host__ __device__ constexpr int tc_passes(int pt) { return pt == kF32 ? 6 : tc_query_pieces(pt); }
__host__ __device__ constexpr int pass_item_piece(int pt, int p) {
  return pt != kF32 ? 0 : (p == 2 || p == 5 ? 1 : (p == 4 ? 2 : 0));
}
__host__ __device__ constexpr int pass_query_piece(int pt, int p) {
  return pt != kF32 ? p : (p == 1 || p == 5 ? 1 : (p == 3 ? 2 : 0));
}

// Byte offsets of the scan's shared memory, from a 1024-aligned base
// (the 128-byte swizzle repeats every 1024 bytes).
struct TcLayout {
  int stages;
  int stage_bytes;  // the items of a stage
  int q_stage;      // the query pieces of a stage when B streams, else 0
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

// B is either resident (P pieces of n x kfp) or a ring of one stage's
// pieces (P x n x chunk) beside each item stage
__host__ __device__ inline TcLayout tc_layout(int n, int kfp, int pt, int m, int stages,
                                              bool streamed) {
  TcLayout L;
  L.stages = stages;
  L.stage_bytes = tc_chunk(pt) * kTcItems * tc_item_bytes(pt);
  L.q_stage = streamed ? tc_query_pieces(pt) * n * tc_chunk(pt) * 2 : 0;
  L.a = 0;
  L.bq = stages * L.stage_bytes;
  L.sc = L.bq + (streamed ? stages * L.q_stage : tc_query_pieces(pt) * n * kfp * 2);
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
// above b's (powers of two from 8 to 128) whose query pieces, staged
// scores, candidate buffers and at least kTcMinStages stages fit; N = 8
// may run on two. Up to kResidentMaxFeatures features the pieces stay
// resident if any N fits so; past it, or if none does, they stream, and
// N = 8 always fits then. n = 0 when nothing fits.
struct TcPlan {
  int n;
  bool streamed;
  TcLayout layout;
};

inline TcPlan tc_plan(int b, int kf, int m, int pt) {
  const int kfp = align_up(kf, tc_chunk(pt));
  int top = 8;
  while (top < b && top < 128) top <<= 1;
  for (int streamed = kf > kResidentMaxFeatures; streamed < 2; ++streamed) {
    for (int n = top; n >= 8; n >>= 1) {
      const TcLayout fixed = tc_layout(n, kfp, pt, m, 0, streamed);
      const int stages = min(kTcMaxStages, (kSmemLimit - fixed.total) /
                                               (fixed.stage_bytes + fixed.q_stage + 16));
      if (stages >= kTcMinStages || (n == 8 && stages >= 2))
        return {n, streamed != 0, tc_layout(n, kfp, pt, m, stages, streamed)};
    }
  }
  return {0, false, tc_layout(8, kfp, pt, m, 0, false)};
}

// bytes of the streamed query pieces of b queries: P pieces of every
// query tile of n rows, kfp features each
inline long long tc_scratch_bytes(int b, int kf, int n, int pt) {
  const long long rows = (long long)(b + n - 1) / n * n;
  return rows * align_up(kf, tc_chunk(pt)) * tc_query_pieces(pt) * 2;
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

// one TMA box of the plane: 128 bytes of items from x, feature rows from f
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int f) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(f)
      : "memory");
}

// one contiguous run of device memory (16-byte aligned, a 16-byte
// multiple) into shared memory, completing on the barrier as tma_load
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Two f32 item values (features k, k + 1 of one item: the low and high
// halves of an A fragment register) as three bf16x2 pieces, rounded as
// split_query rounds, so hi + mid + lo == x exactly for each.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 md = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(md);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(md);
  lo = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
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

// The streamed B of the QS scans: the pieces of query tile t (n rows) for
// stage c of the K walk at qs + (t * nchunks + c) * P * n * chunk, piece p
// n * chunk values after piece p - 1, each laid out as the resident B of
// one stage (8 x 16-byte core matrices, K-major), queries past b and
// features past kf zero. One thread per (query row, feature).
template <int PT>
__global__ void split_queries_kernel(const float* __restrict__ q, int b, int kf, int n,
                                     __nv_bfloat16* __restrict__ qs) {
  constexpr int P = tc_query_pieces(PT);
  constexpr int kChunk = tc_chunk(PT);
  const int kfp = align_up(kf, kChunk), nchunks = kfp / kChunk;
  const long long total = (long long)(b + n - 1) / n * n * kfp;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / kfp;
    const int k = (int)(e - row * kfp);
    const int t = (int)(row / n), r = (int)(row - (long long)t * n);
    const int c = k / kChunk, kk = k - c * kChunk;
    __nv_bfloat16 piece[3];
    split_query(row < b && k < kf ? q[row * kf + k] : 0.f, piece);
    const int at = (((kk / 16) * (n / 8) + r / 8) * 2 + (kk % 16) / 8) * 64 + (r % 8) * 8 + kk % 8;
    __nv_bfloat16* dst = qs + ((long long)t * nchunks + c) * P * n * kChunk;
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p * n * kChunk + at] = piece[p];
  }
}

// CTAs per SM the register budget is sized for: the narrow query tiles
// need little shared memory, so several CTAs (and their warps) can share
// an SM and hide each other's latency
template <int N, int PT>
constexpr int tc_min_blocks() {
  return N == 8 && PT == kInt8 ? 3 : (N <= 16 ? 2 : 1);
}

// CTA (x, y) scores query tile x (N queries) against items
// [y * span, (y + 1) * span) of a plane of type PT and writes list slab y
// of [grid_y, b, m], on the f32 queries q [b, kf]. topn_scan (B1)
// launches it with span = n_pad / splits, topn_candidates (B2) with span
// = one item block. The CTA splits its query tile into bf16 pieces as it
// stages B (see split_query), or, with QS, streams the pieces that
// split_queries_kernel left in qs.
template <int N, int PT, bool QS>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<N, PT>())
    topn_tc_kernel(const __grid_constant__ CUtensorMap plane,
                   const float* __restrict__ q, int b, int kf,
                   const float* __restrict__ aux, int n_items, int m, int mode, long long span,
                   long long n_pad, int stages, const __nv_bfloat16* __restrict__ qs,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int P = tc_query_pieces(PT);
  constexpr int kChunk = tc_chunk(PT);
  constexpr int kSteps = kChunk / 16;  // k16 steps per stage
  constexpr int kAcc = N / 2;          // accumulator registers per thread
  constexpr int kBoxes = kTcItems * tc_item_bytes(PT) / 128;  // TMA boxes per stage
  constexpr bool kPairedRows = PT != kBf16;  // accumulator row g = item 2g
  const int kfp = align_up(kf, kChunk);
  const TcLayout L = tc_layout(N, kfp, PT, m, stages, QS);
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
  const int nchunks = kfp / kChunk;
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
  if constexpr (!QS) {
    for (int e = tid; e < N * kfp; e += kTcThreads) {
      const int k = e % kfp, n = e / kfp;
      __nv_bfloat16 piece[3];
      split_query(n < nq && k < kf ? q[(long long)(q0 + n) * kf + k] : 0.f, piece);
      const int at = (((k / 16) * (N / 8) + n / 8) * 2 + (k % 16) / 8) * 64 + (n % 8) * 8 + k % 8;
#pragma unroll
      for (int p = 0; p < P; ++p) bq[p * N * kfp + at] = piece[p];
    }
  }
  if (tid < N) {
    cnt[tid] = 0;
    tv[tid] = -INFINITY;
    ti[tid] = INT_MAX;
    float s = 0.f;
    if (cosine && tid < nq) {
      for (int k = 0; k < kf; ++k) {
        float x = q[(long long)(q0 + tid) * kf + k];
        if (PT == kBf16) x = __bfloat162float(__float2bfloat16_rn(x));  // the norm of hi
        s = fmaf(x, x, s);
      }
    }
    qn[tid] = sqrtf(s);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B is read by wgmma
  __syncthreads();

  const int iters = ntiles * nchunks;
  if (warp == kTcConsumers / 32) {
    // producer: one lane keeps the ring full, each stage kChunk feature
    // rows of the tile's items as kBoxes boxes of 128 bytes of items
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % stages;
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], L.stage_bytes + L.q_stage);
        const int x = (int)(begin + (long long)(it / nchunks) * kTcItems);
        const int f = (it % nchunks) * kChunk;
        unsigned char* dst = ring + s * L.stage_bytes;
#pragma unroll
        for (int j = 0; j < kBoxes; ++j)
          tma_load(dst + j * (L.stage_bytes / kBoxes), &plane, &full[s],
                   x + j * (kTcItems / kBoxes), f);
        if constexpr (QS)  // this stage's slice of the query tile's pieces
          bulk_load(reinterpret_cast<unsigned char*>(bq) + s * L.q_stage,
                    reinterpret_cast<const unsigned char*>(qs) +
                        ((long long)blockIdx.x * nchunks + it % nchunks) * L.q_stage,
                    L.q_stage, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns items [64 wg, 64 wg + 64) of each tile,
  // its warp wq the 16 items from 64 wg + 16 wq
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const uint32_t bq_addr = smem_addr(bq);
  const uint32_t piece_bytes = QS ? N * kChunk * 2 : N * kfp * 2;
  float acc[kAcc];
  int it = 0;
  for (int t = 0; t < ntiles; ++t) {
    // accumulator d[4j + 2h + e] scores query 8j + 2tq + e against tile
    // item local[h] (warp row g + 8h: item g + 8h for bf16, 2g + h for
    // int8 and float32); the items' aux loads here, behind the K loop
    const long long tile = begin + (long long)t * kTcItems;
    int local[2];
    float av[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      local[h] = 64 * wg + 16 * wq + (kPairedRows ? 2 * g + h : g + 8 * h);
      av[h] = aux[tile + local[h]];  // aux spans the padded plane
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    for (int c = 0; c < nchunks; ++c, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = ring + s * L.stage_bytes;
      uint32_t a[kSteps][3][4];  // [k16 step][item piece][fragment register]
      if (PT == kInt8) {
        // stage = [64 features][128 items], one 16-byte column per warp;
        // each ldmatrix.x4 covers 32 features (two k16 steps)
        const int col = 4 * wg + wq;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int f = pp * 32 + (lane >> 3) * 8 + (lane & 7);
          uint32_t r[4];
          ldsm_x4_trans(r, st + f * 128 + ((col ^ (f & 7)) << 4));
          codes_to_bf16(r[0], a[2 * pp][0][0], a[2 * pp][0][1]);
          codes_to_bf16(r[1], a[2 * pp][0][2], a[2 * pp][0][3]);
          codes_to_bf16(r[2], a[2 * pp + 1][0][0], a[2 * pp + 1][0][1]);
          codes_to_bf16(r[3], a[2 * pp + 1][0][2], a[2 * pp + 1][0][3]);
        }
      } else if (PT == kBf16) {
        // stage = two [64 features][64 items] boxes, one per warpgroup;
        // the warp's 16 items are 16-byte columns 2 wq and 2 wq + 1
        const unsigned char* box = st + wg * (L.stage_bytes / 2);
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const int mat = lane >> 3;
          const int f = ks * 16 + (mat >> 1) * 8 + (lane & 7);
          const int col = 2 * wq + (mat & 1);
          ldsm_x4_trans(a[ks][0], box + f * 128 + ((col ^ (f & 7)) << 4));
        }
      } else {
        // stage = four [32 features][32 items] boxes, two per warpgroup;
        // the warp's 16 items are half of box 2 wg + wq / 2, and this
        // thread's items 2g, 2g + 1 one 8-byte word of each feature row
        const unsigned char* box = st + (2 * wg + (wq >> 1)) * (L.stage_bytes / 4);
        const int item = 16 * (wq & 1) + 2 * g;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          float2 x[4];  // features 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of the step
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int f = ks * 16 + 2 * tq + (u & 1) + 8 * (u >> 1);
            x[u] = *reinterpret_cast<const float2*>(
                box + f * 128 + (((item >> 2) ^ (f & 7)) << 4) + (item & 3) * 4);
          }
          // registers 0-3: (row g, k 2tq..), (row g + 8, k 2tq..),
          // (row g, k 2tq + 8..), (row g + 8, k 2tq + 8..)
          split_pair(x[0].x, x[1].x, a[ks][0][0], a[ks][1][0], a[ks][2][0]);
          split_pair(x[0].y, x[1].y, a[ks][0][1], a[ks][1][1], a[ks][2][1]);
          split_pair(x[2].x, x[3].x, a[ks][0][2], a[ks][1][2], a[ks][2][2]);
          split_pair(x[2].y, x[3].y, a[ks][0][3], a[ks][1][3], a[ks][2][3]);
        }
      }
      // the stage's items are in registers now; a streamed B is still
      // read by the wgmmas, so a QS stage is released after them
      if constexpr (!QS) mbar_arrive(&empty[s]);
      if constexpr (QS) {  // each run of kQsSumFeatures starts from zero (see below)
        const bool fresh = c % (kQsSumFeatures / kChunk) == 0;
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[j] = fresh ? 0.f : acc[j];
      }
      fence_regs<kAcc>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const uint32_t at = QS ? bq_addr + (s * L.q_stage + ks * (N / 8) * 2 * 128)
                               : bq_addr + ((c * kSteps + ks) * (N / 8) * 2) * 128;
#pragma unroll
        for (int p = 0; p < tc_passes(PT); ++p)
          wgmma_rs<N>(acc, a[ks][pass_item_piece(PT, p)],
                      b_desc(at + pass_query_piece(PT, p) * piece_bytes));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs<kAcc>(acc);
      if constexpr (QS) mbar_arrive(&empty[s]);
      if (QS && ((c + 1) % (kQsSumFeatures / kChunk) == 0 || c + 1 == nchunks)) {
        // each run of kQsSumFeatures features' products summed into the
        // tile's staged products in IEEE f32 (this thread's own entries of
        // sc, which the previous tile's selection has left): over
        // thousands of features the tensor cores' f32 accumulation alone
        // drifts past the plain version's rounding
        const bool first = c < kQsSumFeatures / kChunk;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* at = sc + (8 * j + 2 * tq + e) * kScStride + local[h];
              *at = first ? acc[4 * j + 2 * h + e] : *at + acc[4 * j + 2 * h + e];
            }
          }
        }
      }
    }

    // the tile's raw products staged [N][kScStride] by item (a QS tile's
    // are there already), and its aux; the selecting warps apply aux and
    // the mask (short code: this loop runs per tile from the instruction
    // cache)
    if constexpr (!QS) {
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

// -- the merge ---------------------------------------------------------------------
//
// topn_merge: [S, b, m] lists (each best first, list s holding ids below
// list s + 1's, padding (-inf, INT_MAX)) to the best m per row, exactly
// as a stable sort of the row's S * m entries in (list, rank) order:
// value descending, equal values to the lower list, then the lower rank.
// It moves 8 bytes per entry and computes nothing, so its bound is bytes;
// what holds a merge back is the chain of dependent steps. Here the
// chain is log2(S) levels long: one CTA per row copies a chunk of lists
// into shared memory (cp.async, so the copy runs on while the CTA works)
// and reduces it by pairwise merges, level by level, each keeping the
// best m. A pair merge is cut into runs of kMergeRun outputs, one thread
// each: the thread finds how many of its run's predecessors come from the
// left list by a binary search along the merge path (O(log m)), then
// merges its run sequentially, so all threads work at once. Lists that
// do not fit one chunk (20M items give S = 1221) are taken chunk after
// chunk, the running result riding as the chunk's first list; the tree
// reads the chunk buffer only at its first level, so the next chunk's
// copy overlaps the later levels, where few threads are busy. The running
// result prunes what follows: an entry of a later list that does not beat
// its m-th value can never enter (the result's m entries come first and
// win ties), so in a row of several chunks each later list counts only
// its entries above that value, and a merge skips the runs past its
// lists' counts: where a chunk's best entries are a small share of a
// row's, as in the scans' lists, most runs after the first chunk skip. A
// row of one chunk keeps no counts. m = 1 is an argmax and takes its own
// kernel. The scans never keep a NaN, and the merge assumes none.

constexpr int kMergeThreads = 256;
constexpr int kMergeEntries = 4096;  // entries of a chunk of lists: 32 KB with their ids
constexpr int kMergeRun = 8;         // outputs a thread merges in a row
constexpr int kMergeCtas = 4;        // CTAs per SM the shared memory is sized for
constexpr int kMergeSmem = 233472 / kMergeCtas - 1024;  // an SM's 228 KB less 1 KB a CTA

// shared memory of a chunk of `chunk` lists: the entries of A, B (half
// as many lists) and C (a quarter), and their counts when kept
__host__ __device__ inline int merge_smem(int chunk, int m, bool counts) {
  const int nb = (chunk + 1) / 2;
  return (chunk + nb + (nb + 1) / 2) * (m * 8 + (counts ? 4 : 0));
}

// One level of the tree: n lists of m entries in sv/si, list l valid up
// to sc[l] (m for every list without sc), to (n + 1) / 2 lists in dv/di
// with counts dc (kept with sc). Pair p merges
// lists 2p and 2p + 1 into its best m (or as many as both hold), equal
// values to the left list; an odd last list moves up as it is.
__device__ __forceinline__ void merge_level(const float* sv, const int* si, const int* sc,
                                            int n, int m, float* dv, int* di, int* dc) {
  const int runs = (m + kMergeRun - 1) / kMergeRun;  // runs per output list
  for (int w = threadIdx.x; w < (n + 1) / 2 * runs; w += kMergeThreads) {
    const int p = w / runs, j0 = (w - p * runs) * kMergeRun;
    const float* lv = sv + 2 * p * m;
    const int* li = si + 2 * p * m;
    float* ov = dv + p * m;
    int* oi = di + p * m;
    const int ca = sc ? sc[2 * p] : m;
    if (2 * p + 1 == n) {
      if (sc && j0 == 0) dc[p] = ca;
      for (int j = j0; j < min(j0 + kMergeRun, ca); ++j) {
        ov[j] = lv[j];
        oi[j] = li[j];
      }
      continue;
    }
    const float* rv = lv + m;
    const int* ri = li + m;
    const int cb = sc ? sc[2 * p + 1] : m, c = min(m, ca + cb);
    if (sc && j0 == 0) dc[p] = c;
    if (j0 >= c) continue;
    // i = left entries among the first j0 outputs: the first i for which
    // left[i] does not go before right[j0 - 1 - i]
    int lo = max(0, j0 - cb), hi = min(j0, ca);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lv[mid] >= rv[j0 - 1 - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // i + k = j < m: both heads load at once, in the lists' slots even
    // past a count, which the test then ignores
    for (int j = j0, j1 = min(j0 + kMergeRun, c), i = lo, k = j0 - lo; j < j1; ++j) {
      const float x = lv[i], y = rv[k];
      if (k >= cb || (i < ca && x >= y)) {
        ov[j] = x;
        oi[j] = li[i++];
      } else {
        ov[j] = y;
        oi[j] = ri[k++];
      }
    }
  }
  __syncthreads();
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  }
}

// Start copying lists [first, first + lists) of the row, list-major, to
// sv/si, VEC entries at a time (4 when m and the tensors' alignment allow
// 16-byte copies, else 1); cp.async.wait_all and a barrier complete it.
template <int VEC>
__device__ __forceinline__ void copy_lists(float* sv, int* si, const float* cv, const int* ci,
                                           int first, int lists, int b, int row, int m) {
  for (int e = threadIdx.x * VEC; e < lists * m; e += kMergeThreads * VEC) {
    const int l = e / m;
    const long long at = ((long long)(first + l) * b + row) * m + (e - l * m);
    cp_async<VEC * 4>(sv + e, cv + at);
    cp_async<VEC * 4>(si + e, ci + at);
  }
}

// One CTA per row. Shared memory: A holds `chunk` lists, B half as many
// and C a quarter (rounded up), then, for a row of several chunks, each
// list's count; the tree goes A -> B, then B <-> C.
template <int VEC>
__global__ void __launch_bounds__(kMergeThreads, kMergeCtas)
    topn_merge_kernel(const float* __restrict__ cv, const int* __restrict__ ci, int S, int b,
                      int m, int chunk, float* __restrict__ ov, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = (chunk + 1) / 2, nc = (nb + 1) / 2;
  float* av = reinterpret_cast<float*>(smem_raw);
  int* ai = reinterpret_cast<int*>(av + chunk * m);
  float* bv = reinterpret_cast<float*>(ai + chunk * m);
  int* bi = reinterpret_cast<int*>(bv + nb * m);
  float* xv = reinterpret_cast<float*>(bi + nb * m);
  int* xi = reinterpret_cast<int*>(xv + nc * m);
  const bool prune = S > chunk;
  int* ac = prune ? xi + nc * m : nullptr;
  int* bc = prune ? ac + chunk : nullptr;
  int* xc = prune ? bc + nb : nullptr;
  const int row = blockIdx.x;
  // the first chunk fills A, every list whole; each later one fills A
  // from slot 1, behind the running result in slot 0
  int lists = min(chunk, S), slot0 = 0;
  copy_lists<VEC>(av, ai, cv, ci, 0, lists, b, row, m);
  for (int l = threadIdx.x; prune && l < lists; l += kMergeThreads) ac[l] = m;
  for (int done = 0;;) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (slot0) {
      // each new list's entries above the result's m-th value
      const float t = av[m - 1];
      for (int l = threadIdx.x; l < lists; l += kMergeThreads) {
        const float* lv = av + (1 + l) * m;
        int lo = 0, hi = m;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lv[mid] > t) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        ac[1 + l] = lo;
      }
      __syncthreads();
    }
    const int n = slot0 + lists;
    done += lists;
    lists = min(chunk - 1, S - done);  // the next chunk's
    const float* sv = av;
    const int* si = ai;
    if (n > 1) {
      merge_level(av, ai, ac, n, m, bv, bi, bc);
      if (lists > 0) copy_lists<VEC>(av + m, ai + m, cv, ci, done, lists, b, row, m);
      sv = bv;
      si = bi;
      const int* sc = bc;
      for (int k = (n + 1) / 2; k > 1; k = (k + 1) / 2) {
        float* dv = sv == bv ? xv : bv;
        int* di = sv == bv ? xi : bi;
        int* dc = sv == bv ? xc : bc;
        merge_level(sv, si, sc, k, m, dv, di, dc);
        sv = dv;
        si = di;
        sc = dc;
      }
    }
    // the result holds m entries: the first chunk's lists are whole
    if (lists <= 0) {
      for (int j = threadIdx.x; j < m; j += kMergeThreads) {
        ov[(long long)row * m + j] = sv[j];
        oi[(long long)row * m + j] = si[j];
      }
      return;
    }
    for (int j = threadIdx.x; j < m; j += kMergeThreads) {  // the result to slot 0 of A
      av[j] = sv[j];
      ai[j] = si[j];
    }
    if (threadIdx.x == 0) ac[0] = m;
    slot0 = 1;
  }
}

// m = 1: the merge of one-entry lists is an argmax, taken in registers
// by one CTA per row: the best head, equal values to the lower list.
__global__ void __launch_bounds__(kMergeThreads)
    topn_merge_heads_kernel(const float* __restrict__ cv, const int* __restrict__ ci, int S,
                            int b, float* __restrict__ ov, int* __restrict__ oi) {
  __shared__ float wv[kMergeThreads / 32];
  __shared__ int ws[kMergeThreads / 32], wi[kMergeThreads / 32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v = -INFINITY;
  int s = INT_MAX, id = INT_MAX;  // s = INT_MAX: nothing taken yet
#pragma unroll 4
  for (int l = threadIdx.x; l < S; l += kMergeThreads) {
    const float w = cv[(long long)l * b + row];
    const int wid = ci[(long long)l * b + row];
    if (s == INT_MAX || w > v) {  // l rises, so an equal value keeps the first
      v = w;
      s = l;
      id = wid;
    }
  }
  // the warp's best, then warp 0 over the warps' best
  for (int round = 0;; ++round) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, o);
      const int s2 = __shfl_xor_sync(kFull, s, o), id2 = __shfl_xor_sync(kFull, id, o);
      if (s2 != INT_MAX && (s == INT_MAX || v2 > v || (v2 == v && s2 < s))) {
        v = v2;
        s = s2;
        id = id2;
      }
    }
    if (round == 1) break;
    if (lane == 0) {
      wv[warp] = v;
      ws[warp] = s;
      wi[warp] = id;
    }
    __syncthreads();
    if (warp != 0) return;
    const bool have = lane < kMergeThreads / 32;
    v = have ? wv[lane] : -INFINITY;
    s = have ? ws[lane] : INT_MAX;
    id = have ? wi[lane] : INT_MAX;
  }
  if (lane == 0) {
    ov[row] = v;
    oi[row] = id;
  }
}

// -- launches ------------------------------------------------------------------

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

// The plane [rows, n_pad] as TMA boxes of one stage's feature rows x 128
// bytes of items, 128-byte swizzle. Rows past the plane (the K tail of a
// last stage) read as zero.
bool plane_map(CUtensorMap* map, const void* mat, int pt, int rows, long long n_pad) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int esize = tc_item_bytes(pt);
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)tc_chunk(pt)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = pt == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : pt == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, 2, const_cast<void*>(mat), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel's dynamic shared memory, and all of the SM's 228 KB as
// shared memory so that as many CTAs fit as tc_ctas_per_sm reports
template <int N, int PT, bool QS>
cudaError_t tc_attributes(const TcLayout& L) {
  auto kernel = topn_tc_kernel<N, PT, QS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int N, int PT, bool QS>
int tc_ctas_per_sm(const TcLayout& L) {
  int blocks = 0;
  if (tc_attributes<N, PT, QS>(L) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topn_tc_kernel<N, PT, QS>,
                                                    kTcThreads, L.total) != cudaSuccess)
    return 0;
  return blocks;
}

// f(std::integral_constant<int, PT>) for a plane type, f(...<int, N>) for
// a query tile; cudaErrorInvalidValue for anything else
template <typename F>
int with_plane(int pt, F f) {
  switch (pt) {
    case kF32:
      return f(std::integral_constant<int, kF32>{});
    case kBf16:
      return f(std::integral_constant<int, kBf16>{});
    case kInt8:
      return f(std::integral_constant<int, kInt8>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_tile(int n, F f) {
  switch (n) {
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// f(integral_constant<bool, QS>) for the plan's way of holding B
template <typename F>
int with_streamed(bool streamed, F f) {
  return streamed ? f(std::integral_constant<bool, true>{})
                  : f(std::integral_constant<bool, false>{});
}

template <int PT>
int dispatch_tc(const float* q, int b, int kf, const void* mat, long long n_pad, const float* aux,
                int n_items, int m, int mode, long long span, int grid_y, void* scratch,
                long long scratch_bytes, float* out_v, int* out_i, cudaStream_t st) {
  // int8 planes pad features to 32 (two k16 steps per ldmatrix); spans
  // are whole tiles
  if ((PT == kInt8 && kf % 32) || span % kTcItems || n_pad % kTcItems)
    return (int)cudaErrorInvalidValue;
  const TcPlan plan = tc_plan(b, kf, m, PT);
  CUtensorMap map;
  if (plan.n == 0 || !plane_map(&map, mat, PT, kf, n_pad)) return (int)cudaErrorInvalidValue;
  if (plan.streamed && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 ||
                        scratch_bytes < tc_scratch_bytes(b, kf, plan.n, PT)))
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* qs = static_cast<__nv_bfloat16*>(scratch);
  return with_tile(plan.n, [&](auto tile) {
    constexpr int N = decltype(tile)::value;
    return with_streamed(plan.streamed, [&](auto streamed) {
      constexpr bool QS = decltype(streamed)::value;
      const cudaError_t err = tc_attributes<N, PT, QS>(plan.layout);
      if (err != cudaSuccess) return (int)err;
      if (QS) {
        const long long total = tc_scratch_bytes(b, kf, N, PT) / (2 * tc_query_pieces(PT));
        const long long want = (total + 255) / 256;
        const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
        split_queries_kernel<PT><<<blocks, 256, 0, st>>>(q, b, kf, N, qs);
        const cudaError_t split_err = cudaGetLastError();
        if (split_err != cudaSuccess) return (int)split_err;
      }
      const dim3 grid((b + N - 1) / N, grid_y);
      topn_tc_kernel<N, PT, QS><<<grid, kTcThreads, plan.layout.total, st>>>(
          map, q, b, kf, aux, n_items, m, mode, span, n_pad, plan.layout.stages, qs, out_v,
          out_i);
      return (int)cudaGetLastError();
    });
  });
}

int dispatch_scan(const float* q, int b, int kf, const void* mat, int dtype,
                  long long n_pad, const float* aux, int n_items, int m, int mode,
                  long long span, int grid_y, void* scratch, long long scratch_bytes,
                  float* out_v, int* out_i, void* stream) {
  if (m < 1 || m > kMaxM || b < 1 || kf < 1 || grid_y < 1) return (int)cudaErrorInvalidValue;
  return with_plane(dtype, [&](auto pt) {
    return dispatch_tc<decltype(pt)::value>(q, b, kf, mat, n_pad, aux, n_items, m, mode, span,
                                            grid_y, scratch, scratch_bytes, out_v, out_i,
                                            static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 int8. Each launch returns cudaGetLastError() (0 = success).
extern "C" {

// The scan's plan for b queries over kf features keeping m: out = {query
// tile N, ring stages, dynamic shared memory bytes, CTAs that fit on one
// SM, 1 if the query pieces stream, the bytes of scratch they stream
// from (0 when resident)}; returns N, 0 when no tile fits.
int topn_tc_plan(int b, int kf, int m, int dtype, long long* out) {
  for (int j = 0; j < 6; ++j) out[j] = 0;
  with_plane(dtype, [&](auto pt) {
    constexpr int PT = decltype(pt)::value;
    const TcPlan plan = tc_plan(b, kf, m, PT);
    out[0] = plan.n;
    out[1] = plan.layout.stages;
    out[2] = plan.layout.total;
    if (plan.n > 0) {
      out[3] = with_tile(plan.n, [&](auto tile) {
        return with_streamed(plan.streamed, [&](auto streamed) {
          return tc_ctas_per_sm<decltype(tile)::value, PT, decltype(streamed)::value>(
              plan.layout);
        });
      });
      out[4] = plan.streamed;
      out[5] = plan.streamed ? tc_scratch_bytes(b, kf, plan.n, PT) : 0;
    }
    return 0;
  });
  return (int)out[0];
}

// scratch: scratch_bytes of device memory, 16-byte aligned, for the
// streamed query pieces (topn_tc_plan's out[5]; unused when resident)
int topn_scan(const float* q, int b, int kf, const void* mat, int dtype,
              long long n_pad, const float* aux, int n_items, int m, int mode, long long span,
              int splits, void* scratch, long long scratch_bytes, float* out_v, int* out_i,
              void* stream) {
  return dispatch_scan(q, b, kf, mat, dtype, n_pad, aux, n_items, m, mode, span, splits,
                       scratch, scratch_bytes, out_v, out_i, stream);
}

int topn_candidates(const float* q, int b, int kf, const void* mat, int dtype,
                    long long n_pad, const float* aux, int n_items, int m, int mode,
                    long long block, int blocks, void* scratch, long long scratch_bytes,
                    float* out_v, int* out_i, void* stream) {
  return dispatch_scan(q, b, kf, mat, dtype, n_pad, aux, n_items, m, mode, block, blocks,
                       scratch, scratch_bytes, out_v, out_i, stream);
}

int topn_merge(const float* cv, const int* ci, int lists, int b, int m, float* out_v,
               int* out_i, void* stream) {
  if (m < 1 || m > kMaxM || lists < 1 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 1) {
    topn_merge_heads_kernel<<<b, kMergeThreads, 0, st>>>(cv, ci, lists, b, out_v, out_i);
    return (int)cudaGetLastError();
  }
  // lists per chunk: kMergeEntries entries, fewer where a row of several
  // chunks needs room for counts in kMergeSmem bytes
  const bool counts = lists > kMergeEntries / m;
  int chunk = min(lists, kMergeEntries / m);
  while (merge_smem(chunk, m, counts) > kMergeSmem) --chunk;
  const int smem = merge_smem(chunk, m, counts);
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(cv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ci) % 16 == 0;
  auto kernel = vec ? topn_merge_kernel<4> : topn_merge_kernel<1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b, kMergeThreads, smem, st>>>(cv, ci, lists, b, m, chunk, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
