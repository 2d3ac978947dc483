// Fused Lloyd sweep for k-means, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of oryx_tpu/ops/pallas_kmeans.py:
//
//   kmeans_sweep.tc  <-  pallas_kmeans._sweep_kernel  (B3)
//
// What it computes. Points p [n_rows, d] f32 (rows >= n_items are not
// counted) against centers c [kp, d] f32 (rows >= k_real are padding):
// d2 = |p|^2 - 2 p.c + |c|^2 at f32 accuracy (the TPU kernel's
// Precision.HIGHEST), padded centers +inf, the first argmin (ties to the
// lowest center), then the per-center sums of the assigned points, their
// counts and the cost sum(max(min d2, 0)), rounded once to f32: sums
// [kp, d], counts [kp], cost [1]. A point with a NaN distance (a NaN or
// inf feature) adds NaN to the cost and goes to no center, as in the TPU
// kernel, whose equality argmin against a NaN minimum matches nothing.
//
// One cooperative launch per sweep, a persistent grid (as many CTAs as
// fit on the card at once, from the occupancy API) in up to three phases
// with a grid barrier between them (a counter in the scratch buffer,
// zeroed before the launch; integer atomics only):
//   0. the centers are split once into three bf16 pieces (hi + mid + lo
//      == c exactly, rounded as topn.cu's split_query), laid out as wgmma
//      B operands, one "center stage" per (N tile, k16 step), and |c|^2 in
//      f32 (split_centers): into a global buffer when the stages are
//      streamed, else by each CTA into its own shared memory at the start
//      of phase 1, with no barrier;
//   1. each CTA walks a contiguous run of 64-point tiles, two at a time:
//      a producer warp copies each tile (contiguous in row-major memory,
//      so one bulk copy for any d; wide rows chunk by chunk, see Shapes)
//      into its warpgroup's ring of point
//      slots behind mbarriers, and each of two consumer warpgroups takes
//      its own tiles: the points are wgmma's M, the three-piece A fragment
//      is built in registers from the staged f32 rows (split_pair), and six
//      bf16 passes (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid) per k16
//      step go into a fresh f32 accumulator over the center tile N (16-128;
//      kp > 128 walks N tiles), which the CUDA cores add to the tile's
//      running sum (the tensor cores' accumulation rounds toward zero, a
//      bias that grows with every add); |p|^2 comes from the same
//      registers on the CUDA cores. The argmin runs over the accumulator fragment, then
//      across the quad (a NaN distance ranks first, ties to the lower
//      center). A whole tile's sums come from the staged copy, so each
//      point is read once from device memory;
//   2. each CTA reduces its slice of the kp*d + kp + 1 outputs over the
//      CTAs' partials in a fixed order (CTA order, or a fixed warp tree
//      when there are few outputs), in f64, and rounds to f32 once.
// Nothing uses float atomics (the slab's counts take integer ones), so
// two launches agree bit for bit.
//
// What bounds it on this card (chip_smoke.sweep_bound: bytes at 3.35 TB/s
// against 2*n*k*d + n*d operations at the f32-accurate tensor-core rate,
// six bf16 passes, 989/6 TFLOP/s):
//   - 200,000 x 20, k = 10 (the k-means app's shape): 16 MB, 0.0048 ms,
//     bytes; there the launch, the grid barriers and the reduce count;
//   - 10,000,000 x 20, k = 10: 800 MB, 0.239 ms, bytes;
//   - 1,000,000 x 256, k = 256: 1.3e11 operations, 0.797 ms, operations.
//
// What held the earlier CUDA-core sweep back (PERF.md §6), and
// what this design does about each:
//   - distances on an FMA tile bound by shared-memory loads: wgmma from
//     registers, six bf16 passes;
//   - synchronous loads between barriers: each tile is one bulk copy into
//     a ring of up to three slots per warpgroup, fed by a producer warp, and
//     the two warpgroups work on different tiles, so one's loads, argmin
//     and sums overlap the other's product; points are copied with an L2
//     evict-first policy, center stages with evict-last, so that the
//     streamed points do not push the stages and the slab out of L2;
//   - centers reloaded per point tile: split once per launch; resident in
//     shared memory when their stages fit in half of it, else streamed per
//     (N tile, k16 step) through a ring of kStreamSlots by bulk copies (at
//     d = k = 256 the three pieces take 384 KB, over the 227 KB a CTA may
//     use), each stage feeding both warpgroups;
//   - sums as per-point read-modify-write chains into a global slab: where
//     kp*d f64 fits in shared memory, each warpgroup keeps as many copies
//     of it as its threads cover (one per group of d threads, so no two
//     threads add to one address) and adds each row from the staged tile,
//     several rows' loads issued together (add_rows_to_copies); else
//     (d = k = 256) into the CTA's f64 slab of the partials, each tile's
//     rows sorted by center and each run of one center summed once and
//     added once, several runs' 16-byte read-modify-writes in flight, the
//     two warpgroups each taking half of the columns of both tiles
//     (sort_rows, add_runs_to_slab);
//   - a separate reduce kernel, one thread per output over ~528 partials:
//     folded into the launch (phase 2), parallel over the outputs, over as
//     many partials as resident CTAs;
//   - host work per call: the plan, the grid and the shared-memory
//     attributes are kept per (device, shape) on both sides of the ctypes
//     call.
//
// Shapes. Any d and kp. Where a 64 x d tile does not fit beside the
// center ring (d above about 300 at k = 256, 430 at small k), each tile
// is staged in chunks of 16-256 features, one chunk per point slot: every
// center tile's distances walk the chunks, then the sums walk them once
// more (the assignment is known only after the last chunk), so such a
// point is read (center tiles + 1) times, from memory or L2; those sums
// go to the slab. Points whose address is not 16-byte aligned
// (or, in chunks, rows not a multiple of 4 features) are copied by 4-byte
// cp.async of the producer warp, the ragged words of a whole last tile by
// hand, and features past d read as zero in the A fragment (d need not be
// a multiple of 4 or 16). The slab's counts are the CTA's partials in
// global memory, and |c|^2 is read from the scratch buffer beyond 4,096
// centers, so no kp runs out of shared memory. The scratch buffer holds a
// kp x d f64 slab per CTA.
//
// What it does not do yet: at narrow shapes (d = 20, k = 10) the
// consumer warps' instructions per point (the masked A fragment build,
// the argmin, the shared-memory f64 sums), not the bytes, set the time;
// the staged rows are read with 4-byte loads whose banks collide when d
// is a multiple of 32 (the tile is not swizzled); each k16 step waits for
// its own six wgmmas; the slab's read-modify-writes go through L2; the
// launch, its memset and the grid barriers are a fixed cost per sweep;
// the chunked path of wide rows rereads each tile and keeps no
// accumulators in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;                  // points per tile: one warpgroup's wgmma M
constexpr int kGroups = 2;                 // consumer warpgroups, each on its own tiles
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block can use
constexpr int kMaxPointSlots = 3;
constexpr int kStreamSlots = 3;     // center stages in flight when they are not resident
constexpr int kBulkMax = 32768;     // bytes per bulk copy
constexpr int kBarAll = 1;          // named barriers: all consumer threads,
constexpr int kBarGroup = 2;        // and each warpgroup's (2 and 3)
constexpr int kPreload = 4;         // rows whose loads a summing thread issues together
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// The center tile: N = the power of two >= kp from 16 to 128; kp > 128
// walks ceil(kp / 128) tiles of 128. (Two accumulators of N / 2 floats per
// thread, the k16 step's and the tile's, fit the registers up to N = 128.)
__host__ __device__ inline int center_tile(int kp) {
  int n = 16;
  while (n < kp && n < 128) n <<= 1;
  return n;
}

// Shared-memory layout and work split of one sweep, computed on the host
// for (kp, d) and passed to the kernel by value. Offsets are bytes from a
// 128-aligned base; arrays marked [wg] hold one part per warpgroup.
struct Plan {
  int N, ntiles, ksteps;  // center tile, center tiles, k16 steps over d
  int cstages;            // ntiles * ksteps stages of 3 x N x 16 bf16
  int cslots;             // == cstages when resident (loaded once), else streamed
  int resident;
  int kc, chunks;          // features per staged point row (d, or a chunk of d), chunks
  int pslots, tile_bytes;  // [wg] point slots of kRows x kc f32
  int groups;  // > 0: [wg] that many f64 accumulator copies in shared memory;
               // 0: each CTA accumulates in its slab of the partials
  int k_global;  // |c|^2 and the slab's counts in global memory, not shared
  int cring, pring, acc, cnt, cn, cost, bestd, besti, key, order, seg, bars;
  int smem;
};

__host__ __device__ inline int stage_bytes(int n) { return 3 * n * 16 * 2; }

// Lay out a plan for its resident, cslots, pslots and groups; returns its bytes.
inline int lay_out(Plan& P, int kp, int d) {
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long here = at;
    at = (at + bytes + 127) / 128 * 128;
    return (int)(here < INT_MAX ? here : INT_MAX);
  };
  P.cring = take((long long)P.cslots * stage_bytes(P.N));
  P.pring = take((long long)kGroups * P.pslots * P.tile_bytes);
  P.acc = take((long long)kGroups * P.groups * kp * d * 8);
  // the copies' counts, or the slab's (one copy, integer atomics)
  P.cnt = take(P.groups > 0 ? (long long)kGroups * P.groups * kp * 4 : (P.k_global ? 0 : kp * 4));
  P.cn = take(P.k_global ? 0 : P.N * P.ntiles * 4);
  P.cost = take(kConsumers * 8);
  P.bestd = take(kGroups * kRows * 4);
  P.besti = take(kGroups * kRows * 4);
  P.key = take(kGroups * kRows * 4);
  P.order = take(kGroups * kRows * 4);
  P.seg = take(kGroups * (kRows + 8) * 4);
  P.bars = take((2 * P.cslots + 2 * kGroups * P.pslots) * 8);
  at += 128;  // slack to align the base
  P.smem = (int)(at < kSmemLimit + 1 ? at : kSmemLimit + 1);
  return P.smem;
}

// The plan for (kp, d). Whole 64 x d point tiles first, then tiles cut
// into chunks of kc features, widest first. For each: center stages
// resident when they fit in half of shared memory, else streamed through
// kStreamSlots; for whole tiles, f64 accumulators in shared memory (per
// warpgroup as many copies as its threads cover, up to 128 / min(d, 128))
// if one copy each fits beside two point slots, else the global slab; then
// as many point slots as fit (up to kMaxPointSlots per warpgroup, at least
// two for chunks). |c|^2 and the slab's counts stay in shared memory up
// to kKSmem bytes each (4,096 centers). The
// narrowest chunk always fits: every (kp, d) has a plan.
constexpr int kKSmem = 16384;
constexpr int kChunkWidths[] = {256, 128, 64, 32, 16};

inline Plan make_plan(int kp, int d) {
  Plan P;
  memset(&P, 0, sizeof(P));
  P.N = center_tile(kp);
  P.ntiles = (kp + P.N - 1) / P.N;
  P.ksteps = (d + 15) / 16;
  P.cstages = P.ntiles * P.ksteps;
  P.k_global = P.ntiles * P.N * 4 > kKSmem;
  const int max_groups = 128 / (d < 128 ? d : 128);
  for (int c = -1; c < (int)(sizeof(kChunkWidths) / sizeof(int)); ++c) {
    P.kc = c < 0 ? d : kChunkWidths[c];
    if (c >= 0 && P.kc >= d) continue;
    P.chunks = (d + P.kc - 1) / P.kc;
    P.tile_bytes = align_up(kRows * P.kc * 4, 128);
    for (int resident = 1; resident >= 0; --resident) {
      P.resident = resident;
      P.cslots = resident ? P.cstages : kStreamSlots;
      if (resident && (P.k_global || (long long)P.cstages * stage_bytes(P.N) > kSmemLimit / 2))
        continue;
      for (int want_acc = P.chunks == 1; want_acc >= 0; --want_acc) {
        for (int ps = kMaxPointSlots; ps >= (P.chunks > 1 ? 2 : 1); --ps) {
          if (want_acc && ps < 2) continue;  // the slab rather than unfed tensor cores
          P.pslots = ps;
          P.groups = 0;
          if (lay_out(P, kp, d) > kSmemLimit) continue;
          if (!want_acc) return P;
          for (int g = max_groups; g >= 1; --g) {
            P.groups = g;
            if (lay_out(P, kp, d) <= kSmemLimit) return P;
          }
        }
      }
    }
  }
  P.smem = 0;
  return P;
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

// bytes (a multiple of 16, both addresses 16-aligned) from global memory
// into shared memory, completing on bar, under an L2 cache policy
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// 4 bytes from global memory into shared memory, asynchronously
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one arrival on bar once this thread's earlier copy4_async calls have landed
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// All CTAs of the (cooperative, so co-resident) grid meet here; `target`
// is the barrier's ordinal times the grid size.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// Descriptor of a K-major B operand without swizzle: core matrices of
// 8 rows x 16 bytes stored as 128 contiguous bytes, the two K halves of
// a k16 step 128 bytes apart (leading offset), successive 8-row groups
// 256 bytes apart (stride offset). The same layout as topn.cu's.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// D[64 x N] = A[64 x 16] (registers, bf16) * B[16 x N] (shared memory, bf16)
// + (scale_d ? D : 0)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A f32 value as three bf16 pieces, hi + mid + lo == x exactly: each piece
// rounds to nearest even what the earlier ones left (topn.cu's
// split_query; tests/test_torch_kmeans.py holds the same split in PyTorch).
__device__ __forceinline__ void split_value(float x, __nv_bfloat16* piece) {
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

// Two f32 values (features k, k + 1 of one point: the low and high halves
// of an A fragment register) as three bf16x2 pieces, rounded as
// split_value rounds (topn.cu's split_pair).
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

// the (point piece, center piece) of pass p: hi.hi, hi.mid, mid.hi,
// hi.lo, lo.hi, mid.mid; the cross terms mid.lo, lo.mid and lo.lo left out
// are about 2^-24 of a product, the size of f32 rounding
__host__ __device__ constexpr int point_piece(int p) {
  return p == 2 || p == 5 ? 1 : (p == 4 ? 2 : 0);
}
__host__ __device__ constexpr int center_piece(int p) {
  return p == 1 || p == 5 ? 1 : (p == 3 ? 2 : 0);
}

// CTAs per SM the register budget is cut for: three where the accumulator
// is smallest (N = 16: 72 registers, no spill), which the narrow shapes'
// latency-bound per-tile work needs
template <int N>
constexpr int min_blocks() {
  return N <= 16 ? 3 : (N <= 64 ? 2 : 1);
}

struct Scratch {
  unsigned* barrier;      // grid barrier counter, zero at launch
  __nv_bfloat16* stages;  // [cstages][3][N * 16] the split centers
  float* cn;              // [ntiles * N] |c|^2
  double* part_sums;      // [ctas][kp * d]
  int* part_counts;       // [ctas][kp]
  double* part_cost;      // [ctas]
};

// The tile's per-center sums and counts into accumulator copies in shared
// memory: thread (grp, j0) of the warpgroup adds column j0 (+ dw, ...) of
// rows grp, grp + G, ... into copy grp, the rows' loads issued kPreload at
// a time. f64 accumulators hold the sums of 10M f32 points within f64
// rounding (2^-53 per add), far inside chip_smoke's check_sweep tolerance
// of 1e-5 of max |sum|.
__device__ __forceinline__ void add_rows_to_copies(const float* tile, const float* bestd,
                                                   const int* besti, int nvalid, int d, int kp,
                                                   int G, int wt, double* acc, int* cnt) {
  const int dw = d < 128 ? d : 128;
  const int grp = wt / dw, j0 = wt % dw;
  if (grp >= G) return;
  for (int r0 = grp; r0 < nvalid; r0 += kPreload * G) {
    int a[kPreload];
#pragma unroll
    for (int u = 0; u < kPreload; ++u) {
      const int rr = r0 + u * G;
      // a NaN minimum goes to no center
      a[u] = rr < nvalid && !isnan(bestd[rr]) ? besti[rr] : -1;
    }
    for (int j = j0; j < d; j += dw) {
      float x[kPreload];
#pragma unroll
      for (int u = 0; u < kPreload; ++u) x[u] = a[u] >= 0 ? tile[(r0 + u * G) * d + j] : 0.f;
#pragma unroll
      for (int u = 0; u < kPreload; ++u)
        if (a[u] >= 0) acc[(grp * kp + a[u]) * d + j] += (double)x[u];
    }
    if (j0 == 0) {
#pragma unroll
      for (int u = 0; u < kPreload; ++u)
        if (a[u] >= 0) cnt[grp * kp + a[u]] += 1;
    }
  }
}

// The slab (kp * d beyond shared memory): the tile's rows in a stable
// order by center (a rank by counting), cut into runs of one center:
// order [kRows] holds the rows, seg [kRows + 8] the runs' first positions,
// then (at kRows + 1) the rows kept. wt = the thread's index in its
// warpgroup, bar its warpgroup's named barrier.
__device__ __forceinline__ void sort_rows(const float* bestd, const int* besti, int nvalid,
                                          int* key, int* order, int* seg, int wt, int bar) {
  const int lane = wt & 31, wwarp = wt >> 5;
  if (wt < kRows) {
    const float m = bestd[wt];
    key[wt] = wt < nvalid && !isnan(m) ? besti[wt] : INT_MAX;
  }
  bar_sync(bar, 128);
  if (wt < kRows) {
    const int mine = key[wt];
    int rank = 0;
    for (int q = 0; q < kRows; ++q) {
      const int kq = key[q];
      rank += kq < mine || (kq == mine && q < wt);
    }
    order[rank] = wt;
  }
  bar_sync(bar, 128);
  bool head = false;
  if (wt < kRows) {
    const int kk = key[order[wt]];
    head = kk != INT_MAX && (wt == 0 || key[order[wt - 1]] != kk);
    if (kk != INT_MAX && (wt == kRows - 1 || key[order[wt + 1]] == INT_MAX))
      seg[kRows + 1] = wt + 1;  // rows kept
    if (wt == 0 && kk == INT_MAX) seg[kRows + 1] = 0;
  }
  const unsigned heads = __ballot_sync(kFull, head);
  if (lane == 0 && wwarp < kRows / 32) seg[kRows + 2 + wwarp] = __popc(heads);
  bar_sync(bar, 128);
  if (head) {
    int at = __popc(heads & ((1u << lane) - 1));
    for (int w = 0; w < wwarp; ++w) at += seg[kRows + 2 + w];
    seg[at] = wt;
  }
  if (wt == 0) {
    int runs = 0;
    for (int w = 0; w < kRows / 32; ++w) runs += seg[kRows + 2 + w];
    seg[kRows] = runs;
  }
}

// Each run of a sorted tile (rows ld floats apart) summed in f64 from shared
// memory and added to its slab row (d doubles apart) once, columns
// [j_lo, j_hi) only, B runs' read-modify-writes of V adjacent columns
// each (one 16-byte word for V = 2) in flight together (their centers
// differ, so they cannot collide). Where the columns pair up the kernel
// takes V = 2 with B = 4; else V = 1 with B = 8 at N = 128, else B = 4:
// the largest batches for which no instantiation spilled.
template <int B, int V>
__device__ __forceinline__ void add_runs_to_slab(const float* tile, int ld, const int* key,
                                                 const int* order, const int* seg, int d,
                                                 int j_lo, int j_hi, double* slab, int wt) {
  const int runs = seg[kRows], kept = seg[kRows + 1];
  const int units = (j_hi - j_lo) / V;
  if (units <= 0) return;
  const int dw = units < 128 ? units : 128;
  const int groups = 128 / dw, grp = wt / dw, u0 = wt % dw;
  if (grp >= groups) return;
  for (int s0 = grp * B; s0 < runs; s0 += groups * B) {
    int c[B], lo[B], hi[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int s = s0 + u;
      lo[u] = s < runs ? seg[s] : 0;
      hi[u] = s < runs ? (s + 1 < runs ? seg[s + 1] : kept) : 0;
      c[u] = s < runs ? key[order[lo[u]]] : 0;
    }
    for (int q = u0; q < units; q += dw) {
      const int j = j_lo + q * V;
      double v[B][V], old[B][V];
#pragma unroll
      for (int u = 0; u < B; ++u) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[u][e] = 0.0;
        for (int i = lo[u]; i < hi[u]; ++i) {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] += (double)tile[order[i] * ld + j + e];
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        double* at = slab + (long long)c[u] * d + j;
        if (V == 2) {
          const double2 o = lo[u] < hi[u] ? *reinterpret_cast<const double2*>(at)
                                          : make_double2(0.0, 0.0);
          old[u][0] = o.x;
          old[u][V - 1] = o.y;
        } else {
          old[u][0] = lo[u] < hi[u] ? *at : 0.0;
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (lo[u] >= hi[u]) continue;
        double* at = slab + (long long)c[u] * d + j;
        if (V == 2)
          *reinterpret_cast<double2*>(at) =
              make_double2(old[u][0] + v[u][0], old[u][V - 1] + v[u][V - 1]);
        else
          *at = old[u][0] + v[u][0];
      }
    }
  }
}

// The centers as three bf16 pieces (hi + mid + lo == c exactly), laid out
// as wgmma B operands: stage cs = (N tile, k16 step) holds [3][N * 16] in
// the core-matrix order of b_desc; and cn[c] = |c|^2 in f32, +inf for a
// padded center (c >= k_real), so that it loses to every real one. Thread
// `first` of `stride` takes every stride-th element.
template <int N>
__device__ __forceinline__ void split_centers(const float* ctr, int kp, int k_real, int d,
                                              const Plan& P, __nv_bfloat16* stages, float* cn,
                                              long long first, long long stride) {
  const long long piece = (long long)N * 16;
  for (long long e = first; e < (long long)P.cstages * piece; e += stride) {
    const int cs = (int)(e / piece), w = (int)(e % piece);
    const int nt = cs / P.ksteps, ks = cs % P.ksteps;
    // w = ((row / 8) * 2 + k / 8) * 64 + (row % 8) * 8 + k % 8
    const int blk = w / 64;
    const int row = (blk >> 1) * 8 + (w % 64) / 8;
    const int c = nt * N + row, k = ks * 16 + (blk & 1) * 8 + w % 8;
    __nv_bfloat16 pc[3];
    split_value(c < kp && k < d ? ctr[(long long)c * d + k] : 0.f, pc);
#pragma unroll
    for (int p = 0; p < 3; ++p) stages[(long long)cs * 3 * piece + p * piece + w] = pc[p];
  }
  for (long long c = first; c < (long long)P.ntiles * N; c += stride) {
    float s = 0.f;
    for (int k = 0; k < d && c < k_real; ++k) {
      const float x = ctr[c * d + k];
      s = fmaf(x, x, s);
    }
    cn[c] = c < k_real ? s : INFINITY;
  }
}

// The running argmin of a thread's two rows over its accumulator fragment
// of one center tile: d[4j + 2h + e] holds row g + 8h, center
// c0 + 8j + e (c0 = the tile's first center + 2 tq). A NaN distance ranks
// first as -inf (no real distance is -inf: that would need an infinite
// p.c, hence an infinite norm); ties go to the lower center.
template <int N>
__device__ __forceinline__ void argmin_tile(const float* acc, const float* pn, const float* cn,
                                            int c0, float* bd, int* bi) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        float v = fmaf(-2.f, acc[4 * j + 2 * h + e], pn[h]) + cn[c];
        v = isnan(v) ? -INFINITY : v;
        if (v < bd[h] || (v == bd[h] && c < bi[h])) {
          bd[h] = v;
          bi[h] = c;
        }
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, min_blocks<N>())
    sweep_kernel(const float* __restrict__ pts, long long n, int d,
                 const float* __restrict__ ctr, int kp, int k_real, int tiles_per_cta,
                 int bulk, Plan P, Scratch S, float* __restrict__ sums,
                 float* __restrict__ counts, float* __restrict__ cost) {
  constexpr int kAcc = N / 2;  // accumulator registers per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  unsigned char* cring = base + P.cring;
  unsigned char* pring = base + P.pring;
  double* acc_s = reinterpret_cast<double*>(base + P.acc);
  int* cnt_s = reinterpret_cast<int*>(base + P.cnt);
  float* cn_s = reinterpret_cast<float*>(base + P.cn);
  double* cost_s = reinterpret_cast<double*>(base + P.cost);
  uint64_t* cfull = reinterpret_cast<uint64_t*>(base + P.bars);
  uint64_t* cempty = cfull + P.cslots;
  uint64_t* pfull = cempty + P.cslots;            // [wg][pslots]
  uint64_t* pempty = pfull + kGroups * P.pslots;  // [wg][pslots]

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);  // uniform, keeps wgmma asynchronous
  const int ctas = gridDim.x;
  const long long kpd = (long long)kp * d;
  const int nt_total = P.ntiles * N;
  const int cbytes = stage_bytes(N);
  const long long piece = (long long)N * 16;

  // -- phase 0: the centers split once, when they are streamed from a
  // global buffer (each CTA splits its own resident copy in phase 1) --------------
  if (!P.resident) {
    split_centers<N>(ctr, kp, k_real, d, P, S.stages, S.cn, blockIdx.x * kThreads + tid,
                     ctas * kThreads);
    // the stages are read by bulk copies (the async proxy) after the barrier
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    grid_barrier(S.barrier, (unsigned)ctas);
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }

  // -- phase 1: the sweep ------------------------------------------------------------
  // The CTA walks 64-point tiles [t_begin, t_end) in pairs, warpgroup wg
  // taking tile t_begin + 2 p + wg of pair p (an empty tile past t_end).
  const long long tiles = (n + kRows - 1) / kRows;
  const long long t_begin = (long long)blockIdx.x * tiles_per_cta;
  const long long t_end = min(tiles, t_begin + tiles_per_cta);
  const int pairs = (int)((max(t_end - t_begin, 0LL) + 1) / 2);
  double* slab = S.part_sums + (long long)blockIdx.x * kpd;
  if (tid == 0) {
    for (int s = 0; s < P.cslots; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cempty[s], kConsumers);
    }
    for (int s = 0; s < kGroups * P.pslots; ++s) {
      mbar_init(&pfull[s], bulk ? 1 : 32);
      mbar_init(&pempty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int G = P.groups;
  if (G > 0) {
    for (long long e = tid; e < (long long)kGroups * G * kpd; e += kThreads) acc_s[e] = 0.0;
    for (int e = tid; e < kGroups * G * kp; e += kThreads) cnt_s[e] = 0;
  } else {
    for (long long e = tid; e < kpd; e += kThreads) slab[e] = 0.0;
    int* cnt = P.k_global ? S.part_counts + (long long)blockIdx.x * kp : cnt_s;
    for (int e = tid; e < kp; e += kThreads) cnt[e] = 0;
  }
  for (int e = tid; e < kConsumers; e += kThreads) cost_s[e] = 0.0;  // rows r of every tile
  if (P.resident) {
    split_centers<N>(ctr, kp, k_real, d, P, reinterpret_cast<__nv_bfloat16*>(cring), cn_s, tid,
                     kThreads);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B is read by wgmma
  } else if (!P.k_global) {
    for (int e = tid; e < nt_total; e += kThreads) cn_s[e] = S.cn[e];
  }
  __syncthreads();

  // Each warpgroup takes `loads` point slots per pair of tiles: its whole
  // tile once (chunks == 1), or chunk after chunk of it for every center
  // tile's distances and once more for the sums (the assignment is known
  // only after the last chunk). The producer fills them in that order.
  const int loads = P.chunks == 1 ? 1 : (P.ntiles + 1) * P.chunks;
  if (warp == kConsumers / 32) {
    // producer: each load into its warpgroup's next point slot (a whole
    // tile: one bulk copy, the ragged last words by hand; a chunk: one bulk
    // copy per row; for points not 16-byte aligned, or chunks of rows not
    // 16-byte aligned, 4-byte cp.async by the whole warp), then, when the
    // centers are not resident, the center stages that load's distances
    // take (the whole warp waits on each barrier, so that its lanes never
    // spin apart while lane 0 issues the copies); points are read with an
    // evict-first policy, which keeps the center stages and the slab in L2
    uint64_t stream_policy, keep_policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(stream_policy));
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep_policy));
    int cit = 0, pit = 0;
    for (int p = 0; p < pairs; ++p) {
      for (int li = 0; li < loads; ++li, ++pit) {
        const int slot = pit % P.pslots;
        const int k0 = (li % P.chunks) * P.kc;
        const int width = min(P.kc, d - k0);
        for (int wg = 0; wg < kGroups; ++wg) {
          uint64_t* full = &pfull[wg * P.pslots + slot];
          mbar_wait(&pempty[wg * P.pslots + slot], ((pit / P.pslots) & 1) ^ 1);
          const long long t = t_begin + 2 * p + wg;
          const long long row0 = t * kRows;
          const int rows = t < t_end ? (int)min((long long)kRows, n - row0) : 0;
          float* dst = reinterpret_cast<float*>(pring + (long long)(wg * P.pslots + slot) *
                                                            P.tile_bytes);
          const float* src = pts + row0 * d + k0;
          if (P.chunks == 1 && bulk) {
            if (lane == 0) {
              const int words = rows * d;
              const int bytes = words * 4 & ~15;
              for (int w = bytes / 4; w < words; ++w) dst[w] = src[w];
              mbar_arrive_tx(full, bytes);
              for (int off = 0; off < bytes; off += kBulkMax)
                bulk_load(reinterpret_cast<unsigned char*>(dst) + off,
                          reinterpret_cast<const unsigned char*>(src) + off,
                          min(kBulkMax, bytes - off), full, stream_policy);
            }
          } else if (P.chunks == 1) {  // whole rows: one contiguous run of words
            for (int w = lane; w < rows * d; w += 32) copy4_async(dst + w, src + w);
            copies_arrive(full);
          } else if (bulk) {
            if (lane == 0) mbar_arrive_tx(full, rows * width * 4);
            __syncwarp();
            for (int r = lane; r < rows; r += 32)
              bulk_load(dst + r * P.kc, src + (long long)r * d, width * 4, full, stream_policy);
          } else {
            for (int r = 0; r < rows; ++r)
              for (int w = lane; w < width; w += 32)
                copy4_async(dst + r * P.kc + w, src + (long long)r * d + w);
            copies_arrive(full);
          }
          __syncwarp();
        }
        if (!P.resident && li < P.ntiles * P.chunks) {
          // all stages for a whole tile; for a chunk, its own of its center tile
          const int s0 = P.chunks == 1 ? 0 : (li / P.chunks) * P.ksteps + k0 / 16;
          const int s1 = P.chunks == 1 ? P.cstages : s0 + (width + 15) / 16;
          for (int s = s0; s < s1; ++s, ++cit) {
            const int cs = cit % P.cslots;
            mbar_wait(&cempty[cs], ((cit / P.cslots) & 1) ^ 1);
            if (lane == 0) {
              mbar_arrive_tx(&cfull[cs], cbytes);
              bulk_load(cring + cs * cbytes, S.stages + (long long)s * 3 * piece, cbytes,
                        &cfull[cs], keep_policy);
            }
            __syncwarp();
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg, its warp wq rows 16 wq + g and 16 wq + g + 8
    // of the A fragment (= of the tile)
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
    const int wt = tid & 127;  // thread in the warpgroup
    const int bar = kBarGroup + wg;
    int r[2];
    r[0] = 16 * wq + g;
    r[1] = r[0] + 8;
    int cit = 0, pit = 0;  // center stages and point loads taken
    for (int p = 0; p < pairs; ++p) {
      const float* tile = nullptr;
      float pn[2] = {0.f, 0.f}, bd[2] = {INFINITY, INFINITY};
      int bi[2] = {INT_MAX, INT_MAX};
      for (int nt = 0; nt < P.ntiles; ++nt) {
        // acc: the tile's p.c, summed on the CUDA cores (round to nearest)
        // from each k16 step's six passes in part: the tensor cores' own
        // accumulation rounds toward zero, which over every step and pass
        // (96 adds at d = 250) biased d^2 high by ~50 ulps of p.c, and
        // tight clusters (d^2 << p.c) by 2.7e-5 of the cost
        float acc[kAcc], part[kAcc];
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[j] = part[j] = 0.f;
        // k16 steps over d; a new load (slot) at each chunk's first step:
        // the whole tile's for nt == 0 only, a chunk's for every nt
        int k0 = 0;  // the staged chunk's first feature
        for (int ks = 0; ks < P.ksteps; ++ks) {
          if (ks * 16 - k0 == P.kc) k0 += P.kc;  // never for a whole row (d > 16 (ksteps - 1))
          if (ks * 16 == k0 && (P.chunks > 1 || nt == 0)) {
            const int slot = pit % P.pslots;
            mbar_wait(&pfull[wg * P.pslots + slot], (pit / P.pslots) & 1);
            tile = reinterpret_cast<const float*>(pring + (long long)(wg * P.pslots + slot) *
                                                              P.tile_bytes);
          }
          // registers 0-3: (row g, k 2tq..), (row g + 8, k 2tq..),
          // (row g, k 2tq + 8..), (row g + 8, k 2tq + 8..); features past d
          // are zero
          uint32_t a[3][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int h = u & 1;
            const int k = ks * 16 + 2 * tq + (u >> 1) * 8;
            const float* row = tile + r[h] * P.kc;
            const float x0 = k < d ? row[k - k0] : 0.f;
            const float x1 = k + 1 < d ? row[k + 1 - k0] : 0.f;
            if (nt == 0) pn[h] = fmaf(x1, x1, fmaf(x0, x0, pn[h]));
            split_pair(x0, x1, a[0][u], a[1][u], a[2][u]);
          }
          const unsigned char* stage;
          int cs = 0;
          if (P.resident) {
            stage = cring + (nt * P.ksteps + ks) * cbytes;
          } else {
            cs = cit % P.cslots;
            mbar_wait(&cfull[cs], (cit / P.cslots) & 1);
            stage = cring + cs * cbytes;
          }
          const uint32_t at = smem_addr(stage);
          fence_regs<kAcc>(part);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int q = 0; q < 6; ++q)  // the first pass overwrites the step's part
            wgmma_rs<N>(part, a[point_piece(q)], b_desc(at + center_piece(q) * N * 32), q);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_regs<kAcc>(part);
#pragma unroll
          for (int j = 0; j < kAcc; ++j) acc[j] += part[j];
          if (!P.resident) {
            mbar_arrive(&cempty[cs]);
            ++cit;
          }
          if (P.chunks > 1 && ((ks + 1) * 16 - k0 == P.kc || ks + 1 == P.ksteps)) {
            bar_sync(bar, 128);  // the chunk is read: its slot is free
            if (wt == 0) mbar_arrive(&pempty[wg * P.pslots + pit % P.pslots]);
            ++pit;
          }
        }
        if (nt == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            pn[h] += __shfl_xor_sync(kFull, pn[h], 1);
            pn[h] += __shfl_xor_sync(kFull, pn[h], 2);
          }
        }
        // one copy of the argmin per place of |c|^2, so that each reads its
        // own memory directly
        if (P.k_global)
          argmin_tile<N>(acc, pn, S.cn, nt * N + 2 * tq, bd, bi);
        else
          argmin_tile<N>(acc, pn, cn_s, nt * N + 2 * tq, bd, bi);
      }
      // (the tile's arrays are addressed here, not held through the product)
      float* bestd_s = reinterpret_cast<float*>(base + P.bestd) + wg * kRows;
      int* besti_s = reinterpret_cast<int*>(base + P.besti) + wg * kRows;
      const long long t = t_begin + 2 * p + wg;
      const int nvalid = t < t_end ? (int)min((long long)kRows, n - t * kRows) : 0;
      // the quad's four threads hold the other centers of the same rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float v2 = __shfl_xor_sync(kFull, bd[h], o);
          const int i2 = __shfl_xor_sync(kFull, bi[h], o);
          if (v2 < bd[h] || (v2 == bd[h] && i2 < bi[h])) {
            bd[h] = v2;
            bi[h] = i2;
          }
        }
        if (bd[h] == -INFINITY) bd[h] = NAN;  // a NaN minimum: no center
        if (tq == 0) {
          bestd_s[r[h]] = bd[h];
          besti_s[r[h]] = bi[h];
          // max(m, 0) that keeps a NaN, as the TPU kernel's cost does
          if (r[h] < nvalid) cost_s[tid] += (double)(bd[h] < 0.f ? 0.f : bd[h]);
        }
      }
      bar_sync(bar, 128);
      if (G > 0) {
        add_rows_to_copies(tile, bestd_s, besti_s, nvalid, d, kp, G, wt,
                           acc_s + (long long)wg * G * kpd, cnt_s + wg * G * kp);
        bar_sync(bar, 128);  // the slot and the tile's arrays are free
        if (wt == 0) mbar_arrive(&pempty[wg * P.pslots + pit % P.pslots]);
        ++pit;
      } else {
        // the slab: both tiles of the pair sorted, then each warpgroup adds
        // both, in tile order, to its half of the columns of each load
        // (counts: each warpgroup its own tile's runs, by integer atomics)
        int* key_s = reinterpret_cast<int*>(base + P.key) + wg * kRows;
        int* order_s = reinterpret_cast<int*>(base + P.order) + wg * kRows;
        int* seg_s = reinterpret_cast<int*>(base + P.seg) + wg * (kRows + 8);
        sort_rows(bestd_s, besti_s, nvalid, key_s, order_s, seg_s, wt, bar);
        for (int ch = 0; ch < P.chunks; ++ch) {
          const int slot = pit % P.pslots;
          if (P.chunks > 1) mbar_wait(&pfull[wg * P.pslots + slot], (pit / P.pslots) & 1);
          bar_sync(kBarAll, kConsumers);  // both tiles' rows are staged and sorted
          if (ch == 0 && wt < seg_s[kRows]) {
            const int lo = seg_s[wt];
            const int hi = wt + 1 < seg_s[kRows] ? seg_s[wt + 1] : seg_s[kRows + 1];
            atomicAdd((P.k_global ? S.part_counts + (long long)blockIdx.x * kp : cnt_s) +
                          key_s[order_s[lo]],
                      hi - lo);
          }
          const int k0 = ch * P.kc, width = min(P.kc, d - k0);
          const int half = (width + 1) / 2;
          const int j_hi = min(width, (wg + 1) * half);
          for (int q = 0; q < kGroups; ++q) {
            const float* tq_tile = reinterpret_cast<const float*>(
                pring + (long long)(q * P.pslots + slot) * P.tile_bytes);
            const int* key_q = key_s + (q - wg) * kRows;
            const int* order_q = order_s + (q - wg) * kRows;
            const int* seg_q = seg_s + (q - wg) * (kRows + 8);
            if (N >= 128 && d % 2 == 0 && half % 2 == 0)
              add_runs_to_slab<4, 2>(tq_tile, P.kc, key_q, order_q, seg_q, d,
                                                    wg * half, j_hi, slab + k0, wt);
            else
              add_runs_to_slab<N >= 128 ? 8 : 4, 1>(tq_tile, P.kc, key_q, order_q, seg_q, d,
                                                    wg * half, j_hi, slab + k0, wt);
            bar_sync(bar, 128);  // a center of tile q + 1 may be another thread's in q
          }
          bar_sync(kBarAll, kConsumers);  // both slots are read
          if (wt == 0) mbar_arrive(&pempty[wg * P.pslots + slot]);
          ++pit;
        }
      }
    }
    bar_sync(kBarAll, kConsumers);
    // the CTA's partials: the accumulator copies summed in copy order (the
    // slab is the partials already; so are its counts when they are global)
    if (G == 0 && !P.k_global) {
      for (int c = tid; c < kp; c += kConsumers)
        S.part_counts[(long long)blockIdx.x * kp + c] = cnt_s[c];
    }
    if (G > 0) {
      for (long long e = tid; e < kpd; e += kConsumers) {
        double s = 0.0;
        for (int h = 0; h < kGroups * G; ++h) s += acc_s[h * kpd + e];
        slab[e] = s;
      }
      for (int c = tid; c < kp; c += kConsumers) {
        int s = 0;
        for (int h = 0; h < kGroups * G; ++h) s += cnt_s[h * kp + c];
        S.part_counts[(long long)blockIdx.x * kp + c] = s;
      }
    }
    if (tid == 0) {
      double s = 0.0;
      for (int i = 0; i < kConsumers; ++i) s += cost_s[i];
      S.part_cost[blockIdx.x] = s;
    }
  }
  // -- phase 2: the partials reduced over the CTAs, rounded to f32 once --------------
  grid_barrier(S.barrier, (P.resident ? 1u : 2u) * ctas);
  const long long outputs = kpd + kp + 1;
  auto part = [&](long long e, int b) -> double {
    if (e < kpd) return S.part_sums[(long long)b * kpd + e];
    if (e < kpd + kp) return (double)S.part_counts[(long long)b * kp + (e - kpd)];
    return S.part_cost[b];
  };
  auto put = [&](long long e, double s) {
    if (e < kpd)
      sums[e] = (float)s;
    else if (e < kpd + kp)
      counts[e - kpd] = (float)s;
    else
      cost[0] = (float)s;
  };
  const long long gtid = (long long)blockIdx.x * kThreads + tid;
  const long long gsize = (long long)ctas * kThreads;
  if (outputs * 32 <= gsize * 2) {
    // few outputs (small k * d): a warp each, lanes over the CTAs, a fixed tree
    const long long gwarp = gtid / 32, nwarps = gsize / 32;
    for (long long e = gwarp; e < outputs; e += nwarps) {
      double s = 0.0;
      for (int b = lane; b < ctas; b += 32) s += part(e, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) put(e, s);
    }
  } else {
    // a thread each, the CTAs in order (loads of neighbouring threads coalesce)
    for (long long e = gtid; e < outputs; e += gsize) {
      double s = 0.0;
#pragma unroll 8
      for (int b = 0; b < ctas; ++b) s += part(e, b);
      put(e, s);
    }
  }
}

// -- launches ------------------------------------------------------------------

struct Launch {
  Plan plan;
  int ctas, tiles_per_cta;
  long long scratch[7];  // byte offsets: barrier, stages, cn, sums, counts, cost, total
};

template <typename F>
int with_tile(int n, F f) {
  switch (n) {
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

// CTAs of sweep_kernel<N> that fit on one SM with smem bytes, and the
// SMs, asked of the card once per (device, N, smem) and kept; the first
// query of a kernel also sets its shared-memory attributes
int ctas_on_card(int N, int smem, int* sms) {
  struct Entry {
    int dev, n, smem, ctas, sms;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].n == N && cache[i].smem == smem) {
      *sms = cache[i].sms;
      return cache[i].ctas;
    }
  int per_sm = 0;
  if (cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  const int rc = with_tile(N, [&](auto tile) {
    auto kernel = sweep_kernel<decltype(tile)::value>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    return (int)err;
  });
  if (rc != 0) return 0;
  if (used < 64) cache[used++] = {dev, N, smem, per_sm, *sms};
  return per_sm;
}

// The plan, grid and scratch layout of one sweep over n points; ctas = 0
// when the shape does not fit.
Launch plan_launch(int kp, int d, long long n) {
  Launch L;
  memset(&L, 0, sizeof(L));
  L.plan = make_plan(kp, d);
  if (L.plan.smem == 0) return L;
  int sms = 0;
  const int per_sm = ctas_on_card(L.plan.N, L.plan.smem, &sms);
  if (per_sm < 1) return L;
  const long long tiles = (n + kRows - 1) / kRows;
  const long long room = (long long)per_sm * sms;
  long long per = tiles > 0 ? (tiles + min(tiles, room) - 1) / min(tiles, room) : 2;
  per += per & 1;  // whole pairs of tiles, one per warpgroup
  L.tiles_per_cta = (int)per;
  L.ctas = tiles > 0 ? (int)((tiles + per - 1) / per) : 1;
  const long long kpd = (long long)kp * d;
  const long long sizes[6] = {
      256, (long long)L.plan.cstages * stage_bytes(L.plan.N), 4LL * L.plan.ntiles * L.plan.N,
      8LL * L.ctas * kpd, 4LL * L.ctas * kp, 8LL * L.ctas};
  long long at = 0;
  for (int i = 0; i < 6; ++i) {
    L.scratch[i] = at;
    at += (sizes[i] + 255) / 256 * 256;
  }
  L.scratch[6] = at;
  return L;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch returns a CUDA error
// code (0 = success).
extern "C" {

// The sweep's plan for kp centers, d features and n points on the current
// device: info = {center tile N, center tiles, centers resident, features
// per staged point row (d, or a chunk), point slots per warpgroup, f64
// accumulator copies per warpgroup (0 = the global slab), dynamic shared
// memory bytes, CTAs, 64-point tiles per CTA}; returns the scratch bytes
// the sweep needs, or -1 when the card cannot run it.
long long kmeans_sweep_plan(int kp, int d, long long n, int* info) {
  const Launch L = plan_launch(kp, d, n);
  const int vals[9] = {L.plan.N,      L.plan.ntiles, L.plan.resident, L.plan.kc, L.plan.pslots,
                       L.plan.groups, L.plan.smem,   L.ctas,          L.tiles_per_cta};
  for (int i = 0; i < 9; ++i) info[i] = vals[i];
  return L.ctas > 0 ? L.scratch[6] : -1;
}

// One Lloyd sweep of the first n_items of points [n_rows, d] against
// centers [kp, d] (the first k_real real): sums [kp, d], counts [kp] and
// cost [1] f32. scratch holds kmeans_sweep_plan's bytes (any contents).
int kmeans_sweep(const float* pts, long long n_rows, int d, const float* ctr, int kp, int k_real,
                 long long n_items, void* scratch, long long scratch_bytes, float* sums,
                 float* counts, float* cost, void* stream) {
  if (d < 1 || kp < 1 || k_real < 1 || k_real > kp || n_rows < 0 || n_items < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = n_items < n_rows ? n_items : n_rows;
  const Launch L = plan_launch(kp, d, n);
  if (L.ctas < 1 || scratch_bytes < L.scratch[6] ||
      reinterpret_cast<uintptr_t>(scratch) % 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* sb = static_cast<unsigned char*>(scratch);
  Scratch S;
  S.barrier = reinterpret_cast<unsigned*>(sb + L.scratch[0]);
  S.stages = reinterpret_cast<__nv_bfloat16*>(sb + L.scratch[1]);
  S.cn = reinterpret_cast<float*>(sb + L.scratch[2]);
  S.part_sums = reinterpret_cast<double*>(sb + L.scratch[3]);
  S.part_counts = reinterpret_cast<int*>(sb + L.scratch[4]);
  S.part_cost = reinterpret_cast<double*>(sb + L.scratch[5]);
  cudaError_t err = cudaMemsetAsync(S.barrier, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  // bulk copies: whole tiles from a 16-byte aligned base, chunks of rows
  // also need rows of a multiple of 4 features
  int bulk = reinterpret_cast<uintptr_t>(pts) % 16 == 0 && (L.plan.chunks == 1 || d % 4 == 0);
  int tiles_per_cta = L.tiles_per_cta;
  Plan plan = L.plan;
  return with_tile(plan.N, [&](auto tile) {
    auto kernel = sweep_kernel<decltype(tile)::value>;
    void* args[] = {&pts, const_cast<long long*>(&n), &d, &ctr, &kp, &k_real,
                    &tiles_per_cta, &bulk, &plan, &S, &sums, &counts, &cost};
    const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(L.ctas), dim3(kThreads), args,
                                                      (size_t)plan.smem, st);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  });
}

}  // extern "C"
