// Concurrent hash-partitioned ID -> float32-vector store.
//
// The native serving/speed-layer hot-path state: the C++ counterpart of the
// reference's FeatureVectors (app/oryx-app-common/.../als/FeatureVectors
// .java:36-161 — a ConcurrentHashMap guarded by an AutoReadWriteLock) and of
// the hash-partitioned vector store inside ALSServingModel.java:58-124.
// Per SURVEY.md: "any remaining CPU-side hot path that genuinely needs it
// (e.g. the serving layer's concurrent hash-partitioned vector store) gets a
// C++ implementation bound into Python". Vectors live in per-shard
// contiguous slabs so packing a snapshot for device upload is a straight
// memcpy sweep, and readers take per-shard shared locks so lookups/scans run
// in parallel with writes to other shards (ctypes releases the GIL around
// every call).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <list>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Shard {
  mutable std::shared_mutex mu;
  std::unordered_map<std::string, int64_t> index;  // id -> slot
  std::vector<std::string> slot_ids;               // slot -> id ("" = free)
  std::vector<float> slab;                         // slot-major vector data
  std::vector<int64_t> free_slots;
  std::unordered_set<std::string> recent;
};

struct Store {
  int64_t dim;
  int64_t num_shards;
  std::vector<Shard> shards;

  Shard& shard_for(const std::string& id) {
    return shards[std::hash<std::string>{}(id) % num_shards];
  }
};

}  // namespace

extern "C" {

void* fs_create(int64_t dim, int64_t num_shards) {
  if (dim <= 0 || num_shards <= 0) return nullptr;
  auto* s = new Store();
  s->dim = dim;
  s->num_shards = num_shards;
  s->shards = std::vector<Shard>(num_shards);
  return s;
}

void fs_destroy(void* p) { delete static_cast<Store*>(p); }

int64_t fs_dim(void* p) { return static_cast<Store*>(p)->dim; }

void fs_set(void* p, const char* id, int64_t id_len, const float* vec) {
  auto* s = static_cast<Store*>(p);
  std::string key(id, id_len);
  Shard& sh = s->shard_for(key);
  std::unique_lock lock(sh.mu);
  auto it = sh.index.find(key);
  int64_t slot;
  if (it != sh.index.end()) {
    slot = it->second;
  } else if (!sh.free_slots.empty()) {
    slot = sh.free_slots.back();
    sh.free_slots.pop_back();
    sh.slot_ids[slot] = key;
    sh.index.emplace(key, slot);
  } else {
    slot = static_cast<int64_t>(sh.slot_ids.size());
    sh.slot_ids.push_back(key);
    sh.slab.resize(sh.slab.size() + s->dim);
    sh.index.emplace(key, slot);
  }
  std::memcpy(sh.slab.data() + slot * s->dim, vec, s->dim * sizeof(float));
  sh.recent.insert(key);
}

int fs_get(void* p, const char* id, int64_t id_len, float* out) {
  auto* s = static_cast<Store*>(p);
  std::string key(id, id_len);
  Shard& sh = s->shard_for(key);
  std::shared_lock lock(sh.mu);
  auto it = sh.index.find(key);
  if (it == sh.index.end()) return 0;
  std::memcpy(out, sh.slab.data() + it->second * s->dim, s->dim * sizeof(float));
  return 1;
}

void fs_remove(void* p, const char* id, int64_t id_len) {
  auto* s = static_cast<Store*>(p);
  std::string key(id, id_len);
  Shard& sh = s->shard_for(key);
  std::unique_lock lock(sh.mu);
  auto it = sh.index.find(key);
  if (it == sh.index.end()) {
    sh.recent.erase(key);
    return;
  }
  int64_t slot = it->second;
  sh.index.erase(it);
  sh.slot_ids[slot].clear();
  sh.free_slots.push_back(slot);
  sh.recent.erase(key);
}

int64_t fs_size(void* p) {
  auto* s = static_cast<Store*>(p);
  int64_t n = 0;
  for (auto& sh : s->shards) {
    std::shared_lock lock(sh.mu);
    n += static_cast<int64_t>(sh.index.size());
  }
  return n;
}

int64_t fs_recent_count(void* p) {
  auto* s = static_cast<Store*>(p);
  int64_t n = 0;
  for (auto& sh : s->shards) {
    std::shared_lock lock(sh.mu);
    n += static_cast<int64_t>(sh.recent.size());
  }
  return n;
}

// IDs cross the ABI as a length-prefixed stream: [u32 len][bytes]... — ids
// are arbitrary strings off the wire (JSON), so a newline/NUL-delimited
// protocol would corrupt the id<->row mapping for ids containing the
// delimiter.
static char* write_id(char* out, const std::string& id) {
  uint32_t len = static_cast<uint32_t>(id.size());
  std::memcpy(out, &len, sizeof(len));
  out += sizeof(len);
  std::memcpy(out, id.data(), id.size());
  return out + id.size();
}

static int64_t id_stream_size(const std::string& id) {
  return static_cast<int64_t>(sizeof(uint32_t) + id.size());
}

// Pack a consistent snapshot: all shard locks are held (shared) for the
// duration. Returns n on success, -1 when a buffer is too small (caller
// re-sizes from *mat_needed / *ids_needed and retries), with the needed
// capacities always reported.
int64_t fs_pack(void* p, float* mat_out, int64_t mat_cap, char* ids_out,
                int64_t ids_cap, int64_t* mat_needed, int64_t* ids_needed,
                int recent_only) {
  auto* s = static_cast<Store*>(p);
  std::vector<std::shared_lock<std::shared_mutex>> locks;
  locks.reserve(s->shards.size());
  for (auto& sh : s->shards) locks.emplace_back(sh.mu);

  int64_t n = 0, ids_len = 0;
  for (auto& sh : s->shards) {
    if (recent_only) {
      for (const auto& id : sh.recent) {
        if (sh.index.count(id)) {
          n++;
          ids_len += id_stream_size(id);
        }
      }
    } else {
      n += static_cast<int64_t>(sh.index.size());
      for (const auto& kv : sh.index) ids_len += id_stream_size(kv.first);
    }
  }
  *mat_needed = n * s->dim;
  *ids_needed = ids_len;
  if (n * s->dim > mat_cap || ids_len > ids_cap) return -1;

  int64_t row = 0;
  char* idp = ids_out;
  for (auto& sh : s->shards) {
    if (recent_only) {
      for (const auto& id : sh.recent) {
        auto it = sh.index.find(id);
        if (it == sh.index.end()) continue;
        std::memcpy(mat_out + row * s->dim, sh.slab.data() + it->second * s->dim,
                    s->dim * sizeof(float));
        idp = write_id(idp, id);
        row++;
      }
    } else {
      for (const auto& kv : sh.index) {
        std::memcpy(mat_out + row * s->dim, sh.slab.data() + kv.second * s->dim,
                    s->dim * sizeof(float));
        idp = write_id(idp, kv.first);
        row++;
      }
    }
  }
  return row;
}

// IDs only, without copying vector data (the /user/allIDs-style calls and
// rotation bookkeeping need just the key set).
int64_t fs_ids(void* p, char* ids_out, int64_t ids_cap, int64_t* ids_needed,
               int recent_only) {
  auto* s = static_cast<Store*>(p);
  std::vector<std::shared_lock<std::shared_mutex>> locks;
  locks.reserve(s->shards.size());
  for (auto& sh : s->shards) locks.emplace_back(sh.mu);

  int64_t n = 0, ids_len = 0;
  for (auto& sh : s->shards) {
    if (recent_only) {
      for (const auto& id : sh.recent) {
        if (sh.index.count(id)) {
          n++;
          ids_len += id_stream_size(id);
        }
      }
    } else {
      n += static_cast<int64_t>(sh.index.size());
      for (const auto& kv : sh.index) ids_len += id_stream_size(kv.first);
    }
  }
  *ids_needed = ids_len;
  if (ids_len > ids_cap) return -1;

  char* idp = ids_out;
  for (auto& sh : s->shards) {
    if (recent_only) {
      for (const auto& id : sh.recent) {
        if (sh.index.count(id)) idp = write_id(idp, id);
      }
    } else {
      for (const auto& kv : sh.index) idp = write_id(idp, kv.first);
    }
  }
  return n;
}

// V^T V over all vectors, accumulated in double (FeatureVectors.getVTV).
void fs_vtv(void* p, double* out) {
  auto* s = static_cast<Store*>(p);
  const int64_t k = s->dim;
  std::memset(out, 0, k * k * sizeof(double));
  for (auto& sh : s->shards) {
    std::shared_lock lock(sh.mu);
    for (const auto& kv : sh.index) {
      const float* v = sh.slab.data() + kv.second * k;
      for (int64_t i = 0; i < k; i++) {
        const double vi = v[i];
        double* row = out + i * k;
        for (int64_t j = i; j < k; j++) row[j] += vi * v[j];
      }
    }
  }
  for (int64_t i = 0; i < k; i++)
    for (int64_t j = 0; j < i; j++) out[i * k + j] = out[j * k + i];
}

// Rotation reconciliation (FeatureVectors.retainRecentAndIDs:131-136): keep
// ids present in the new model OR written since the last rotation, then
// reset recency. Ids arrive as (offsets[n+1], payload): id i is
// payload[offsets[i]..offsets[i+1]) — offsets build vectorized in numpy,
// unlike the per-id length-prefix packing this replaces.
void fs_retain(void* p, const int64_t* offs, const char* payload, int64_t n) {
  auto* s = static_cast<Store*>(p);
  std::unordered_set<std::string> keep_set;
  keep_set.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    keep_set.emplace(payload + offs[i], static_cast<size_t>(offs[i + 1] - offs[i]));
  }
  for (auto& sh : s->shards) {
    std::unique_lock lock(sh.mu);
    std::vector<std::string> drop;
    for (const auto& kv : sh.index) {
      if (!keep_set.count(kv.first) && !sh.recent.count(kv.first)) {
        drop.push_back(kv.first);
      }
    }
    for (const auto& id : drop) {
      auto it = sh.index.find(id);
      sh.slot_ids[it->second].clear();
      sh.free_slots.push_back(it->second);
      sh.index.erase(it);
    }
    sh.recent.clear();
  }
}

// Batched insert/update: ids as (offsets, payload), vectors mat[n][dim].
// Same slot logic as fs_set, but the whole batch runs without returning
// to Python — the speed layer's self-consume thread applies 100K+
// deltas/s through here (one ctypes fs_set per delta cost ~60us on a
// 1-core host; the batch call amortizes it away).
void fs_set_batch(void* p, const int64_t* offs, const char* payload,
                  int64_t n, const float* mat) {
  auto* s = static_cast<Store*>(p);
  std::string key;
  for (int64_t i = 0; i < n; ++i) {
    key.assign(payload + offs[i], static_cast<size_t>(offs[i + 1] - offs[i]));
    Shard& sh = s->shard_for(key);
    std::unique_lock lock(sh.mu);
    auto it = sh.index.find(key);
    int64_t slot;
    if (it != sh.index.end()) {
      slot = it->second;
    } else if (!sh.free_slots.empty()) {
      slot = sh.free_slots.back();
      sh.free_slots.pop_back();
      sh.slot_ids[slot] = key;
      sh.index.emplace(key, slot);
    } else {
      slot = static_cast<int64_t>(sh.slot_ids.size());
      sh.slot_ids.push_back(key);
      sh.slab.resize(sh.slab.size() + s->dim);
      sh.index.emplace(key, slot);
    }
    std::memcpy(sh.slab.data() + slot * s->dim, mat + i * s->dim,
                s->dim * sizeof(float));
    sh.recent.insert(key);
  }
}

// Batched lookup: ids as (offsets, payload), vectors written to
// out_mat[n][dim] (rows for missing ids left untouched), out_valid[i]
// set 1/0. One lock acquisition per id, no Python between lookups —
// the speed layer fetches every event's user+item vector in one call.
int64_t fs_get_batch(void* p, const int64_t* offs, const char* payload,
                     int64_t n, float* out_mat, uint8_t* out_valid) {
  auto* s = static_cast<Store*>(p);
  std::string key;
  for (int64_t i = 0; i < n; ++i) {
    key.assign(payload + offs[i], static_cast<size_t>(offs[i + 1] - offs[i]));
    Shard& sh = s->shard_for(key);
    std::shared_lock lock(sh.mu);
    auto it = sh.index.find(key);
    if (it == sh.index.end()) {
      out_valid[i] = 0;
    } else {
      std::memcpy(out_mat + i * s->dim, sh.slab.data() + it->second * s->dim,
                  s->dim * sizeof(float));
      out_valid[i] = 1;
    }
  }
  return n;
}

// Format n rows of float32 [n][k] as JSON number arrays "[v,v,...]" with
// %.9g (shortest round-trip for float32 needs <= 9 significant digits).
// Rows are written back-to-back; offsets[i]..offsets[i+1] bounds row i.
// Returns total bytes, or -1 if cap is too small (needed reported).
// This is the speed layer's update-serialization hot path: Python's json
// encoder spends ~1us per float printing 17-digit float64 reprs.
int64_t json_format_vectors(const float* mat, int64_t n, int64_t k,
                            char* out, int64_t cap, int64_t* offsets,
                            int64_t* needed) {
  // worst case per float: sign + 9 digits + '.' + 'e+38' + ',' ~ 18 bytes
  int64_t worst = n * (2 + k * 18);
  *needed = worst;
  if (cap < worst) return -1;
  char* w = out;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = w - out;
    *w++ = '[';
    const float* row = mat + i * k;
    for (int64_t j = 0; j < k; ++j) {
      if (j) *w++ = ',';
      double v = static_cast<double>(row[j]);
      int len = snprintf(w, 32, "%.9g", v);
      // JSON has no Infinity/NaN literals; clamp to 0 like a poisoned
      // update would be dropped downstream anyway
      if (!std::isfinite(v)) {
        len = snprintf(w, 32, "0");
      }
      w += len;
    }
    *w++ = ']';
  }
  offsets[n] = w - out;
  return w - out;
}

// --- speed-layer update-message assembly -----------------------------------
//
// Emit complete update-topic messages ["X"|"Y", id, [v,...], [otherId]]
// (ALSSpeedModelManager.toUpdateJSON wire format) for n rows at once,
// formatted in parallel across threads. Rows are written into fixed-
// stride per-row regions of `out` (so threads never contend); true
// bounds come back via starts[i]/ends[i]. Gaps between rows are
// space-filled so the caller may decode the whole buffer as ASCII.

namespace {

inline char* json_escape_append(char* w, const char* s, uint32_t len) {
  *w++ = '"';
  for (uint32_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    if (c == '"' || c == '\\') {
      *w++ = '\\';
      *w++ = static_cast<char>(c);
    } else if (c < 0x20) {
      w += snprintf(w, 8, "\\u%04x", c);
    } else {
      *w++ = static_cast<char>(c);  // UTF-8 bytes pass through
    }
  }
  *w++ = '"';
  return w;
}

// 10^k for k in [-30, 53]: covers scaling any finite float32 (decimal
// exponent -45..38) into the nine-digit window [1e8, 1e9).
static const double kPow10[84] = {
    1e-30, 1e-29, 1e-28, 1e-27, 1e-26, 1e-25, 1e-24, 1e-23, 1e-22, 1e-21,
    1e-20, 1e-19, 1e-18, 1e-17, 1e-16, 1e-15, 1e-14, 1e-13, 1e-12, 1e-11,
    1e-10, 1e-9,  1e-8,  1e-7,  1e-6,  1e-5,  1e-4,  1e-3,  1e-2,  1e-1,
    1e0,   1e1,   1e2,   1e3,   1e4,   1e5,   1e6,   1e7,   1e8,   1e9,
    1e10,  1e11,  1e12,  1e13,  1e14,  1e15,  1e16,  1e17,  1e18,  1e19,
    1e20,  1e21,  1e22,  1e23,  1e24,  1e25,  1e26,  1e27,  1e28,  1e29,
    1e30,  1e31,  1e32,  1e33,  1e34,  1e35,  1e36,  1e37,  1e38,  1e39,
    1e40,  1e41,  1e42,  1e43,  1e44,  1e45,  1e46,  1e47,  1e48,  1e49,
    1e50,  1e51,  1e52,  1e53,
};
static inline double pow10tab(int k) { return kPow10[k + 30]; }

static char* float_append_9g(char* w, float f) {
  if (f == 0.0f) {
    if (std::signbit(f)) *w++ = '-';
    *w++ = '0';
    return w;
  }
  double d = static_cast<double>(f);
  if (d < 0.0) {
    *w++ = '-';
    d = -d;
  }
  // e10 = floor(log10(d)): estimate from the binary exponent (floor(e2 *
  // log10 2) is off by at most one, always low), confirm by comparison
  uint64_t bits;
  std::memcpy(&bits, &d, 8);
  int e2 = static_cast<int>((bits >> 52) & 0x7FF) - 1023;  // d is a normal double
  int e10 = static_cast<int>((e2 * 315653) >> 20);         // 315653/2^20 ~= log10(2)
  if (e10 < -45) e10 = -45;                                // clamp for table safety
  if (d >= pow10tab(e10 + 1)) ++e10;
  double scaled = d * pow10tab(8 - e10);
  // inexact power-of-ten boundaries can land one decade off; renormalize
  if (scaled >= 1e9) {
    ++e10;
    scaled = d * pow10tab(8 - e10);
  } else if (scaled < 1e8) {
    --e10;
    scaled = d * pow10tab(8 - e10);
  }
  uint64_t n = static_cast<uint64_t>(std::llround(scaled));
  if (n >= 1000000000ull) {  // 999999999.6 rounded up a decade
    n /= 10;
    ++e10;
  }
  int nd = 9;
  while (nd > 1 && n % 10 == 0) {  // %g strips trailing zeros
    n /= 10;
    --nd;
  }
  char digs[10];
  auto res = std::to_chars(digs, digs + sizeof digs, n);  // integral: always available
  int len = static_cast<int>(res.ptr - digs);
  if (e10 >= -4 && e10 < 9) {  // %g fixed notation band for precision 9
    if (e10 >= len - 1) {
      std::memcpy(w, digs, static_cast<size_t>(len));
      w += len;
      for (int i = len - 1; i < e10; ++i) *w++ = '0';
    } else if (e10 >= 0) {
      std::memcpy(w, digs, static_cast<size_t>(e10 + 1));
      w += e10 + 1;
      *w++ = '.';
      std::memcpy(w, digs + e10 + 1, static_cast<size_t>(len - e10 - 1));
      w += len - e10 - 1;
    } else {
      *w++ = '0';
      *w++ = '.';
      for (int i = 0; i < -e10 - 1; ++i) *w++ = '0';
      std::memcpy(w, digs, static_cast<size_t>(len));
      w += len;
    }
    return w;
  }
  *w++ = digs[0];  // scientific: d[.ddd]e{+,-}XX
  if (len > 1) {
    *w++ = '.';
    std::memcpy(w, digs + 1, static_cast<size_t>(len - 1));
    w += len - 1;
  }
  *w++ = 'e';
  *w++ = e10 < 0 ? '-' : '+';
  int ae = e10 < 0 ? -e10 : e10;
  *w++ = static_cast<char>('0' + ae / 10);  // decimal exponent is 2 digits (<= 45)
  *w++ = static_cast<char>('0' + ae % 10);
  return w;
}

// Shortest round-trip decimal (Ryu via std::to_chars on the FLOAT
// overload — the same contract as Java's Float.toString, which is what
// the reference's toUpdateJSON emits). Averages ~8 chars/component vs 12
// for fixed 9-significant-digit forms: the update topic is the speed
// layer's dominant byte stream, so this is both a format-parity and an
// I/O-bandwidth win.
inline char* float_append(char* w, float f) {
  if (!std::isfinite(f)) {
    *w++ = '0';  // JSON has no NaN/Infinity literals
    return w;
  }
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto res = std::to_chars(w, w + 32, f);
  return res.ptr;
#else
  // libstdc++ < 11 has no floating-point to_chars. snprintf("%.9g") costs
  // ~250ns per component, which at 50 components x ~60K updates per
  // micro-batch is the single largest line item in the publish stage — so
  // the fallback is a hand-rolled 9-significant-digit %g-equivalent
  // (~30ns): scale into [1e8, 1e9), round to a 9-digit integer, strip
  // trailing zeros, lay the digits out under printf %g placement rules.
  //
  // Round-trip safety: the scaled value carries <= ~1e-6 units of error
  // (one table lookup + one multiply, each 0.5 ulp of a double), so the
  // emitted 9-digit decimal sits within 0.51 units of the exact value,
  // while adjacent float32s are >= 5.9 units apart at the tightest point
  // (2^-24 relative spacing against 1e-9 relative resolution) — parsing
  // always recovers the original float. Divergence from glibc %.9g is
  // possible only on exact decimal ties (glibc rounds half-to-even, this
  // rounds half-away, e.g. 1048576.625f) — both forms round-trip, and
  // self-apply byte-exact skip only ever compares bytes from one build.
  return float_append_9g(w, f);
#endif
}

}  // namespace

// Per-row worst case for als_format_updates' fixed stride.
int64_t als_update_row_cap(int64_t k, int64_t max_id_len) {
  return 16 + 2 * (6 * max_id_len + 2) + 2 + k * 18;
}

// Shared scaffold for the update formatters: each thread writes its rows
// back-to-back inside its own stride-spaced region, then regions compact
// into one contiguous byte run (row offsets shifted). write_row appends
// row i at w and returns the new write head. Returns total bytes.
static int64_t format_rows_parallel(
    int64_t n, int64_t stride, char* out, int64_t* starts, int64_t* ends,
    int64_t num_threads, const std::function<char*(int64_t, char*)>& write_row) {
  if (n == 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  std::vector<int64_t> region_end(num_threads, 0);
  auto worker = [&](int64_t t, int64_t lo, int64_t hi) {
    char* w = out + lo * stride;
    for (int64_t i = lo; i < hi; ++i) {
      starts[i] = w - out;
      w = write_row(i, w);
      ends[i] = w - out;
    }
    region_end[t] = w - out;
  };
  if (num_threads == 1) {
    worker(0, 0, n);
    return region_end[0];
  }
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, t, lo, hi);
  }
  int64_t used_threads = static_cast<int64_t>(threads.size());
  for (auto& th : threads) th.join();
  // compact regions into one contiguous run, shifting row offsets
  int64_t dst = region_end[0];
  for (int64_t t = 1; t < used_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    int64_t src = lo * stride;
    int64_t len = region_end[t] - src;
    std::memmove(out + dst, out + src, static_cast<size_t>(len));
    int64_t delta = dst - src;
    for (int64_t i = lo; i < hi; ++i) {
      starts[i] += delta;
      ends[i] += delta;
    }
    dst += len;
  }
  return dst;
}

// ["T","id",[v..]] row prefix shared by both formatter variants.
static char* append_row_head(char* w, char matrix_tag, const float* row,
                             int64_t k, const int64_t* id_offs,
                             const char* id_payload, int64_t i) {
  *w++ = '[';
  *w++ = '"';
  *w++ = matrix_tag;
  *w++ = '"';
  *w++ = ',';
  w = json_escape_append(w, id_payload + id_offs[i],
                         static_cast<uint32_t>(id_offs[i + 1] - id_offs[i]));
  *w++ = ',';
  *w++ = '[';
  for (int64_t j = 0; j < k; ++j) {
    if (j) *w++ = ',';
    w = float_append(w, row[j]);
  }
  *w++ = ']';
  return w;
}

// matrix_tag: 'X' or 'Y'. ids/other_ids arrive as (offsets[n+1], payload)
// pairs. include_known: emit the trailing [otherId] element. out must hold
// n * als_update_row_cap(k, max_id_len) bytes.
int64_t als_format_updates(const float* mat, int64_t n, int64_t k,
                           const int64_t* id_offs, const char* id_payload,
                           const int64_t* other_offs, const char* other_payload,
                           char matrix_tag, int include_known,
                           int64_t max_id_len, char* out,
                           int64_t* starts, int64_t* ends, int64_t num_threads) {
  const int64_t stride = als_update_row_cap(k, max_id_len);
  return format_rows_parallel(
      n, stride, out, starts, ends, num_threads, [&](int64_t i, char* w) {
        w = append_row_head(w, matrix_tag, mat + i * k, k, id_offs, id_payload, i);
        if (include_known) {
          *w++ = ',';
          *w++ = '[';
          w = json_escape_append(
              w, other_payload + other_offs[i],
              static_cast<uint32_t>(other_offs[i + 1] - other_offs[i]));
          *w++ = ']';
        }
        *w++ = ']';
        return w;
      });
}

// Multi-known variant: row i carries the known-id list
// known_ids[known_row_offs[i] .. known_row_offs[i+1]) where each known id
// j is known_payload[known_offs[j] .. known_offs[j+1]). Emits
// ["T","id",[v..],["k1","k2",...]] (empty list allowed). The caller
// supplies the per-row stride (worst case including its widest known list).
int64_t als_format_updates_multi(
    const float* mat, int64_t n, int64_t k,
    const int64_t* id_offs, const char* id_payload,
    const int64_t* known_row_offs, const int64_t* known_offs,
    const char* known_payload, char matrix_tag, int64_t stride,
    char* out, int64_t* starts, int64_t* ends, int64_t num_threads) {
  return format_rows_parallel(
      n, stride, out, starts, ends, num_threads, [&](int64_t i, char* w) {
        w = append_row_head(w, matrix_tag, mat + i * k, k, id_offs, id_payload, i);
        *w++ = ',';
        *w++ = '[';
        for (int64_t g = known_row_offs[i]; g < known_row_offs[i + 1]; ++g) {
          if (g > known_row_offs[i]) *w++ = ',';
          w = json_escape_append(
              w, known_payload + known_offs[g],
              static_cast<uint32_t>(known_offs[g + 1] - known_offs[g]));
        }
        *w++ = ']';
        *w++ = ']';
        return w;
      });
}

// Parse a comma-separated run of decimal floats ("1.5,-2,3e-4,nan") into
// out[cap]. Returns the count parsed, or -1 on a malformed token — the
// caller falls back to numpy/per-record parsing. This is the speed
// layer's self-consume hot path: a 50-feature UP delta block at 100K+
// deltas/s is ~10M float tokens/batch, and numpy's S->float astype costs
// ~160ns/token on one core vs ~30ns for a bare strtof loop.
int64_t parse_float_csv(const char* buf, int64_t len, float* out, int64_t cap) {
  // std::from_chars: locale-free and ~3x strtof — this parse is the
  // speed layer's per-delta floor when re-applying its own update topic
  const char* p = buf;
  const char* end = buf + len;
  int64_t n = 0;
  if (len == 0) return 0;
  while (p < end) {
    if (n >= cap) return -1;
    // from_chars (unlike the strtof it replaced) rejects leading spaces;
    // tolerate them so json.dumps-style "a, b" fallback formatting stays
    // on the fast path
    while (p < end && *p == ' ') ++p;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    auto [next, ec] = std::from_chars(p, end, out[n]);
    if (ec != std::errc() || next == p) return -1;  // malformed token
    ++n;
    p = next;
#else
    // libstdc++ < 11: bounded strtof on a stack copy (the buffer from
    // Python is NUL-terminated, but don't rely on it)
    char tok[64];
    const char* stop = static_cast<const char*>(memchr(p, ',', end - p));
    if (stop == nullptr) stop = end;
    size_t tlen = static_cast<size_t>(stop - p);
    if (tlen == 0 || tlen >= sizeof(tok)) return -1;
    memcpy(tok, p, tlen);
    tok[tlen] = '\0';
    char* tend = nullptr;
    out[n] = strtof(tok, &tend);
    if (tend != tok + tlen) return -1;  // malformed token
    ++n;
    p = stop;
#endif
    if (p < end) {
      if (*p != ',') return -1;
      ++p;
    }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tiered cell store (ts_*): the RAM->disk half of the serving layer's
// three-tier item plane (docs/serving-scan.md). Cell blocks — the
// cell-contiguous f32 slabs the IVF host scan gathers — live in one
// append-only backing file mmap'd as the COLD tier; a byte-budgeted LRU
// of malloc'd copies is the WARM tier; the HOT (device/HBM-standing)
// tier is the Python-side ndarray cache in native/store.py. Reads promote
// (disk -> RAM) and count hit/miss; ts_prefetch enqueues cells for a
// background thread so probed cells stream RAM-ward ahead of the scan —
// GIL-free, since ctypes releases the GIL around every call.
// ---------------------------------------------------------------------------

namespace {

struct TierStore {
  std::string path;
  int fd = -1;

  // cell table + mapping, under one shared mutex (writes are rare: the
  // maintainer re-tiers after compaction; reads/promotes dominate)
  mutable std::shared_mutex mu;
  struct CellRef {
    int64_t off = -1;
    int64_t bytes = 0;
  };
  std::vector<CellRef> cells;
  int64_t file_bytes = 0;
  uint8_t* map = nullptr;
  int64_t map_bytes = 0;

  // warm tier: cell id -> heap copy, LRU-evicted under a byte budget
  std::mutex ram_mu;
  std::unordered_map<int64_t, std::vector<uint8_t>> ram;
  std::list<int64_t> lru;  // front = most recently touched
  std::unordered_map<int64_t, std::list<int64_t>::iterator> lru_pos;
  int64_t ram_budget = 0;
  int64_t ram_bytes = 0;

  std::atomic<int64_t> hits{0};
  std::atomic<int64_t> misses{0};
  std::atomic<int64_t> promotions{0};
  std::atomic<int64_t> demotions{0};

  // prefetch worker
  std::thread worker;
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<int64_t> queue;
  bool stop = false;
};

// caller holds no locks; copies cell bytes out of the mmap (growing the
// mapping first if the cell was appended after the last map). Returns
// bytes copied or -1.
int64_t tier_disk_read(TierStore* t, int64_t cell, uint8_t* out, int64_t cap) {
  std::shared_lock rlock(t->mu);
  if (cell < 0 || cell >= static_cast<int64_t>(t->cells.size())) return -1;
  TierStore::CellRef ref = t->cells[cell];
  if (ref.off < 0) return -1;
  if (ref.bytes > cap) return -1;
  if (ref.off + ref.bytes > t->map_bytes) {
    rlock.unlock();
    std::unique_lock wlock(t->mu);
    if (ref.off + ref.bytes > t->map_bytes) {  // re-check under the write lock
      if (t->map != nullptr) munmap(t->map, t->map_bytes);
      t->map = nullptr;
      t->map_bytes = 0;
      void* m = mmap(nullptr, t->file_bytes, PROT_READ, MAP_SHARED, t->fd, 0);
      if (m == MAP_FAILED) return -1;
      t->map = static_cast<uint8_t*>(m);
      t->map_bytes = t->file_bytes;
    }
    std::memcpy(out, t->map + ref.off, ref.bytes);
    return ref.bytes;
  }
  std::memcpy(out, t->map + ref.off, ref.bytes);
  return ref.bytes;
}

// promote a cell into the warm tier (no-op if present); evicts LRU tail
// cells past the byte budget. Returns 1 if the cell is RAM-resident on
// exit.
int tier_promote(TierStore* t, int64_t cell) {
  {
    std::lock_guard g(t->ram_mu);
    auto it = t->ram.find(cell);
    if (it != t->ram.end()) {
      auto pos = t->lru_pos.find(cell);
      t->lru.erase(pos->second);
      t->lru.push_front(cell);
      pos->second = t->lru.begin();
      return 1;
    }
  }
  int64_t bytes;
  {
    std::shared_lock rlock(t->mu);
    if (cell < 0 || cell >= static_cast<int64_t>(t->cells.size())) return 0;
    bytes = t->cells[cell].bytes;
    if (t->cells[cell].off < 0) return 0;
  }
  if (bytes > t->ram_budget) return 0;  // would evict everything: skip
  std::vector<uint8_t> buf(bytes);
  if (tier_disk_read(t, cell, buf.data(), bytes) != bytes) return 0;
  std::lock_guard g(t->ram_mu);
  if (t->ram.count(cell)) return 1;  // raced another promote: keep theirs
  while (t->ram_bytes + bytes > t->ram_budget && !t->lru.empty()) {
    int64_t victim = t->lru.back();
    t->lru.pop_back();
    t->lru_pos.erase(victim);
    auto vit = t->ram.find(victim);
    t->ram_bytes -= static_cast<int64_t>(vit->second.size());
    t->ram.erase(vit);
    t->demotions.fetch_add(1, std::memory_order_relaxed);
  }
  t->ram_bytes += bytes;
  t->ram.emplace(cell, std::move(buf));
  t->lru.push_front(cell);
  t->lru_pos[cell] = t->lru.begin();
  t->promotions.fetch_add(1, std::memory_order_relaxed);
  return 1;
}

void tier_worker(TierStore* t) {
  for (;;) {
    int64_t cell;
    {
      std::unique_lock lk(t->q_mu);
      t->q_cv.wait(lk, [t] { return t->stop || !t->queue.empty(); });
      if (t->stop) return;
      cell = t->queue.front();
      t->queue.pop_front();
    }
    tier_promote(t, cell);
  }
}

}  // namespace

extern "C" {

void* ts_create(const char* dir, int64_t dir_len, int64_t n_cells,
                int64_t ram_budget_bytes) {
  if (n_cells <= 0 || ram_budget_bytes < 0) return nullptr;
  auto* t = new TierStore();
  t->path = std::string(dir, dir_len) + "/cells.bin";
  t->fd = open(t->path.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (t->fd < 0) {
    delete t;
    return nullptr;
  }
  t->cells.resize(n_cells);
  t->ram_budget = ram_budget_bytes;
  t->worker = std::thread(tier_worker, t);
  return t;
}

void ts_destroy(void* p) {
  auto* t = static_cast<TierStore*>(p);
  if (t == nullptr) return;
  {
    std::lock_guard lk(t->q_mu);
    t->stop = true;
  }
  t->q_cv.notify_all();
  if (t->worker.joinable()) t->worker.join();
  if (t->map != nullptr) munmap(t->map, t->map_bytes);
  if (t->fd >= 0) {
    close(t->fd);
    unlink(t->path.c_str());
  }
  delete t;
}

// Append a cell block to the cold tier (the backing file). Rewriting a
// cell appends fresh bytes and abandons the old extent — compaction
// replaces the whole store, so the file never accretes past one
// generation of churn. Returns 0, or -1 on I/O failure.
int64_t ts_put_cell(void* p, int64_t cell, const uint8_t* data,
                    int64_t nbytes) {
  auto* t = static_cast<TierStore*>(p);
  if (cell < 0 || nbytes < 0) return -1;
  std::unique_lock wlock(t->mu);
  if (cell >= static_cast<int64_t>(t->cells.size())) return -1;
  int64_t off = t->file_bytes;
  int64_t done = 0;
  while (done < nbytes) {
    ssize_t w = pwrite(t->fd, data + done, nbytes - done, off + done);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return -1;
    }
    done += w;
  }
  t->cells[cell] = {off, nbytes};
  t->file_bytes = off + nbytes;
  // drop any stale warm copy (readers must see the new bytes)
  std::lock_guard g(t->ram_mu);
  auto it = t->ram.find(cell);
  if (it != t->ram.end()) {
    t->ram_bytes -= static_cast<int64_t>(it->second.size());
    t->ram.erase(it);
    auto pos = t->lru_pos.find(cell);
    t->lru.erase(pos->second);
    t->lru_pos.erase(pos);
  }
  return 0;
}

int64_t ts_cell_bytes(void* p, int64_t cell) {
  auto* t = static_cast<TierStore*>(p);
  std::shared_lock rlock(t->mu);
  if (cell < 0 || cell >= static_cast<int64_t>(t->cells.size())) return -1;
  if (t->cells[cell].off < 0) return -1;
  return t->cells[cell].bytes;
}

// Read a cell into out[cap]: warm tier first (hit), else the mmap'd cold
// tier (miss) with promotion so the next probe of this cell is a hit.
// Returns bytes copied, or -1 (unknown cell / cap too small).
int64_t ts_read_cell(void* p, int64_t cell, uint8_t* out, int64_t cap) {
  auto* t = static_cast<TierStore*>(p);
  {
    std::lock_guard g(t->ram_mu);
    auto it = t->ram.find(cell);
    if (it != t->ram.end()) {
      int64_t bytes = static_cast<int64_t>(it->second.size());
      if (bytes > cap) return -1;
      std::memcpy(out, it->second.data(), bytes);
      auto pos = t->lru_pos.find(cell);
      t->lru.erase(pos->second);
      t->lru.push_front(cell);
      pos->second = t->lru.begin();
      t->hits.fetch_add(1, std::memory_order_relaxed);
      return bytes;
    }
  }
  int64_t bytes = tier_disk_read(t, cell, out, cap);
  if (bytes < 0) return -1;
  t->misses.fetch_add(1, std::memory_order_relaxed);
  tier_promote(t, cell);
  return bytes;
}

// Queue cells for background disk->RAM promotion; returns the number
// actually enqueued (RAM-resident cells are skipped).
int64_t ts_prefetch(void* p, const int64_t* cells, int64_t n) {
  auto* t = static_cast<TierStore*>(p);
  int64_t queued = 0;
  {
    std::lock_guard g(t->ram_mu);
    std::lock_guard lk(t->q_mu);
    for (int64_t i = 0; i < n; ++i) {
      if (t->ram.count(cells[i])) continue;
      t->queue.push_back(cells[i]);
      ++queued;
    }
  }
  if (queued) t->q_cv.notify_all();
  return queued;
}

// Per-cell residency: 0 = no data, 1 = disk only, 2 = RAM. Returns the
// cell count written (min(n_cells, cap)).
int64_t ts_residency(void* p, int64_t* out, int64_t cap) {
  auto* t = static_cast<TierStore*>(p);
  std::shared_lock rlock(t->mu);
  std::lock_guard g(t->ram_mu);
  int64_t n = std::min<int64_t>(t->cells.size(), cap);
  for (int64_t c = 0; c < n; ++c) {
    if (t->cells[c].off < 0)
      out[c] = 0;
    else
      out[c] = t->ram.count(c) ? 2 : 1;
  }
  return n;
}

// out8 = [ram_cells, disk_cells, hits, misses, promotions, demotions,
//         ram_bytes, prefetch_queue_len]
void ts_stats(void* p, int64_t* out8) {
  auto* t = static_cast<TierStore*>(p);
  int64_t disk = 0;
  {
    std::shared_lock rlock(t->mu);
    for (const auto& c : t->cells)
      if (c.off >= 0) ++disk;
  }
  {
    std::lock_guard g(t->ram_mu);
    out8[0] = static_cast<int64_t>(t->ram.size());
    out8[6] = t->ram_bytes;
  }
  out8[1] = disk;
  out8[2] = t->hits.load(std::memory_order_relaxed);
  out8[3] = t->misses.load(std::memory_order_relaxed);
  out8[4] = t->promotions.load(std::memory_order_relaxed);
  out8[5] = t->demotions.load(std::memory_order_relaxed);
  std::lock_guard lk(t->q_mu);
  out8[7] = static_cast<int64_t>(t->queue.size());
}

// Demote a cell out of the warm tier (tests drive eviction directly).
void ts_drop_ram(void* p, int64_t cell) {
  auto* t = static_cast<TierStore*>(p);
  std::lock_guard g(t->ram_mu);
  auto it = t->ram.find(cell);
  if (it == t->ram.end()) return;
  t->ram_bytes -= static_cast<int64_t>(it->second.size());
  t->ram.erase(it);
  auto pos = t->lru_pos.find(cell);
  t->lru.erase(pos->second);
  t->lru_pos.erase(pos);
  t->demotions.fetch_add(1, std::memory_order_relaxed);
}

}  // extern "C"
