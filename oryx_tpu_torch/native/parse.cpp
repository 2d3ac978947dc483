// Columnar text-frame parser for the speed layer's KIND_TEXT control path.
//
// Input is the fixed-width S-array buffer a decoded RecordBlock holds: n
// rows of `width` bytes, each a `user,item,value[,timestamp]` line padded
// with trailing NULs. One GIL-released pass turns the block into typed
// u-i32 / i-i32 / v-f32 / ts-i64 columns plus the shared id prefixes —
// the same columns a typed KIND_COLS frame would have carried, feeding
// rating_matrix_from_int_columns directly.
//
// Parity contract (tests/native/test_native_parse.py): the parser either
// produces columns BIT-IDENTICAL to app/als/data.py's Python path, or
// returns -1 and the caller falls back to Python for the whole block. It
// therefore accepts only the strict canonical grammar it can reproduce
// exactly:
//   - ids are <ascii-prefix><canonical int32 decimal> (no leading zeros,
//     prefix uniform across the block, printable ASCII, <= 15 bytes) —
//     exactly the strings "u%d" re-rendering round-trips;
//   - values/timestamps are plain decimal floats (optional sign, dot,
//     exponent), parsed strtod -> double -> (float|int64) cast, matching
//     numpy's astype(f64).astype(f32|i64); empty value = NaN delete
//     marker, missing/empty timestamp = 0;
//   - anything else — quotes, JSON lines, >3 commas, non-ascii ids,
//     truncated/malformed rows, out-of-range numbers — rejects the whole
//     block so Python's slow paths (and its ValueError on <3 fields)
//     stay authoritative.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxPrefix = 15;
constexpr int kMaxNumber = 63;

inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }

// prefix bytes must round-trip ("u%d" % id == original): printable ascii,
// never a digit (the digit run must be maximal), a field comma, a quote
// (Python whole-block slow path) or a backslash (wire-escape ambiguity)
inline bool prefix_byte_ok(unsigned char c) {
  return c >= 0x20 && c <= 0x7e && !is_digit(c) && c != ',' && c != '"' &&
         c != '\\';
}

// <prefix><canonical-decimal-int32>: returns false when the field cannot
// round-trip bit-identically through the int fast path
bool parse_id(const char* p, const char* e, const char** pfx, int* pfx_len,
              int32_t* out) {
  const char* q = p;
  while (q < e && !is_digit((unsigned char)*q)) {
    if (!prefix_byte_ok((unsigned char)*q)) return false;
    ++q;
  }
  if (q == e || q - p > kMaxPrefix) return false;
  *pfx = p;
  *pfx_len = (int)(q - p);
  const char* d = q;
  while (q < e && is_digit((unsigned char)*q)) ++q;
  if (q != e) return false;  // trailing junk after the digit run
  int64_t ndig = q - d;
  if (ndig > 10) return false;
  if (*d == '0' && ndig > 1) return false;  // leading zero: "%d" won't round-trip
  int64_t v = 0;
  for (const char* c = d; c < q; ++c) v = v * 10 + (*c - '0');
  if (v > INT32_MAX) return false;
  *out = (int32_t)v;
  return true;
}

// strict decimal-float grammar: a subset of what strtod/numpy accept, so
// accepted fields parse to the identical double on both sides
bool float_grammar_ok(const char* p, const char* e) {
  if (p < e && (*p == '+' || *p == '-')) ++p;
  const char* int_start = p;
  while (p < e && is_digit((unsigned char)*p)) ++p;
  bool have_digits = p > int_start;
  if (p < e && *p == '.') {
    ++p;
    const char* frac_start = p;
    while (p < e && is_digit((unsigned char)*p)) ++p;
    have_digits = have_digits || p > frac_start;
  }
  if (!have_digits) return false;
  if (p < e && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < e && (*p == '+' || *p == '-')) ++p;
    const char* exp_start = p;
    while (p < e && is_digit((unsigned char)*p)) ++p;
    if (p == exp_start) return false;
  }
  return p == e;
}

bool parse_double(const char* p, const char* e, double* out) {
  if (e - p > kMaxNumber || !float_grammar_ok(p, e)) return false;
  char tmp[kMaxNumber + 1];
  size_t len = (size_t)(e - p);
  memcpy(tmp, p, len);
  tmp[len] = '\0';
  errno = 0;
  char* endp = nullptr;
  double d = strtod(tmp, &endp);
  if (endp != tmp + len || errno == ERANGE) return false;
  *out = d;
  return true;
}

struct RowRange {
  int64_t lo = 0, hi = 0;
  bool bad = false;
  bool has_ts = false;
  // block-uniform prefixes as observed by this range's first row
  const char* up = nullptr;
  int uplen = -1;  // -1: range empty / saw no rows
  const char* ip = nullptr;
  int iplen = -1;
};

void parse_rows(const char* buf, int64_t width, RowRange* rr, int32_t* users,
                int32_t* items, float* values, int64_t* ts_out) {
  for (int64_t r = rr->lo; r < rr->hi; ++r) {
    const char* p = buf + r * width;
    int64_t len = width;
    while (len > 0 && p[len - 1] == '\0') --len;
    if (len == 0 || memchr(p, '\0', (size_t)len) != nullptr) {
      rr->bad = true;  // empty row, or interior NUL (not S-padding)
      return;
    }
    const char* e = p + len;
    if (*p == '[' || *p == '{') {  // JSON line: Python slow path owns it
      rr->bad = true;
      return;
    }
    const char* c1 = (const char*)memchr(p, ',', (size_t)len);
    if (c1 == nullptr) {
      rr->bad = true;
      return;
    }
    const char* c2 = (const char*)memchr(c1 + 1, ',', (size_t)(e - c1 - 1));
    if (c2 == nullptr) {
      rr->bad = true;
      return;
    }
    const char* c3 = (const char*)memchr(c2 + 1, ',', (size_t)(e - c2 - 1));
    if (c3 != nullptr &&
        memchr(c3 + 1, ',', (size_t)(e - c3 - 1)) != nullptr) {
      rr->bad = true;  // >3 commas: Python's slow path drops extra tokens
      return;
    }
    const char* up;
    const char* ip;
    int uplen, iplen;
    if (!parse_id(p, c1, &up, &uplen, &users[r]) ||
        !parse_id(c1 + 1, c2, &ip, &iplen, &items[r])) {
      rr->bad = true;
      return;
    }
    if (rr->uplen < 0) {
      rr->up = up;
      rr->uplen = uplen;
      rr->ip = ip;
      rr->iplen = iplen;
    } else if (uplen != rr->uplen || iplen != rr->iplen ||
               memcmp(up, rr->up, (size_t)uplen) != 0 ||
               memcmp(ip, rr->ip, (size_t)iplen) != 0) {
      rr->bad = true;  // mixed prefixes cannot share one int vocab
      return;
    }
    const char* vend = (c3 != nullptr) ? c3 : e;
    if (c2 + 1 == vend) {
      values[r] = (float)NAN;  // empty value = delete marker
    } else {
      double v;
      if (!parse_double(c2 + 1, vend, &v)) {
        rr->bad = true;
        return;
      }
      values[r] = (float)v;  // f64 -> f32, same as astype chain
    }
    if (c3 == nullptr || c3 + 1 == e) {
      ts_out[r] = 0;  // missing/empty timestamp
    } else {
      double t;
      if (!parse_double(c3 + 1, e, &t) || !(t > -9.2e18 && t < 9.2e18)) {
        rr->bad = true;  // int64-cast of out-of-range double is UB
        return;
      }
      ts_out[r] = (int64_t)t;  // trunc toward zero, same as astype(i64)
    }
    if (c3 != nullptr) rr->has_ts = true;  // present (even empty) ts field
  }
}

}  // namespace

extern "C" {

// Parse n rows of `width` bytes into typed columns. prefix_out is 32
// bytes: [0]=uplen, [1..15]=user prefix, [16]=iplen, [17..31]=item
// prefix. flags_out bit0 = any row carried a timestamp field. Returns 0
// on success, -1 when the block must fall back to the Python parser.
int64_t als_parse_text_block(const char* buf, int64_t n, int64_t width,
                             int32_t* users, int32_t* items, float* values,
                             int64_t* ts_out, uint8_t* prefix_out,
                             int32_t* flags_out, int64_t num_threads) {
  if (n <= 0 || width <= 0) return -1;
  int64_t t = num_threads < 1 ? 1 : num_threads;
  if (t > 16) t = 16;
  int64_t min_rows = 8192;  // below this, thread spawn costs more than it saves
  if (t > (n + min_rows - 1) / min_rows) t = (n + min_rows - 1) / min_rows;
  std::vector<RowRange> ranges((size_t)t);
  int64_t per = (n + t - 1) / t;
  for (int64_t i = 0; i < t; ++i) {
    ranges[(size_t)i].lo = i * per;
    ranges[(size_t)i].hi = (i + 1) * per < n ? (i + 1) * per : n;
  }
  std::vector<std::thread> workers;
  for (int64_t i = 1; i < t; ++i)
    workers.emplace_back(parse_rows, buf, width, &ranges[(size_t)i], users,
                         items, values, ts_out);
  parse_rows(buf, width, &ranges[0], users, items, values, ts_out);
  for (auto& w : workers) w.join();
  const char* up = nullptr;
  const char* ip = nullptr;
  int uplen = -1, iplen = -1;
  bool has_ts = false;
  for (auto& rr : ranges) {
    if (rr.bad) return -1;
    has_ts = has_ts || rr.has_ts;
    if (rr.uplen < 0) continue;  // empty range
    if (uplen < 0) {
      up = rr.up;
      uplen = rr.uplen;
      ip = rr.ip;
      iplen = rr.iplen;
    } else if (rr.uplen != uplen || rr.iplen != iplen ||
               memcmp(rr.up, up, (size_t)uplen) != 0 ||
               memcmp(rr.ip, ip, (size_t)iplen) != 0) {
      return -1;  // ranges disagree on the block prefix
    }
  }
  if (uplen < 0) return -1;
  memset(prefix_out, 0, 32);
  prefix_out[0] = (uint8_t)uplen;
  if (uplen > 0) memcpy(prefix_out + 1, up, (size_t)uplen);
  prefix_out[16] = (uint8_t)iplen;
  if (iplen > 0) memcpy(prefix_out + 17, ip, (size_t)iplen);
  *flags_out = has_ts ? 1 : 0;
  return 0;
}

}  // extern "C"
