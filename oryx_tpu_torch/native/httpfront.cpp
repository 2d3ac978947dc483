// Epoll HTTP/1.1 front for the serving layer (docs/serving-native.md).
//
// One epoll thread owns the listener and every connection: it accepts,
// reads, parses (keep-alive, pipelining-safe), and classifies requests
// entirely outside the GIL. Three cheap rungs are answered natively from
// state the Python side pushes down on its control tick:
//
//   snapshot  /healthz //readyz //ready bodies pre-rendered by the real
//             Python resources (hf_set_snapshot)
//   shed      overload fast-429 with Retry-After, gated on the ladder
//             stage pushed from overload.py (hf_set_ladder/hf_set_tenants)
//   stale     champion-generation-gated answer-cache hits mirrored from
//             AnswerCache.put (hf_cache_put; hf_cache_clear on swap)
//
// Everything else is assembled into micro-batches framed with the RBLK
// wire codec (bus/blockcodec.py: same 32-byte header, KIND_HTTP payload)
// and handed to the Python dispatch loop via hf_poll; responses come
// back through hf_respond as fully rendered bytes and are written in
// request order per connection (pipelining safety).
//
// Parity contract (tests/serving/test_native_front.py): natively
// answered responses are byte-identical to the Python front's — the
// templates are rendered by the SAME Python code and split around the
// Date header, which this file regenerates in IMF-fixdate form. When a
// request cannot be answered bit-identically (CSV Accept, gzip-eligible
// body, tenant-prefixed control path, ...) it is FORWARDED, never
// approximated — the same decline-over-diverge rule parse.cpp follows.
//
// Ownership: hf_create starts the epoll thread and owns every fd it
// accepts; hf_close stops the thread, closes all fds, and unblocks any
// hf_poll caller (returns -1). All configuration setters may be called
// from any thread; connection state is touched only by the epoll thread.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <condition_variable>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// RBLK framing (mirrors bus/blockcodec.py HEADER = "<IHHQIII4x")
// ---------------------------------------------------------------------------

constexpr uint32_t kMagic = 0x4B4C4252;  // b"RBLK"
constexpr uint16_t kKindHttp = 4;        // blockcodec.KIND_HTTP
constexpr size_t kFrameHeader = 32;

inline size_t pad8(size_t n) { return (n + 7) & ~size_t(7); }

uint32_t crc32_zlib(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline void put_u16(std::string& b, uint16_t v) { b.append((const char*)&v, 2); }
inline void put_u32(std::string& b, uint32_t v) { b.append((const char*)&v, 4); }
inline void put_u64(std::string& b, uint64_t v) { b.append((const char*)&v, 8); }

// ---------------------------------------------------------------------------
// Latency bucketing (mirrors common/metrics.py Histogram: 1e-6 * 2^i s)
// ---------------------------------------------------------------------------

constexpr int kBuckets = 28;  // + overflow slot = 29 counters

int bucket_index(double seconds) {
  int idx = 0;
  double bound = 1e-6;
  while (idx < kBuckets && seconds > bound) {
    ++idx;
    bound *= 2.0;
  }
  return idx;
}

// ---------------------------------------------------------------------------
// Config / pushed-down state
// ---------------------------------------------------------------------------

struct AnswerTemplate {
  // response = pre + <IMF date> + post; the last body_len bytes of post
  // are the body (suppressed for HEAD)
  std::string pre;
  std::string post;
  uint32_t body_len = 0;
  uint16_t status = 200;
  bool gzip_large = false;  // body > 1024: a gzip-accepting client must forward
};

struct TenantEntry {
  std::string name;
  uint8_t stage = 0;
};

struct CacheEntry {
  AnswerTemplate tpl;
  std::list<std::string>::iterator lru;
};

struct Stats {
  uint64_t conns_accepted = 0, conns_closed = 0;
  uint64_t requests = 0, forwarded = 0, parse_errors = 0;
  uint64_t answered[3] = {0, 0, 0};  // snapshot, shed, stale
  uint64_t by_method[5] = {0, 0, 0, 0, 0};   // GET POST DELETE HEAD other
  uint64_t by_class[5] = {0, 0, 0, 0, 0};    // 1xx..5xx (native answers)
  uint64_t lat_count = 0, lat_sum_us = 0;
  uint64_t events_dropped = 0, responses_dropped = 0;
  uint64_t bytes_in = 0, bytes_out = 0, pending_hwm = 0;
  uint64_t lat_buckets[kBuckets + 1] = {0};
};
constexpr int kStatsScalars = 25;  // scalar slots before the bucket array

struct TenantStats {
  uint64_t count = 0, sum_us = 0;
  uint64_t shed_stale = 0, shed_shed = 0;
  uint64_t buckets[kBuckets + 1] = {0};
};
constexpr int kTenantStatsLen = 4 + kBuckets + 1;  // u64 slots per tenant
constexpr size_t kMaxTenants = 64;

struct TraceEvent {
  uint64_t wall_ms = 0;
  uint32_t dur_us = 0;
  uint16_t status = 0;
  uint8_t rung = 0;    // 0 snapshot, 1 shed, 2 stale
  uint8_t method = 0;  // 0 GET,1 POST,2 DELETE,3 HEAD,4 other
  int16_t tenant = -1;
  uint16_t tp_len = 0, path_len = 0;
  char tp[64];
  char path[96];
};

// ---------------------------------------------------------------------------
// Connection + request parsing
// ---------------------------------------------------------------------------

enum Method : uint8_t { M_GET = 0, M_POST = 1, M_DELETE = 2, M_HEAD = 3, M_OTHER = 4 };

struct ParsedRequest {
  uint32_t conn_id = 0, req_id = 0;
  uint8_t method = M_OTHER;
  uint8_t flags = 0;  // bit0: HTTP/1.0, bit1: close-after
  std::string target;                                  // raw, incl. query
  std::vector<std::pair<std::string, std::string>> headers;
  std::string body;
};

struct Conn {
  int fd = -1;
  uint32_t id = 0;
  std::string rbuf;
  // write side: ordered response bytes; partially written front
  std::deque<std::string> wq;
  size_t woff = 0;
  bool want_write = false;
  // pipelining order: responses are released strictly in req-id order
  uint32_t next_req_id = 1;     // id assigned to the next parsed request
  uint32_t next_write_id = 1;   // id whose response writes next
  std::map<uint32_t, std::pair<std::string, bool>> parked;  // id -> (bytes, close)
  uint32_t outstanding = 0;     // parsed-not-yet-responded
  uint32_t close_after_id = 0;  // stop after this response id (0 = none)
  bool stop_parsing = false;
  double last_activity = 0.0;
  // body accumulation state
  bool in_body = false;
  ParsedRequest cur;
  size_t body_need = 0;
};

double now_mono() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

uint64_t now_wall_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return uint64_t(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

void http_date(char* out, size_t cap) {
  time_t t = time(nullptr);
  struct tm g;
  gmtime_r(&t, &g);
  // IMF-fixdate, identical to BaseHTTPRequestHandler.date_time_string()
  strftime(out, cap, "%a, %d %b %Y %H:%M:%S GMT", &g);
}

inline bool ieq(const std::string& a, const char* b) {
  size_t n = strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; ++i)
    if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i])) return false;
  return true;
}

// ---------------------------------------------------------------------------
// The front
// ---------------------------------------------------------------------------

struct Front {
  int listen_fd = -1, epoll_fd = -1, event_fd = -1;
  int port = 0;
  std::thread loop;
  bool closing = false;

  // limits (hf_create args)
  size_t max_header = 16384, max_body = 1 << 20;
  double idle_timeout = 30.0;
  size_t max_conns = 1024, max_pending = 4096, max_pipeline = 64;

  // connections (epoll thread only)
  std::unordered_map<uint32_t, std::unique_ptr<Conn>> conns;
  std::unordered_map<int, uint32_t> fd_to_id;
  uint32_t next_conn_id = 1;

  // pending parsed requests -> Python (hf_poll)
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<ParsedRequest> pending;
  uint64_t batch_seq = 0;
  bool q_closed = false;
  bool paused_reads = false;  // backpressure: queue full

  // responses Python -> epoll thread (hf_respond inbox)
  std::mutex r_mu;
  struct Resp { uint32_t conn_id, req_id; std::string data; bool close; };
  std::deque<Resp> inbox;

  // pushed-down classification state (cfg_mu guards; readers = epoll thread)
  std::mutex cfg_mu;
  uint8_t global_stage = 0;
  uint16_t retry_after_s = 1;
  // bit0 snapshots, bit1 shed, bit2 stale, bit3 tenancy-on
  uint32_t flags = 0;
  std::string context_path;
  std::vector<std::string> exempt;  // post-context-strip prefixes
  std::vector<TenantEntry> tenants;
  int default_tenant = -1;
  AnswerTemplate shed_tpl;
  bool have_shed_tpl = false;
  std::unordered_map<std::string, AnswerTemplate> snapshots;  // raw path -> tpl
  std::unordered_map<std::string, CacheEntry> cache;
  std::list<std::string> cache_lru;  // front = most recent
  size_t cache_cap = 256;

  // stats + trace events
  std::mutex s_mu;
  Stats stats;
  std::vector<TenantStats> tstats;
  std::vector<TraceEvent> events;
  static constexpr size_t kMaxEvents = 4096;

  ~Front() { do_close(); }

  // -- lifecycle ------------------------------------------------------------

  bool start(int want_port, int backlog) {
    listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons((uint16_t)want_port);
    if (bind(listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0) return false;
    if (listen(listen_fd, backlog) != 0) return false;
    socklen_t alen = sizeof(addr);
    if (getsockname(listen_fd, (sockaddr*)&addr, &alen) != 0) return false;
    port = ntohs(addr.sin_port);
    epoll_fd = epoll_create1(EPOLL_CLOEXEC);
    event_fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    if (epoll_fd < 0 || event_fd < 0) return false;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = listen_fd;
    epoll_ctl(epoll_fd, EPOLL_CTL_ADD, listen_fd, &ev);
    ev.data.fd = event_fd;
    epoll_ctl(epoll_fd, EPOLL_CTL_ADD, event_fd, &ev);
    loop = std::thread([this] { run(); });
    return true;
  }

  void do_close() {
    {
      std::lock_guard<std::mutex> lk(r_mu);
      if (closing) return;
      closing = true;
    }
    wake();
    if (loop.joinable()) loop.join();
    {
      std::lock_guard<std::mutex> lk(q_mu);
      q_closed = true;
    }
    q_cv.notify_all();
    for (auto& kv : conns) ::close(kv.second->fd);
    conns.clear();
    fd_to_id.clear();
    if (listen_fd >= 0) ::close(listen_fd);
    if (event_fd >= 0) ::close(event_fd);
    if (epoll_fd >= 0) ::close(epoll_fd);
    listen_fd = event_fd = epoll_fd = -1;
  }

  void wake() {
    uint64_t one = 1;
    ssize_t r = write(event_fd, &one, sizeof(one));
    (void)r;
  }

  bool is_closing() {
    std::lock_guard<std::mutex> lk(r_mu);
    return closing;
  }

  // -- epoll loop -----------------------------------------------------------

  void run() {
    epoll_event evs[64];
    double last_sweep = now_mono();
    while (!is_closing()) {
      int n = epoll_wait(epoll_fd, evs, 64, 500);
      if (is_closing()) break;
      for (int i = 0; i < n; ++i) {
        int fd = evs[i].data.fd;
        if (fd == listen_fd) {
          accept_loop();
        } else if (fd == event_fd) {
          uint64_t junk;
          while (read(event_fd, &junk, sizeof(junk)) > 0) {}
          drain_inbox();
          maybe_resume_reads();
        } else {
          auto it = fd_to_id.find(fd);
          if (it == fd_to_id.end()) continue;
          Conn* c = conns[it->second].get();
          if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
            close_conn(c);
            continue;
          }
          if (evs[i].events & EPOLLIN) on_readable(c);
          // on_readable may close; re-lookup
          auto it2 = fd_to_id.find(fd);
          if (it2 == fd_to_id.end()) continue;
          c = conns[it2->second].get();
          if (evs[i].events & EPOLLOUT) flush_writes(c);
        }
      }
      double t = now_mono();
      if (t - last_sweep >= 1.0) {
        last_sweep = t;
        sweep_idle(t);
      }
    }
    // unblock any hf_poll caller
    {
      std::lock_guard<std::mutex> lk(q_mu);
      q_closed = true;
    }
    q_cv.notify_all();
  }

  void accept_loop() {
    while (true) {
      int fd = accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK | SOCK_CLOEXEC);
      if (fd < 0) break;
      if (conns.size() >= max_conns) {
        ::close(fd);
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto c = std::make_unique<Conn>();
      c->fd = fd;
      c->id = next_conn_id++;
      c->last_activity = now_mono();
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      epoll_ctl(epoll_fd, EPOLL_CTL_ADD, fd, &ev);
      fd_to_id[fd] = c->id;
      {
        std::lock_guard<std::mutex> lk(s_mu);
        stats.conns_accepted++;
      }
      conns[c->id] = std::move(c);
    }
  }

  void close_conn(Conn* c) {
    epoll_ctl(epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
    ::close(c->fd);
    fd_to_id.erase(c->fd);
    {
      std::lock_guard<std::mutex> lk(s_mu);
      stats.conns_closed++;
    }
    conns.erase(c->id);
  }

  void sweep_idle(double t) {
    std::vector<Conn*> victims;
    for (auto& kv : conns)
      if (t - kv.second->last_activity > idle_timeout &&
          kv.second->outstanding == 0)
        victims.push_back(kv.second.get());
    for (Conn* c : victims) close_conn(c);
  }

  // -- reads + parsing ------------------------------------------------------

  bool queue_full() {
    std::lock_guard<std::mutex> lk(q_mu);
    return pending.size() >= max_pending;
  }

  void maybe_resume_reads() {
    if (!paused_reads || queue_full()) return;
    paused_reads = false;
    // level-triggered epoll re-delivers readable conns; re-parse any
    // buffered bytes that were left when the queue filled. Iterate by
    // id: parse_loop can close (free) connections as it goes.
    std::vector<uint32_t> ids;
    ids.reserve(conns.size());
    for (auto& kv : conns) ids.push_back(kv.first);
    for (uint32_t id : ids) {
      auto it = conns.find(id);
      if (it != conns.end()) parse_loop(it->second.get());
    }
  }

  void on_readable(Conn* c) {
    char buf[65536];
    while (true) {
      ssize_t r = read(c->fd, buf, sizeof(buf));
      if (r > 0) {
        c->last_activity = now_mono();
        {
          std::lock_guard<std::mutex> lk(s_mu);
          stats.bytes_in += (uint64_t)r;
        }
        if (c->stop_parsing) continue;  // discard post-close pipeline bytes
        c->rbuf.append(buf, (size_t)r);
        if (!c->in_body && c->rbuf.size() > max_header + max_body) {
          // runaway header with no terminator
          native_error(c, 431, "Request Header Fields Too Large");
          return;
        }
      } else if (r == 0) {
        if (c->outstanding == 0 && c->wq.empty()) {
          close_conn(c);
        } else {
          // peer half-closed with requests in flight: answer them,
          // then the ordered-release path closes after the last one
          c->stop_parsing = true;
          if (c->close_after_id == 0) c->close_after_id = c->next_req_id - 1;
        }
        return;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        close_conn(c);
        return;
      }
    }
    parse_loop(c);
  }

  // parse as many complete requests as the buffer holds
  void parse_loop(Conn* c) {
    while (!c->stop_parsing) {
      if (c->outstanding >= max_pipeline) return;
      if (queue_full()) {
        paused_reads = true;
        return;
      }
      if (c->in_body) {
        if (c->rbuf.size() < c->body_need) return;
        c->cur.body.assign(c->rbuf.data(), c->body_need);
        c->rbuf.erase(0, c->body_need);
        c->in_body = false;
        if (!finish_request(c)) return;
        continue;
      }
      size_t hdr_end = c->rbuf.find("\r\n\r\n");
      if (hdr_end == std::string::npos) {
        if (c->rbuf.size() > max_header) {
          native_error(c, 431, "Request Header Fields Too Large");
        }
        return;
      }
      if (hdr_end + 4 > max_header) {
        native_error(c, 431, "Request Header Fields Too Large");
        return;
      }
      if (!parse_headers(c, hdr_end)) return;  // errored + closed
      c->rbuf.erase(0, hdr_end + 4);
      if (c->body_need > 0) {
        if (c->body_need > max_body) {
          native_error(c, 413, "Payload Too Large");
          return;
        }
        c->in_body = true;
        continue;  // loop reads body from rbuf
      }
      if (!finish_request(c)) return;
    }
  }

  // request line + header block into c->cur; sets body_need. On protocol
  // errors answers natively and closes; returns false then.
  bool parse_headers(Conn* c, size_t hdr_end) {
    const std::string& b = c->rbuf;
    size_t line_end = b.find("\r\n");
    if (line_end == std::string::npos || line_end > hdr_end) line_end = hdr_end;
    size_t sp1 = b.find(' ');
    if (sp1 == std::string::npos || sp1 >= line_end) {
      native_error(c, 400, "Bad Request");
      return false;
    }
    size_t sp2 = b.find(' ', sp1 + 1);
    if (sp2 == std::string::npos || sp2 >= line_end) {
      native_error(c, 400, "Bad Request");
      return false;
    }
    std::string method = b.substr(0, sp1);
    std::string target = b.substr(sp1 + 1, sp2 - sp1 - 1);
    std::string version = b.substr(sp2 + 1, line_end - sp2 - 1);
    c->cur = ParsedRequest();
    c->cur.conn_id = c->id;
    c->cur.target = std::move(target);
    if (method == "GET") c->cur.method = M_GET;
    else if (method == "POST") c->cur.method = M_POST;
    else if (method == "DELETE") c->cur.method = M_DELETE;
    else if (method == "HEAD") c->cur.method = M_HEAD;
    else {
      native_error(c, 501, "Unsupported method");
      return false;
    }
    bool http10 = false;
    if (version == "HTTP/1.1") {
    } else if (version == "HTTP/1.0") {
      http10 = true;
      c->cur.flags |= 1;
    } else {
      native_error(c, 505, "HTTP Version Not Supported");
      return false;
    }
    // headers
    size_t pos = line_end + 2;
    size_t content_length = 0;
    bool keep_alive = !http10;
    bool expect_continue = false;
    while (pos < hdr_end) {
      size_t eol = b.find("\r\n", pos);
      if (eol == std::string::npos || eol > hdr_end) eol = hdr_end;
      size_t colon = b.find(':', pos);
      if (colon == std::string::npos || colon >= eol) {
        native_error(c, 400, "Bad Request");
        return false;
      }
      std::string name = b.substr(pos, colon - pos);
      size_t vstart = colon + 1;
      while (vstart < eol && (b[vstart] == ' ' || b[vstart] == '\t')) ++vstart;
      size_t vend = eol;
      while (vend > vstart && (b[vend - 1] == ' ' || b[vend - 1] == '\t')) --vend;
      std::string value = b.substr(vstart, vend - vstart);
      if (ieq(name, "content-length")) {
        char* endp = nullptr;
        unsigned long long cl = strtoull(value.c_str(), &endp, 10);
        if (endp == value.c_str() || *endp != '\0') {
          native_error(c, 400, "Bad Request");
          return false;
        }
        content_length = (size_t)cl;
      } else if (ieq(name, "transfer-encoding")) {
        native_error(c, 501, "Unsupported transfer encoding");
        return false;
      } else if (ieq(name, "connection")) {
        if (ieq(value, "close")) keep_alive = false;
        else if (ieq(value, "keep-alive")) keep_alive = true;
      } else if (ieq(name, "expect") && ieq(value, "100-continue")) {
        expect_continue = true;
      }
      c->cur.headers.emplace_back(std::move(name), std::move(value));
      pos = eol + 2;
    }
    if (!keep_alive) c->cur.flags |= 2;
    c->body_need = content_length;
    if (expect_continue && content_length > 0 && content_length <= max_body)
      if (!raw_write(c, "HTTP/1.1 100 Continue\r\n\r\n")) return false;
    return true;
  }

  // classify a fully parsed request: answer natively or queue to Python.
  // Returns false when the connection was closed.
  bool finish_request(Conn* c) {
    c->cur.req_id = c->next_req_id++;
    c->outstanding++;
    c->last_activity = now_mono();
    bool close_after = (c->cur.flags & 2) != 0;
    if (close_after) {
      c->close_after_id = c->cur.req_id;
      c->stop_parsing = true;
    }
    {
      std::lock_guard<std::mutex> lk(s_mu);
      stats.requests++;
    }
    std::string native;
    uint8_t rung = 0;
    uint16_t status = 0;
    int16_t tenant_idx = -1;
    double t0 = now_mono();
    bool answered = classify(c->cur, &native, &rung, &status, &tenant_idx);
    if (answered) {
      record_native(c->cur, rung, status, tenant_idx, now_mono() - t0);
      uint32_t rid = c->cur.req_id;
      c->cur = ParsedRequest();  // reset BEFORE complete() may free c
      return complete(c, rid, std::move(native), false);
    }
    {
      std::lock_guard<std::mutex> lk(s_mu);
      stats.forwarded++;
    }
    bool notify;
    {
      std::lock_guard<std::mutex> lk(q_mu);
      notify = pending.empty();
      pending.push_back(std::move(c->cur));
      std::lock_guard<std::mutex> lk2(s_mu);
      if (pending.size() > stats.pending_hwm) stats.pending_hwm = pending.size();
    }
    c->cur = ParsedRequest();
    if (notify) q_cv.notify_all();
    return true;
  }

  // -- native classification ------------------------------------------------

  static void split_target(const std::string& target, std::string* path,
                           std::string* query) {
    size_t q = target.find('?');
    if (q == std::string::npos) {
      *path = target;
      query->clear();
    } else {
      *path = target.substr(0, q);
      *query = target.substr(q + 1);
    }
  }

  // mirrors tenancy/context.py split_tenant_path
  static bool split_tenant_path(const std::string& path, std::string* tenant,
                                std::string* rest) {
    if (path.compare(0, 3, "/t/") != 0) return false;
    std::string r = path.substr(3);
    size_t sep = r.find('/');
    if (sep == std::string::npos) {
      *tenant = r;
      *rest = "/";
    } else {
      *tenant = r.substr(0, sep);
      *rest = r.substr(sep);
      if (rest->empty()) *rest = "/";
    }
    return !tenant->empty();
  }

  bool path_exempt(const std::string& path) {
    for (const auto& p : exempt) {
      if (!p.empty() && p.back() == '/') {
        std::string bare = p.substr(0, p.size() - 1);
        if (path == bare || path.compare(0, p.size(), p) == 0) return true;
      } else if (path == p || path.compare(0, p.size(), p) == 0) {
        return true;
      }
    }
    return false;
  }

  const std::string* header_get(const ParsedRequest& r, const char* name) {
    for (const auto& kv : r.headers)
      if (ieq(kv.first, name)) return &kv.second;
    return nullptr;
  }

  bool accept_blocks_native(const ParsedRequest& r, bool gzip_large) {
    // CSV negotiation and gzip-eligible bodies are Python's business:
    // forward rather than diverge (render()/gzip parity)
    const std::string* acc = header_get(r, "accept");
    if (acc != nullptr && acc->find("text/csv") != std::string::npos) return true;
    if (gzip_large) {
      const std::string* ae = header_get(r, "accept-encoding");
      if (ae != nullptr && ae->find("gzip") != std::string::npos) return true;
    }
    return false;
  }

  bool classify(const ParsedRequest& r, std::string* out, uint8_t* rung,
                uint16_t* status, int16_t* tenant_idx) {
    std::lock_guard<std::mutex> lk(cfg_mu);
    std::string path, query;
    split_target(r.target, &path, &query);
    bool tenancy_on = (flags & 8) != 0;
    bool is_get = r.method == M_GET || r.method == M_HEAD;

    // snapshots match the RAW path (context path included, no tenant
    // forms — a tenant-prefixed or tenant-headed control request routes
    // through Python so tenant validation/accounting stays exact)
    if ((flags & 1) != 0 && is_get) {
      auto it = snapshots.find(path);
      if (it != snapshots.end() &&
          !(tenancy_on && (header_get(r, "x-oryx-tenant") != nullptr ||
                           path.compare(0, 3, "/t/") == 0)) &&
          !accept_blocks_native(r, it->second.gzip_large)) {
        *out = render_template(it->second, r.method == M_HEAD);
        *rung = 0;
        *status = it->second.status;
        *tenant_idx = -1;
        return true;
      }
    }
    if ((flags & 6) == 0 || global_stage == 0) {
      // ladder fully released (the common fast path) unless a tenant
      // ladder is raised; check those only when tenancy is on
      bool any_tenant_raised = false;
      if (tenancy_on)
        for (const auto& t : tenants)
          if (t.stage > 0) { any_tenant_raised = true; break; }
      if (!any_tenant_raised) return false;
    }

    // context-path strip (outside-context requests forward: Python 404s)
    std::string sub = path;
    if (!context_path.empty()) {
      if (sub.compare(0, context_path.size(), context_path) != 0) return false;
      sub = sub.substr(context_path.size());
      if (sub.empty()) sub = "/";
    }
    // tenant resolution: /t/<id>/ prefix > X-Oryx-Tenant header > default
    std::string tenant;
    int t_idx = -1;
    std::string stripped = sub;
    if (tenancy_on) {
      std::string tid, rest;
      if (split_tenant_path(sub, &tid, &rest)) {
        tenant = tid;
        stripped = rest;
      } else {
        const std::string* th = header_get(r, "x-oryx-tenant");
        if (th != nullptr) tenant = *th;
      }
      if (tenant.empty() && !path_exempt(stripped) && default_tenant >= 0)
        t_idx = default_tenant;
      else if (!tenant.empty()) {
        for (size_t i = 0; i < tenants.size(); ++i)
          if (tenants[i].name == tenant) { t_idx = (int)i; break; }
        if (t_idx < 0) return false;  // unknown tenant: Python 404s
      }
    }
    *tenant_idx = (int16_t)t_idx;
    if (path_exempt(stripped)) return false;  // control plane: never shed

    uint8_t stage = global_stage;
    if (t_idx >= 0 && tenants[t_idx].stage > stage) stage = tenants[t_idx].stage;
    if (stage >= 3 && (flags & 2) != 0 && have_shed_tpl) {
      *out = render_template(shed_tpl, r.method == M_HEAD);
      *rung = 1;
      *status = 429;
      return true;
    }
    if (stage >= 2 && (flags & 4) != 0 && is_get) {
      std::string key = stripped;
      if (!query.empty()) key += "?" + query;
      if (t_idx >= 0) key = "/t/" + tenants[t_idx].name + key;
      auto it = cache.find(key);
      if (it != cache.end() &&
          !accept_blocks_native(r, it->second.tpl.gzip_large)) {
        cache_lru.splice(cache_lru.begin(), cache_lru, it->second.lru);
        *out = render_template(it->second.tpl, r.method == M_HEAD);
        *rung = 2;
        *status = it->second.tpl.status;
        return true;
      }
    }
    return false;
  }

  std::string render_template(const AnswerTemplate& t, bool head) {
    char date[64];
    http_date(date, sizeof(date));
    std::string out;
    out.reserve(t.pre.size() + t.post.size() + 32);
    out += t.pre;
    out += date;
    if (head) out.append(t.post.data(), t.post.size() - t.body_len);
    else out += t.post;
    return out;
  }

  void record_native(const ParsedRequest& r, uint8_t rung, uint16_t status,
                     int16_t tenant_idx, double dur_s) {
    uint64_t dur_us = (uint64_t)(dur_s * 1e6);
    int bi = bucket_index(dur_s);
    {
      std::lock_guard<std::mutex> lk(s_mu);
      stats.answered[rung]++;
      stats.by_method[r.method < 5 ? r.method : 4]++;
      int cls = status / 100;
      if (cls >= 1 && cls <= 5) stats.by_class[cls - 1]++;
      stats.lat_count++;
      stats.lat_sum_us += dur_us;
      stats.lat_buckets[bi]++;
      if (tenant_idx >= 0) {
        if ((size_t)tenant_idx >= tstats.size()) tstats.resize(tenant_idx + 1);
        TenantStats& ts = tstats[tenant_idx];
        ts.count++;
        ts.sum_us += dur_us;
        ts.buckets[bi]++;
        if (rung == 1) ts.shed_shed++;
        else if (rung == 2) ts.shed_stale++;
      }
      // span emission: only sampled incoming traceparents ride the ring
      const std::string* tp = header_get(r, "traceparent");
      if (tp != nullptr && tp->size() >= 2 && tp->size() < 64 &&
          tp->compare(tp->size() - 2, 2, "01") == 0) {
        if (events.size() >= kMaxEvents) {
          stats.events_dropped++;
        } else {
          TraceEvent ev;
          ev.wall_ms = now_wall_ms();
          ev.dur_us = (uint32_t)dur_us;
          ev.status = status;
          ev.rung = rung;
          ev.method = r.method;
          ev.tenant = tenant_idx;
          ev.tp_len = (uint16_t)tp->size();
          memcpy(ev.tp, tp->data(), tp->size());
          std::string path, query;
          split_target(r.target, &path, &query);
          ev.path_len = (uint16_t)std::min(path.size(), sizeof(ev.path));
          memcpy(ev.path, path.data(), ev.path_len);
          events.push_back(ev);
        }
      }
    }
  }

  // minimal native protocol-error answer; closes after writing. These
  // cover only malformed-wire cases the Python front never sees intact
  // (it would be parsing the same broken bytes), so no parity template.
  void native_error(Conn* c, int status, const char* reason) {
    {
      std::lock_guard<std::mutex> lk(s_mu);
      stats.parse_errors++;
    }
    char date[64];
    http_date(date, sizeof(date));
    char body[128];
    int blen = snprintf(body, sizeof(body), "%d %s\n", status, reason);
    char buf[512];
    int n = snprintf(buf, sizeof(buf),
                     "HTTP/1.1 %d %s\r\nServer: oryx_tpu\r\nDate: %s\r\n"
                     "Content-Type: text/plain\r\nContent-Length: %d\r\n"
                     "Connection: close\r\n\r\n%s",
                     status, reason, date, blen, body);
    c->stop_parsing = true;
    c->in_body = false;
    uint32_t id = c->next_req_id++;
    c->outstanding++;
    c->close_after_id = id;
    complete(c, id, std::string(buf, n), true);
  }

  // returns false when the write error closed (and freed) the conn
  bool raw_write(Conn* c, const char* data) {
    int fd = c->fd;
    c->wq.emplace_back(data);
    flush_writes(c);
    return fd_to_id.count(fd) != 0;
  }

  // -- response ordering + writes ------------------------------------------

  // hand a response for req_id to the connection; releases in order.
  // Returns false when the conn was closed by this call.
  bool complete(Conn* c, uint32_t req_id, std::string data, bool force_close) {
    if (req_id != c->next_write_id) {
      c->parked.emplace(req_id, std::make_pair(std::move(data), force_close));
      return true;
    }
    bool closed = release(c, req_id, std::move(data), force_close);
    if (closed) return false;
    // drain any parked successors
    while (true) {
      auto it = c->parked.find(c->next_write_id);
      if (it == c->parked.end()) break;
      uint32_t id = it->first;
      std::string d = std::move(it->second.first);
      bool fc = it->second.second;
      c->parked.erase(it);
      if (release(c, id, std::move(d), fc)) return false;
    }
    return true;
  }

  // returns true when the conn was closed
  bool release(Conn* c, uint32_t req_id, std::string data, bool force_close) {
    c->wq.push_back(std::move(data));
    c->next_write_id = req_id + 1;
    if (c->outstanding > 0) c->outstanding--;
    bool close_now = force_close ||
                     (c->close_after_id != 0 && req_id >= c->close_after_id);
    int fd = c->fd;  // flush may free c on a dead socket
    flush_writes(c);
    if (!fd_to_id.count(fd)) return true;
    if (close_now && c->wq.empty()) {
      close_conn(c);
      return true;
    }
    if (close_now) c->stop_parsing = true;  // close when the queue drains
    return false;
  }

  void flush_writes(Conn* c) {
    while (!c->wq.empty()) {
      const std::string& front = c->wq.front();
      ssize_t w = write(c->fd, front.data() + c->woff, front.size() - c->woff);
      if (w > 0) {
        {
          std::lock_guard<std::mutex> lk(s_mu);
          stats.bytes_out += (uint64_t)w;
        }
        c->woff += (size_t)w;
        if (c->woff == front.size()) {
          c->wq.pop_front();
          c->woff = 0;
        }
        continue;
      }
      if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (!c->want_write) {
          c->want_write = true;
          epoll_event ev{};
          ev.events = EPOLLIN | EPOLLOUT;
          ev.data.fd = c->fd;
          epoll_ctl(epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
        }
        return;
      }
      close_conn(c);
      return;
    }
    if (c->want_write) {
      c->want_write = false;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = c->fd;
      epoll_ctl(epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
    }
    // writer-side close for conns whose peer half-closed or that were
    // marked close-after once everything has drained
    if (c->wq.empty() && c->stop_parsing && c->outstanding == 0 &&
        c->close_after_id != 0 && c->next_write_id > c->close_after_id) {
      close_conn(c);
    }
  }

  void drain_inbox() {
    std::deque<Resp> batch;
    {
      std::lock_guard<std::mutex> lk(r_mu);
      batch.swap(inbox);
    }
    for (auto& r : batch) {
      auto it = conns.find(r.conn_id);
      if (it == conns.end()) {
        std::lock_guard<std::mutex> lk(s_mu);
        stats.responses_dropped++;
        continue;
      }
      complete(it->second.get(), r.req_id, std::move(r.data), r.close);
    }
  }

  // -- hf_poll frame assembly ----------------------------------------------

  int64_t poll_batch(uint8_t* buf, size_t cap, int timeout_ms) {
    std::unique_lock<std::mutex> lk(q_mu);
    if (pending.empty() && !q_closed)
      q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                    [this] { return !pending.empty() || q_closed; });
    if (pending.empty()) return q_closed ? -1 : 0;
    std::string payload;
    uint32_t count = 0;
    while (!pending.empty()) {
      const ParsedRequest& r = pending.front();
      size_t rec = 24 + r.target.size() + r.body.size();
      for (const auto& kv : r.headers) rec += 4 + kv.first.size() + kv.second.size();
      rec = pad8(rec);
      if (kFrameHeader + pad8(payload.size() + rec) > cap) break;
      size_t start = payload.size();
      put_u32(payload, r.conn_id);
      put_u32(payload, r.req_id);
      payload.push_back((char)r.method);
      payload.push_back((char)r.flags);
      put_u16(payload, (uint16_t)r.headers.size());
      put_u32(payload, (uint32_t)r.target.size());
      put_u32(payload, (uint32_t)r.body.size());
      put_u32(payload, (uint32_t)rec);
      payload += r.target;
      for (const auto& kv : r.headers) {
        put_u16(payload, (uint16_t)kv.first.size());
        put_u16(payload, (uint16_t)kv.second.size());
        payload += kv.first;
        payload += kv.second;
      }
      payload += r.body;
      payload.resize(start + rec, '\0');
      ++count;
      pending.pop_front();
    }
    if (count == 0) return 0;  // caller buffer too small for one record
    uint64_t seq = batch_seq;
    batch_seq += count;
    bool was_full = pending.size() + count >= max_pending;
    lk.unlock();
    if (was_full) wake();  // nudge the epoll thread to resume paused reads
    std::string frame;
    frame.reserve(kFrameHeader + pad8(payload.size()));
    put_u32(frame, kMagic);
    put_u16(frame, kKindHttp);
    put_u16(frame, 0);
    put_u64(frame, seq);
    put_u32(frame, count);
    put_u32(frame, (uint32_t)payload.size());
    put_u32(frame, crc32_zlib((const uint8_t*)payload.data(), payload.size()));
    put_u32(frame, 0);
    frame += payload;
    frame.resize(kFrameHeader + pad8(payload.size()), '\0');
    memcpy(buf, frame.data(), frame.size());
    return (int64_t)frame.size();
  }
};

AnswerTemplate make_template(const uint8_t* pre, int64_t pre_len,
                             const uint8_t* post, int64_t post_len,
                             int64_t body_len, int status) {
  AnswerTemplate t;
  t.pre.assign((const char*)pre, (size_t)pre_len);
  t.post.assign((const char*)post, (size_t)post_len);
  t.body_len = (uint32_t)body_len;
  t.status = (uint16_t)status;
  t.gzip_large = body_len > 1024;
  return t;
}

}  // namespace

extern "C" {

void* hf_create(int port, int backlog, int64_t max_header, int64_t max_body,
                double idle_timeout_s, int64_t max_conns) {
  auto* f = new Front();
  if (max_header > 0) f->max_header = (size_t)max_header;
  if (max_body > 0) f->max_body = (size_t)max_body;
  if (idle_timeout_s > 0) f->idle_timeout = idle_timeout_s;
  if (max_conns > 0) f->max_conns = (size_t)max_conns;
  if (!f->start(port, backlog > 0 ? backlog : 128)) {
    delete f;
    return nullptr;
  }
  return f;
}

int hf_port(void* h) { return ((Front*)h)->port; }

// two-phase teardown: hf_shutdown stops the epoll thread, closes every
// socket, and unblocks hf_poll (returns -1) while keeping the handle
// alive, so late hf_respond callers see a clean -1 instead of a freed
// pointer; hf_close frees it once the binding has joined its threads.
void hf_shutdown(void* h) { ((Front*)h)->do_close(); }

void hf_close(void* h) { delete (Front*)h; }

int64_t hf_poll(void* h, uint8_t* buf, int64_t cap, int timeout_ms) {
  return ((Front*)h)->poll_batch(buf, (size_t)cap, timeout_ms);
}

int hf_respond(void* h, uint32_t conn_id, uint32_t req_id, const uint8_t* data,
               int64_t len, int close_after) {
  Front* f = (Front*)h;
  {
    std::lock_guard<std::mutex> lk(f->r_mu);
    if (f->closing) return -1;
    f->inbox.push_back({conn_id, req_id,
                        std::string((const char*)data, (size_t)len),
                        close_after != 0});
  }
  f->wake();
  return 0;
}

void hf_set_ladder(void* h, int stage, int retry_after_s, uint32_t flags) {
  Front* f = (Front*)h;
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->global_stage = (uint8_t)stage;
  f->retry_after_s = (uint16_t)retry_after_s;
  f->flags = flags;
}

// blob: [i32 default_idx][u32 n] then n x { u16 name_len, u8 stage, u8 pad,
// name bytes }
void hf_set_tenants(void* h, const uint8_t* blob, int64_t len) {
  Front* f = (Front*)h;
  std::vector<TenantEntry> out;
  int32_t def = -1;
  if (len >= 8) {
    memcpy(&def, blob, 4);
    uint32_t n;
    memcpy(&n, blob + 4, 4);
    size_t pos = 8;
    for (uint32_t i = 0; i < n && i < kMaxTenants; ++i) {
      if (pos + 4 > (size_t)len) break;
      uint16_t nl;
      memcpy(&nl, blob + pos, 2);
      uint8_t stage = blob[pos + 2];
      pos += 4;
      if (pos + nl > (size_t)len) break;
      TenantEntry t;
      t.name.assign((const char*)blob + pos, nl);
      t.stage = stage;
      pos += nl;
      out.push_back(std::move(t));
    }
  }
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->tenants = std::move(out);
  f->default_tenant = (def >= 0 && (size_t)def < f->tenants.size()) ? def : -1;
}

// blob: [u32 n] then n x { u16 len, bytes } — post-context-strip prefixes
void hf_set_exempt(void* h, const uint8_t* blob, int64_t len) {
  Front* f = (Front*)h;
  std::vector<std::string> out;
  if (len >= 4) {
    uint32_t n;
    memcpy(&n, blob, 4);
    size_t pos = 4;
    for (uint32_t i = 0; i < n; ++i) {
      if (pos + 2 > (size_t)len) break;
      uint16_t l;
      memcpy(&l, blob + pos, 2);
      pos += 2;
      if (pos + l > (size_t)len) break;
      out.emplace_back((const char*)blob + pos, l);
      pos += l;
    }
  }
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->exempt = std::move(out);
}

void hf_set_context(void* h, const uint8_t* prefix, int64_t len) {
  Front* f = (Front*)h;
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->context_path.assign((const char*)prefix, (size_t)len);
}

void hf_set_shed_template(void* h, const uint8_t* pre, int64_t pre_len,
                          const uint8_t* post, int64_t post_len,
                          int64_t body_len) {
  Front* f = (Front*)h;
  AnswerTemplate t = make_template(pre, pre_len, post, post_len, body_len, 429);
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->shed_tpl = std::move(t);
  f->have_shed_tpl = true;
}

void hf_set_snapshot(void* h, const uint8_t* path, int64_t path_len,
                     const uint8_t* pre, int64_t pre_len, const uint8_t* post,
                     int64_t post_len, int64_t body_len, int status) {
  Front* f = (Front*)h;
  std::string key((const char*)path, (size_t)path_len);
  AnswerTemplate t = make_template(pre, pre_len, post, post_len, body_len, status);
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->snapshots[std::move(key)] = std::move(t);
}

void hf_cache_cap(void* h, int64_t cap) {
  Front* f = (Front*)h;
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->cache_cap = cap > 0 ? (size_t)cap : 1;
}

void hf_cache_put(void* h, const uint8_t* key, int64_t key_len,
                  const uint8_t* pre, int64_t pre_len, const uint8_t* post,
                  int64_t post_len, int64_t body_len) {
  Front* f = (Front*)h;
  std::string k((const char*)key, (size_t)key_len);
  AnswerTemplate t = make_template(pre, pre_len, post, post_len, body_len, 200);
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  auto it = f->cache.find(k);
  if (it != f->cache.end()) {
    it->second.tpl = std::move(t);
    f->cache_lru.splice(f->cache_lru.begin(), f->cache_lru, it->second.lru);
    return;
  }
  f->cache_lru.push_front(k);
  f->cache.emplace(std::move(k), CacheEntry{std::move(t), f->cache_lru.begin()});
  while (f->cache.size() > f->cache_cap) {
    f->cache.erase(f->cache_lru.back());
    f->cache_lru.pop_back();
  }
}

void hf_cache_clear(void* h) {
  Front* f = (Front*)h;
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  f->cache.clear();
  f->cache_lru.clear();
}

int64_t hf_cache_size(void* h) {
  Front* f = (Front*)h;
  std::lock_guard<std::mutex> lk(f->cfg_mu);
  return (int64_t)f->cache.size();
}

// drain-and-reset aggregate counters into out (u64 slots). Layout:
// [0..23] scalars, [24..52] latency buckets, then per-tenant blocks of
// kTenantStatsLen slots for n_tenants tenants. Returns slots written.
int64_t hf_stats(void* h, uint64_t* out, int64_t cap, int n_tenants) {
  Front* f = (Front*)h;
  Stats s;
  std::vector<TenantStats> ts;
  {
    std::lock_guard<std::mutex> lk(f->s_mu);
    s = f->stats;
    f->stats = Stats();
    ts.swap(f->tstats);
  }
  int64_t need = kStatsScalars + kBuckets + 1 + (int64_t)n_tenants * kTenantStatsLen;
  if (cap < need) return -1;
  uint64_t* p = out;
  *p++ = s.conns_accepted;
  *p++ = s.conns_closed;
  *p++ = s.requests;
  *p++ = s.forwarded;
  *p++ = s.parse_errors;
  *p++ = s.answered[0];
  *p++ = s.answered[1];
  *p++ = s.answered[2];
  for (int i = 0; i < 5; ++i) *p++ = s.by_method[i];
  for (int i = 0; i < 5; ++i) *p++ = s.by_class[i];
  *p++ = s.lat_count;
  *p++ = s.lat_sum_us;
  *p++ = s.events_dropped;
  *p++ = s.responses_dropped;
  *p++ = s.bytes_in;
  *p++ = s.bytes_out;
  *p++ = s.pending_hwm;
  for (int i = 0; i < kBuckets + 1; ++i) *p++ = s.lat_buckets[i];
  for (int t = 0; t < n_tenants; ++t) {
    TenantStats blank;
    const TenantStats& src = (size_t)t < ts.size() ? ts[t] : blank;
    *p++ = src.count;
    *p++ = src.sum_us;
    *p++ = src.shed_stale;
    *p++ = src.shed_shed;
    for (int i = 0; i < kBuckets + 1; ++i) *p++ = src.buckets[i];
  }
  return p - out;
}

// drain trace events; each record is a fixed 184-byte struct:
// u64 wall_ms, u32 dur_us, u16 status, u8 rung, u8 method, i16 tenant,
// u16 tp_len, u16 path_len, 2 pad, char tp[64], char path[96].
int64_t hf_drain_trace(void* h, uint8_t* out, int64_t cap) {
  Front* f = (Front*)h;
  std::vector<TraceEvent> evs;
  {
    std::lock_guard<std::mutex> lk(f->s_mu);
    evs.swap(f->events);
  }
  constexpr int64_t kRec = 184;
  int64_t n = 0;
  uint8_t* p = out;
  for (const TraceEvent& e : evs) {
    if ((n + 1) * kRec > cap) break;
    memset(p, 0, kRec);
    memcpy(p, &e.wall_ms, 8);
    memcpy(p + 8, &e.dur_us, 4);
    memcpy(p + 12, &e.status, 2);
    p[14] = e.rung;
    p[15] = e.method;
    memcpy(p + 16, &e.tenant, 2);
    memcpy(p + 18, &e.tp_len, 2);
    memcpy(p + 20, &e.path_len, 2);
    memcpy(p + 24, e.tp, e.tp_len);
    memcpy(p + 88, e.path, e.path_len);
    p += kRec;
    ++n;
  }
  return n;
}

}  // extern "C"
