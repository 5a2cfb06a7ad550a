// dlimg-serve — HTTP serving daemon over the PyTorch port's native library.
//
// A copy of the JAX package's native/tools/serve.cpp, built against the
// port's library (dlimgedit_tpu_torch/native/, built by
// dlimgedit_tpu_torch/native_build.py); the request handling is the same.
// A small, dependency-free HTTP/1.1 server (POSIX sockets + a worker pool)
// exposing the library's interactive-segmentation session model — embed
// once, query masks cheaply — plus one-shot endpoints, over the port's
// embedded-Python PyTorch runtime (`--backend gpu` is cuda:0).
//
//   POST   /v1/sessions                   image bytes -> {"id","width","height"}
//   POST   /v1/sessions/<id>/mask?point=X,Y | box=X0,Y0,X1,Y1   -> PNG mask
//   POST   /v1/sessions/<id>/mask?point=X,Y&all=1 -> JSON 3 masks + accuracies
//   POST   /v1/sessions/<id>/auto-masks[?iou=F&stability=F&nms=F&max=N]
//                                         -> JSON all object masks, best-first
//   DELETE /v1/sessions/<id>              -> 204
//   POST   /v1/segment?point=X,Y          one-shot embed+mask -> PNG mask
//   POST   /v1/remove-bg[?cutout=1]       BiRefNet -> PNG mask (or RGBA cutout)
//   GET    /healthz                       -> "ok"
//   GET    /v1/info                       -> runtime mode / backend JSON
//   GET    /v1/stats                      -> request counts + latency JSON
//
// Connections are HTTP/1.1 keep-alive (pipelining-safe carry buffer;
// Connection: close honoured; 30 s idle timeout via SO_RCVTIMEO; 1000
// requests/connection cap so one client cannot pin a worker).
// Concurrency: the C ABI is thread-safe (thread-local error state, GIL
// discipline in embedded mode, lock-protected executable cache), so workers
// call it directly; sessions are shared_ptrs held in an LRU-capped map.
// The port captures a CUDA graph at the first call of each executable key
// (under a lock, on a side stream), so concurrent first calls are safe.
// With --batch-window-ms F (>0), concurrent single-prompt mask queries for
// the same session are micro-batched through one batched decode program
// (MaskBatcher below); /v1/stats then reports batched_calls /
// batched_prompts / largest_batch.
// Image bytes round-trip through mkstemp files (in $TMPDIR, else /tmp)
// because the stable ABI is path-based (same contract as the reference's
// stb layer) — a few tens of microseconds on tmpfs, irrelevant next to
// inference.

#include <dlimgedit/dlimgedit.hpp>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <csignal>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <random>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

constexpr size_t kMaxBody = 64u << 20;  // request body cap
// The runtime mode /v1/info and the startup line report: the Python-free
// serving bundle when DLIMG_PJRT_BUNDLE names one (the library then runs
// no interpreter), else the embedded interpreter.
char const* runtime_mode() {
    return std::getenv("DLIMG_PJRT_BUNDLE") ? "pytorch-bundle"
                                            : "embedded-python-pytorch";
}

// ---------------------------------------------------------------------------
// Small helpers
// ---------------------------------------------------------------------------

std::string temp_file(std::string const& suffix) {
    char const* dir = std::getenv("TMPDIR");
    std::string tmpl = std::string(dir && *dir ? dir : "/tmp") +
                       "/dlimg_serve_XXXXXX" + suffix;
    int fd = ::mkstemps(tmpl.data(), int(suffix.size()));
    if (fd < 0)
        throw dlimg::Exception("mkstemps failed");
    ::close(fd);
    return tmpl;
}

struct TempFile {  // RAII unlink
    std::string path;
    explicit TempFile(std::string const& suffix) : path(temp_file(suffix)) {}
    ~TempFile() { ::unlink(path.c_str()); }
    TempFile(TempFile const&) = delete;
    TempFile& operator=(TempFile const&) = delete;
};

void write_file(std::string const& path, std::string const& bytes) {
    std::FILE* f = std::fopen(path.c_str(), "wb");
    if (!f || std::fwrite(bytes.data(), 1, bytes.size(), f) != bytes.size()) {
        if (f)
            std::fclose(f);
        throw dlimg::Exception("failed to write " + path);
    }
    std::fclose(f);
}

std::string read_file(std::string const& path) {
    std::FILE* f = std::fopen(path.c_str(), "rb");
    if (!f)
        throw dlimg::Exception("failed to read " + path);
    std::string out;
    char buf[65536];
    size_t n;
    while ((n = std::fread(buf, 1, sizeof buf, f)) > 0)
        out.append(buf, n);
    std::fclose(f);
    return out;
}

std::string b64(std::string const& in) {
    static char const* tab =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    std::string out;
    out.reserve((in.size() + 2) / 3 * 4);
    for (size_t i = 0; i < in.size(); i += 3) {
        uint32_t v = uint32_t(uint8_t(in[i])) << 16;
        if (i + 1 < in.size())
            v |= uint32_t(uint8_t(in[i + 1])) << 8;
        if (i + 2 < in.size())
            v |= uint8_t(in[i + 2]);
        out += tab[v >> 18];
        out += tab[(v >> 12) & 63];
        out += i + 1 < in.size() ? tab[(v >> 6) & 63] : '=';
        out += i + 2 < in.size() ? tab[v & 63] : '=';
    }
    return out;
}

std::string random_id() {
    static std::mutex mu;
    static std::mt19937_64 rng{std::random_device{}()};
    std::lock_guard<std::mutex> lock(mu);
    char buf[33];
    std::snprintf(buf, sizeof buf, "%016llx%016llx",
                  (unsigned long long)rng(), (unsigned long long)rng());
    return buf;
}

// ---------------------------------------------------------------------------
// HTTP types
// ---------------------------------------------------------------------------

struct Request {
    std::string method, path, query, body;
    std::unordered_map<std::string, std::string> params;  // parsed query
    bool keep_alive = true;  // HTTP/1.1 default; false on Connection: close
};

// Thrown for client-side faults (bad body, undecodable image) -> HTTP 400.
struct BadRequest : dlimg::Exception {
    using dlimg::Exception::Exception;
};

struct Response {
    int status = 200;
    std::string content_type = "application/json";
    std::string body;
    static Response json(int status, std::string body) {
        Response r;
        r.status = status;
        r.body = std::move(body);
        return r;
    }
    static Response error(int status, std::string const& msg) {
        std::string e;
        for (char c : msg)  // JSON-escape the message minimally
            if (c == '"' || c == '\\')
                (e += '\\') += c;
            else if (uint8_t(c) >= 0x20)
                e += c;
        return json(status, "{\"error\":\"" + e + "\"}");
    }
    static Response png(std::string bytes) {
        Response r;
        r.content_type = "image/png";
        r.body = std::move(bytes);
        return r;
    }
};

char const* status_text(int s) {
    switch (s) {
    case 200: return "OK";
    case 204: return "No Content";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 413: return "Payload Too Large";
    default: return "Internal Server Error";
    }
}

void parse_query(Request& req) {
    size_t pos = 0;
    while (pos < req.query.size()) {
        size_t amp = req.query.find('&', pos);
        std::string kv = req.query.substr(
            pos, amp == std::string::npos ? std::string::npos : amp - pos);
        size_t eq = kv.find('=');
        if (eq != std::string::npos)
            req.params[kv.substr(0, eq)] = kv.substr(eq + 1);
        else if (!kv.empty())
            req.params[kv] = "";
        if (amp == std::string::npos)
            break;
        pos = amp + 1;
    }
}

// Read one HTTP/1.1 request from fd. Returns false on close/parse failure;
// sets *too_large when the declared body exceeds kMaxBody. `carry` holds
// bytes read past the previous request on the same connection (pipelined
// clients) — consumed first, and refilled with this request's excess, so
// keep-alive never drops queued bytes.
bool read_request(int fd, Request* req, bool* too_large,
                  std::string* carry) {
    std::string data = std::move(*carry);
    carry->clear();
    char buf[16384];
    size_t header_end;
    for (;;) {
        header_end = data.find("\r\n\r\n");
        if (header_end != std::string::npos)
            break;
        if (data.size() > 1 << 20)
            return false;  // absurd header
        ssize_t n = ::recv(fd, buf, sizeof buf, 0);
        if (n <= 0)
            return false;
        data.append(buf, size_t(n));
    }
    // Request line.
    size_t line_end = data.find("\r\n");
    std::string line = data.substr(0, line_end);
    size_t sp1 = line.find(' '), sp2 = line.rfind(' ');
    if (sp1 == std::string::npos || sp2 <= sp1)
        return false;
    req->method = line.substr(0, sp1);
    // HTTP/1.0 defaults to close (no persistent connections unless the
    // client asks); HTTP/1.1 defaults to keep-alive.
    if (line.substr(sp2 + 1) == "HTTP/1.0")
        req->keep_alive = false;
    std::string target = line.substr(sp1 + 1, sp2 - sp1 - 1);
    size_t q = target.find('?');
    req->path = target.substr(0, q);
    if (q != std::string::npos)
        req->query = target.substr(q + 1);
    parse_query(*req);
    // Content-Length + Connection (case-insensitive scan of the headers).
    size_t content_length = 0;
    {
        std::string headers = data.substr(line_end + 2,
                                          header_end - line_end - 2);
        std::string lower;
        lower.reserve(headers.size());
        for (char c : headers)
            lower += char(std::tolower(uint8_t(c)));
        size_t cl = lower.find("content-length:");
        if (cl != std::string::npos) {
            content_length = std::strtoull(
                headers.c_str() + cl + 15, nullptr, 10);
        }
        size_t cn = lower.find("connection:");
        if (cn != std::string::npos) {
            // Bound the value search to THIS header's line: an unbounded
            // find would match 'close' inside a later header (e.g. a
            // User-Agent containing the substring).
            size_t eol = lower.find("\r\n", cn);
            std::string val = lower.substr(
                cn + 11, (eol == std::string::npos ? lower.size() : eol) -
                             cn - 11);
            if (val.find("close") != std::string::npos)
                req->keep_alive = false;
            else if (val.find("keep-alive") != std::string::npos)
                req->keep_alive = true;  // HTTP/1.0 opt-in
        }
    }
    if (content_length > kMaxBody) {
        *too_large = true;
        return false;
    }
    size_t body_start = header_end + 4;
    req->body = data.substr(body_start);
    while (req->body.size() < content_length) {
        ssize_t n = ::recv(fd, buf, sizeof buf, 0);
        if (n <= 0)
            return false;
        req->body.append(buf, size_t(n));
    }
    if (req->body.size() > content_length) {  // pipelined next request
        *carry = req->body.substr(content_length);
        req->body.resize(content_length);
    }
    return true;
}

void send_response(int fd, Response const& r, bool keep_alive) {
    char const* conn = keep_alive ? "keep-alive" : "close";
    char head[256];
    int n;
    if (r.status == 204)  // RFC 9110: 204 carries no body and no length
        n = std::snprintf(head, sizeof head,
                          "HTTP/1.1 204 No Content\r\nConnection: %s\r\n\r\n",
                          conn);
    else
        n = std::snprintf(head, sizeof head,
                          "HTTP/1.1 %d %s\r\n"
                          "Content-Type: %s\r\n"
                          "Content-Length: %zu\r\n"
                          "Connection: %s\r\n\r\n",
                          r.status, status_text(r.status),
                          r.content_type.c_str(), r.body.size(), conn);
    std::string out(head, size_t(n));
    out += r.body;
    size_t sent = 0;
    while (sent < out.size()) {
        ssize_t w = ::send(fd, out.data() + sent, out.size() - sent,
                           MSG_NOSIGNAL);
        if (w <= 0)
            return;
        sent += size_t(w);
    }
}

// ---------------------------------------------------------------------------
// Stats
// ---------------------------------------------------------------------------

class Stats {
  public:
    void record(std::string const& endpoint, double ms, bool ok) {
        std::lock_guard<std::mutex> lock(mu_);
        auto& e = per_[endpoint];
        e.count += 1;
        e.errors += ok ? 0 : 1;
        e.total_ms += ms;
        e.recent.push_back(ms);
        if (e.recent.size() > 256)
            e.recent.pop_front();
    }

    std::string to_json(double uptime_s) const {
        std::lock_guard<std::mutex> lock(mu_);
        std::string out = "{\"uptime_s\":" + fmt(uptime_s) + ",\"endpoints\":{";
        bool first = true;
        for (auto const& [name, e] : per_) {
            if (!first)
                out += ",";
            first = false;
            std::vector<double> v(e.recent.begin(), e.recent.end());
            std::sort(v.begin(), v.end());
            auto pct = [&](double p) {
                return v.empty() ? 0.0 : v[size_t(p * (v.size() - 1))];
            };
            out += "\"" + name + "\":{\"count\":" + std::to_string(e.count) +
                   ",\"errors\":" + std::to_string(e.errors) +
                   ",\"mean_ms\":" + fmt(e.count ? e.total_ms / e.count : 0) +
                   ",\"p50_ms\":" + fmt(pct(0.5)) +
                   ",\"p95_ms\":" + fmt(pct(0.95)) + "}";
        }
        return out + "}}";
    }

  private:
    static std::string fmt(double v) {
        char buf[32];
        std::snprintf(buf, sizeof buf, "%.3f", v);
        return buf;
    }
    struct Entry {
        uint64_t count = 0, errors = 0;
        double total_ms = 0;
        std::deque<double> recent;
    };
    mutable std::mutex mu_;
    std::unordered_map<std::string, Entry> per_;
};

// ---------------------------------------------------------------------------
// Session store (LRU-capped)
// ---------------------------------------------------------------------------

class Sessions {
  public:
    explicit Sessions(size_t cap) : cap_(cap) {}

    // Called with the raw Segmentation handle of every session leaving the
    // store (DELETE or LRU eviction) — lets dependents drop per-session
    // state keyed on it.
    void set_on_evict(std::function<void(void*)> fn) {
        on_evict_ = std::move(fn);
    }

    std::string add(dlimg::Segmentation seg) {
        std::lock_guard<std::mutex> lock(mu_);
        std::string id = random_id();
        map_.emplace(id, Entry{std::make_shared<dlimg::Segmentation>(
                                   std::move(seg)),
                               ++tick_});
        while (map_.size() > cap_) {  // evict least-recently-used
            auto lru = map_.begin();
            for (auto it = map_.begin(); it != map_.end(); ++it)
                if (it->second.last_used < lru->second.last_used)
                    lru = it;
            if (on_evict_)
                on_evict_(lru->second.seg.get());
            map_.erase(lru);
        }
        return id;
    }

    std::shared_ptr<dlimg::Segmentation> get(std::string const& id) {
        std::lock_guard<std::mutex> lock(mu_);
        auto it = map_.find(id);
        if (it == map_.end())
            return nullptr;
        it->second.last_used = ++tick_;
        return it->second.seg;
    }

    bool remove(std::string const& id) {
        std::lock_guard<std::mutex> lock(mu_);
        auto it = map_.find(id);
        if (it == map_.end())
            return false;
        if (on_evict_)
            on_evict_(it->second.seg.get());
        map_.erase(it);
        return true;
    }

    size_t size() const {
        std::lock_guard<std::mutex> lock(mu_);
        return map_.size();
    }

  private:
    struct Entry {
        std::shared_ptr<dlimg::Segmentation> seg;
        uint64_t last_used;
    };
    mutable std::mutex mu_;
    std::unordered_map<std::string, Entry> map_;
    size_t cap_;
    uint64_t tick_ = 0;
    std::function<void(void*)> on_evict_;
};

// ---------------------------------------------------------------------------
// Per-session prompt micro-batcher
// ---------------------------------------------------------------------------
//
// Routes concurrent single-prompt mask queries for the SAME session through
// one batched decode program (Segmentation::compute_mask_batch — one device
// dispatch + one fetch for the whole group) instead of one program per
// request.
//
// Batching is EXECUTION-GATED (continuous batching), not fixed-window:
// while a batch for a session is in flight, every arrival for that session
// queues into the next generation, and when the in-flight batch returns the
// whole queue ships as one program. Under sustained concurrency the batch
// size therefore converges on the per-session queue depth with no added
// latency. The --batch-window-ms value is only the IDLE grace: when nothing
// is in flight, the first arrival waits that long for near-simultaneous
// peers before dispatching (a fixed sleep-window design measured on chip
// grouped almost nothing — arrivals synchronize to completions, so the
// in-flight period, not a timer, is the natural collection window).
class MaskBatcher {
  public:
    MaskBatcher(double window_ms, int batch_max)
        : window_ms_(window_ms), batch_max_(size_t(batch_max)) {}

    struct Counters {
        uint64_t calls = 0;     // batched device dispatches
        uint64_t prompts = 0;   // prompts served through them
        uint64_t largest = 0;   // largest batch so far
    };

    dlimg::Segmentation::Mask
    compute(std::shared_ptr<dlimg::Segmentation> const& seg,
            dlimg::Segmentation::Prompt const& prompt) {
        void* key = seg.get();
        std::shared_ptr<Gen> gen;
        std::shared_ptr<Entry> entry;
        size_t idx;
        bool leader = false;
        {
            std::unique_lock<std::mutex> lock(mu_);
            auto& slot = state_[key];
            if (!slot)
                slot = std::make_shared<Entry>();
            entry = slot;
            // A full generation stops accepting; later arrivals start the
            // next one (bounds the batch to the largest pre-warmed padded
            // program — an unbounded batch discovers new padded sizes at
            // runtime, each a first run and a CUDA-graph capture).
            if (entry->open && entry->open->prompts.size() >= batch_max_)
                entry->open = nullptr;
            if (!entry->open) {
                entry->open = std::make_shared<Gen>();
                leader = true;
            }
            gen = entry->open;
            idx = gen->prompts.size();
            gen->prompts.push_back(prompt);
            if (leader) {
                if (!entry->busy && window_ms_ > 0) {
                    // Idle: give near-simultaneous peers a brief window.
                    lock.unlock();
                    std::this_thread::sleep_for(
                        std::chrono::duration<double, std::milli>(
                            window_ms_));
                    lock.lock();
                }
                // Collect for as long as an in-flight batch runs. Checked
                // (again) AFTER the idle sleep: another leader can have
                // started during the unlocked window (its gen filled to
                // batch_max and a later arrival opened this one), and
                // proceeding unconditionally would dispatch two batches
                // concurrently and corrupt the busy flag.
                if (entry->busy)
                    entry->busy_cv.wait(lock,
                                        [&] { return !entry->busy; });
                if (entry->open == gen)
                    entry->open = nullptr;  // later arrivals: next gen
                entry->busy = true;
            }
        }
        if (leader) {
            std::vector<dlimg::Segmentation::Mask> results;
            std::string error;
            try {
                results = seg->compute_mask_batch(gen->prompts);
            } catch (std::exception const& e) {
                error = e.what();
            }
            {
                std::lock_guard<std::mutex> lock(mu_);
                gen->results = std::move(results);
                gen->error = std::move(error);
                gen->done = true;
                entry->busy = false;
                counters_.calls += 1;
                counters_.prompts += gen->prompts.size();
                counters_.largest = std::max(counters_.largest,
                                             uint64_t(gen->prompts.size()));
            }
            gen->cv.notify_all();
            entry->busy_cv.notify_all();
        } else {
            std::unique_lock<std::mutex> lock(mu_);
            gen->cv.wait(lock, [&] { return gen->done; });
        }
        std::lock_guard<std::mutex> lock(mu_);
        if (!gen->error.empty())
            throw dlimg::Exception(gen->error);
        // Each waiter owns exactly one slot, so moving out is safe.
        return std::move(gen->results[idx]);
    }

    Counters counters() const {
        std::lock_guard<std::mutex> lock(mu_);
        return counters_;
    }

    // Drop a session's batching state when the session is deleted or
    // LRU-evicted. In-flight leaders/waiters keep their own shared_ptrs, so
    // erasing the map entry is safe mid-batch; without this the map leaks
    // one Entry per session AND a new session allocated at a recycled
    // address would inherit a dead session's state.
    void forget(void* key) {
        std::lock_guard<std::mutex> lock(mu_);
        state_.erase(key);
    }

  private:
    struct Gen {
        std::vector<dlimg::Segmentation::Prompt> prompts;
        std::vector<dlimg::Segmentation::Mask> results;
        std::string error;
        bool done = false;
        std::condition_variable cv;
    };
    struct Entry {                // per-session batching state
        std::shared_ptr<Gen> open;  // collecting generation (if any)
        bool busy = false;          // a batch for this session in flight
        std::condition_variable busy_cv;
    };
    double window_ms_;
    size_t batch_max_;
    mutable std::mutex mu_;
    std::unordered_map<void*, std::shared_ptr<Entry>> state_;
    Counters counters_;
};

// ---------------------------------------------------------------------------
// Server
// ---------------------------------------------------------------------------

std::atomic<bool> g_stop{false};

void on_signal(int) { g_stop = true; }

struct Config {
    std::string host = "127.0.0.1";
    int port = 8080;
    std::string backend = "auto";
    std::string models = "models";
    int threads = 4;
    size_t max_sessions = 8;
    double batch_window_ms = 0;  // >0 enables per-session prompt batching
    int batch_max = 8;           // cap on one batched dispatch (pow2)
    bool batch_warm = false;     // warm the pow2 batch programs on
                                 // first session per image size
};

class Server {
  public:
    explicit Server(Config cfg)
        : cfg_(std::move(cfg)), sessions_(cfg_.max_sessions),
          start_(Clock::now()) {
        using namespace dlimg;
        Options opts;
        if (cfg_.backend == "cpu")
            opts.backend = Backend::cpu;
        else if (cfg_.backend == "gpu")
            opts.backend = Backend::gpu;
        else
            opts.backend = Environment::is_supported(Backend::gpu)
                               ? Backend::gpu
                               : Backend::cpu;
        backend_name_ = opts.backend == Backend::gpu ? "gpu" : "cpu";
        opts.model_directory = cfg_.models.c_str();
        env_ = std::make_unique<Environment>(opts);
        if (cfg_.batch_window_ms > 0) {
            batcher_ = std::make_unique<MaskBatcher>(cfg_.batch_window_ms,
                                                     cfg_.batch_max);
            sessions_.set_on_evict(
                [this](void* key) { batcher_->forget(key); });
        }
    }

    int run() {
        int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
        if (lfd < 0)
            return perror("socket"), 1;
        int one = 1;
        ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_port = htons(uint16_t(cfg_.port));
        if (::inet_pton(AF_INET, cfg_.host.c_str(), &addr.sin_addr) != 1)
            return std::fprintf(stderr, "bad host %s\n", cfg_.host.c_str()), 1;
        if (::bind(lfd, (sockaddr*)&addr, sizeof addr) < 0)
            return perror("bind"), 1;
        if (::listen(lfd, 64) < 0)
            return perror("listen"), 1;
        socklen_t alen = sizeof addr;
        ::getsockname(lfd, (sockaddr*)&addr, &alen);
        // Parseable startup line (tests read the bound port from it).
        std::printf("dlimg-serve listening on %s:%d backend=%s mode=%s\n",
                    cfg_.host.c_str(), int(ntohs(addr.sin_port)),
                    backend_name_.c_str(), runtime_mode());
        std::fflush(stdout);

        std::vector<std::thread> workers;
        for (int i = 0; i < cfg_.threads; ++i)
            workers.emplace_back([this] { worker(); });

        // Accept loop; a short timeout lets us notice g_stop.
        timeval tv{0, 200000};
        ::setsockopt(lfd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
        while (!g_stop) {
            int cfd = ::accept(lfd, nullptr, nullptr);
            if (cfd < 0)
                continue;
            timeval io{30, 0};  // per-connection I/O timeout
            ::setsockopt(cfd, SOL_SOCKET, SO_RCVTIMEO, &io, sizeof io);
            ::setsockopt(cfd, SOL_SOCKET, SO_SNDTIMEO, &io, sizeof io);
            {
                std::lock_guard<std::mutex> lock(qmu_);
                queue_.push_back(cfd);
            }
            qcv_.notify_one();
        }
        ::close(lfd);
        qcv_.notify_all();
        for (auto& w : workers)
            w.join();
        {  // drain queued-but-unserved connections
            std::lock_guard<std::mutex> lock(qmu_);
            for (int fd : queue_)
                ::close(fd);
        }
        return 0;
    }

  private:
    void worker() {
        for (;;) {
            int fd;
            {
                std::unique_lock<std::mutex> lock(qmu_);
                qcv_.wait(lock,
                          [this] { return g_stop || !queue_.empty(); });
                if (queue_.empty())
                    return;  // g_stop
                fd = queue_.front();
                queue_.pop_front();
            }
            handle_connection(fd);
            ::close(fd);
        }
    }

    // Between keep-alive requests, wait for data in short poll slices so
    // an IDLE persistent connection cannot pin a worker while other
    // clients queue: with no bytes pending and connections waiting in
    // queue_, the worker closes this one (the client reconnects) and
    // serves the queue. Returns false when the connection should close.
    bool await_next_request(int fd, std::string const& carry) {
        if (!carry.empty())
            return true;  // pipelined bytes already buffered
        for (int waited_ms = 0; waited_ms < 30000 && !g_stop;
             waited_ms += 100) {
            pollfd pfd{fd, POLLIN, 0};
            int r = ::poll(&pfd, 1, 100);
            if (r < 0)
                return false;
            if (r > 0)
                return !(pfd.revents & (POLLERR | POLLNVAL));
            std::lock_guard<std::mutex> lock(qmu_);
            if (!queue_.empty())
                return false;  // yield the worker to waiting clients
        }
        return false;  // idle timeout / shutdown
    }

    // Serve requests on one connection until the client closes, asks to
    // (Connection: close), errs, or hits the per-connection cap (an
    // anti-starvation bound: one chatty client cannot hold a worker
    // forever; the next connect re-queues it behind other clients).
    void handle_connection(int fd) {
        std::string carry;
        for (int served = 0; served < 1000 && !g_stop; ++served) {
            if (served > 0 && !await_next_request(fd, carry))
                return;
            Request req;
            bool too_large = false;
            if (!read_request(fd, &req, &too_large, &carry)) {
                if (too_large)
                    send_response(fd, Response::error(413, "body too large"),
                                  false);
                return;
            }
            auto t0 = Clock::now();
            Response resp;
            try {
                resp = route(req);
            } catch (BadRequest const& e) {
                resp = Response::error(400, e.what());
            } catch (std::exception const& e) {
                resp = Response::error(500, e.what());
            }
            double ms = std::chrono::duration<double, std::milli>(
                            Clock::now() - t0)
                            .count();
            stats_.record(req.method + " " + stat_key(req.path), ms,
                          resp.status < 400);
            // At the per-connection cap the LAST response must advertise
            // close — closing after a keep-alive response makes clients
            // see a mid-stream disconnect.
            bool const last = served + 1 >= 1000 || g_stop;
            send_response(fd, resp, req.keep_alive && !last);
            if (!req.keep_alive || last)
                return;
        }
    }

    // Warm every padded batch-decode program this server can reach (pow2
    // up to --batch-max) the first time a given image size appears —
    // otherwise a new batch size discovered under live traffic stalls the
    // whole queue on that program's first run and CUDA-graph capture.
    void warm_batch_programs(dlimg::Segmentation const& seg,
                             dlimg::Extent e) {
        uint64_t key = (uint64_t(uint32_t(e.width)) << 32) |
                       uint32_t(e.height);
        {
            std::lock_guard<std::mutex> lock(warm_mu_);
            if (warmed_.count(key))
                return;
        }
        using namespace dlimg;
        Point center{e.width / 2, e.height / 2};
        Region box{Point{e.width / 4, e.height / 4},
                   Point{3 * e.width / 4, 3 * e.height / 4}};
        // Padded pow2 sizes from 1 up to and including ceil_pow2(max);
        // point AND box batches (a box prompt can select a different
        // largest-component executable family — both must be hot).
        for (int n = 1; ; n *= 2) {
            std::vector<Segmentation::Prompt> prompts;
            prompts.assign(size_t(std::min(n, cfg_.batch_max)),
                           Segmentation::Prompt(center));
            seg.compute_mask_batch(prompts);
            prompts.assign(size_t(std::min(n, cfg_.batch_max)),
                           Segmentation::Prompt(box));
            seg.compute_mask_batch(prompts);
            if (n >= cfg_.batch_max)
                break;
        }
        // Mark warmed only on success so a failed warm is retried by the
        // next session of this size.
        std::lock_guard<std::mutex> lock(warm_mu_);
        warmed_.insert(key);
    }

    // Collapse session ids out of the stats key.
    static std::string stat_key(std::string const& path) {
        if (path.rfind("/v1/sessions/", 0) == 0) {
            size_t tail = path.rfind('/');
            return tail > 12 ? "/v1/sessions/<id>" + path.substr(tail)
                             : "/v1/sessions/<id>";
        }
        return path;
    }

    Response route(Request const& req) {
        using namespace dlimg;
        if (req.path == "/healthz")
            return Response::json(200, "ok");
        if (req.path == "/v1/info") {
            return Response::json(
                200, std::string("{\"backend\":\"") + backend_name_ +
                         "\",\"mode\":\"" + runtime_mode() +
                         "\",\"sessions\":" +
                         std::to_string(sessions_.size()) +
                         ",\"max_sessions\":" +
                         std::to_string(cfg_.max_sessions) + "}");
        }
        if (req.path == "/v1/stats") {
            double up = std::chrono::duration<double>(Clock::now() - start_)
                            .count();
            std::string out = stats_.to_json(up);
            if (batcher_) {  // splice batching counters into the JSON root
                auto c = batcher_->counters();
                out.insert(out.size() - 1,
                           ",\"batched_calls\":" + std::to_string(c.calls) +
                               ",\"batched_prompts\":" +
                               std::to_string(c.prompts) +
                               ",\"largest_batch\":" +
                               std::to_string(c.largest));
            }
            return Response::json(200, out);
        }
        if (req.path == "/v1/sessions")
            return expect(req, "POST") ? create_session(req)
                                       : Response::error(405, "POST only");
        if (req.path.rfind("/v1/sessions/", 0) == 0)
            return session_op(req);
        if (req.path == "/v1/segment")
            return expect(req, "POST") ? one_shot_segment(req)
                                       : Response::error(405, "POST only");
        if (req.path == "/v1/remove-bg")
            return expect(req, "POST") ? remove_bg(req)
                                       : Response::error(405, "POST only");
        return Response::error(404, "no such endpoint");
    }

    static bool expect(Request const& req, char const* method) {
        return req.method == method;
    }

    dlimg::Image decode_body(Request const& req) {
        if (req.body.empty())
            throw BadRequest("empty request body (expected image bytes)");
        TempFile tmp(".img");
        write_file(tmp.path, req.body);
        try {
            return dlimg::Image::load(tmp.path.c_str());
        } catch (dlimg::Exception const& e) {
            throw BadRequest(std::string("undecodable image: ") + e.what());
        }
    }

    static std::string encode_png(dlimg::ImageView const& view) {
        TempFile tmp(".png");
        dlimg::Image::save(view, tmp.path.c_str());
        return read_file(tmp.path);
    }

    Response create_session(Request const& req) {
        using namespace dlimg;
        Image img = decode_body(req);
        auto seg = Segmentation::process(ImageView(img), *env_);
        auto e = seg.extent();
        if (batcher_ && cfg_.batch_warm)
            warm_batch_programs(seg, e);
        std::string id = sessions_.add(std::move(seg));
        return Response::json(200, "{\"id\":\"" + id +
                                       "\",\"width\":" +
                                       std::to_string(e.width) +
                                       ",\"height\":" +
                                       std::to_string(e.height) + "}");
    }

    // Parse ?point=X,Y or ?box=X0,Y0,X1,Y1 into a prompt.
    static bool parse_prompt(Request const& req, int* v, bool* is_box) {
        auto point = req.params.find("point");
        auto box = req.params.find("box");
        char const* s = nullptr;
        int n = 0;
        if (point != req.params.end()) {
            s = point->second.c_str();
            n = 2;
            *is_box = false;
        } else if (box != req.params.end()) {
            s = box->second.c_str();
            n = 4;
            *is_box = true;
        } else {
            return false;
        }
        char const* p = s;
        for (int i = 0; i < n; ++i) {
            char* end = nullptr;
            v[i] = int(std::strtol(p, &end, 10));
            if (end == p)
                return false;
            p = end;
            if (i + 1 < n) {
                if (*p != ',')
                    return false;
                ++p;
            }
        }
        return *p == '\0';
    }

    Response mask_for(std::shared_ptr<dlimg::Segmentation> const& seg_ptr,
                      Request const& req) {
        using namespace dlimg;
        Segmentation const& seg = *seg_ptr;
        int v[4];
        bool is_box = false;
        if (!parse_prompt(req, v, &is_box))
            return Response::error(400,
                                   "need point=X,Y or box=X0,Y0,X1,Y1");
        if (req.params.count("all")) {
            if (is_box)
                return Response::error(400, "all=1 needs a point prompt");
            auto masks = seg.compute_masks(Point{v[0], v[1]});
            std::string out = "{\"masks\":[";
            for (int i = 0; i < 3; ++i) {
                char acc[32];
                std::snprintf(acc, sizeof acc, "%.4f", masks[i].accuracy);
                out += std::string(i ? "," : "") + "{\"accuracy\":" + acc +
                       ",\"png_base64\":\"" +
                       b64(encode_png(ImageView(masks[i].image))) + "\"}";
            }
            return Response::json(200, out + "]}");
        }
        if (batcher_) {
            Segmentation::Prompt prompt =
                is_box ? Segmentation::Prompt(Region{Point{v[0], v[1]},
                                                     Point{v[2], v[3]}})
                       : Segmentation::Prompt(Point{v[0], v[1]});
            auto mask = batcher_->compute(seg_ptr, prompt);
            return Response::png(encode_png(ImageView(mask.image)));
        }
        Image mask = is_box ? seg.compute_mask(Region{Point{v[0], v[1]},
                                                      Point{v[2], v[3]}})
                            : seg.compute_mask(Point{v[0], v[1]});
        return Response::png(encode_png(ImageView(mask)));
    }

    Response session_op(Request const& req) {
        std::string rest = req.path.substr(13);  // after /v1/sessions/
        size_t slash = rest.find('/');
        std::string id = rest.substr(0, slash);
        std::string op =
            slash == std::string::npos ? "" : rest.substr(slash + 1);
        if (req.method == "DELETE" && op.empty())
            return sessions_.remove(id)
                       ? Response::json(204, "")
                       : Response::error(404, "no such session");
        if (req.method == "POST" && op == "mask") {
            auto seg = sessions_.get(id);
            if (!seg)
                return Response::error(404, "no such session");
            return mask_for(seg, req);
        }
        if (req.method == "POST" && op == "auto-masks") {
            auto seg = sessions_.get(id);
            if (!seg)
                return Response::error(404, "no such session");
            return auto_masks_for(*seg, req);
        }
        return Response::error(404, "no such endpoint");
    }

    // Automatic mask generation over a session
    // (Segmentation::generate_masks — one device program).
    static Response auto_masks_for(dlimg::Segmentation const& seg,
                                   Request const& req) {
        using namespace dlimg;
        auto num = [&](char const* key, float dflt) {
            auto it = req.params.find(key);
            return it == req.params.end() ? dflt
                                          : float(std::atof(
                                                it->second.c_str()));
        };
        float iou = num("iou", 0.88f);
        float stability = num("stability", 0.95f);
        float nms = num("nms", 0.7f);
        int max_masks = int(num("max", 64.0f));
        if (max_masks < 1 || max_masks > 1024)
            return Response::error(400, "max must be in [1, 1024]");
        auto masks = seg.generate_masks(iou, stability, nms, max_masks);
        std::string out = "{\"masks\":[";
        for (size_t i = 0; i < masks.size(); ++i) {
            char acc[32];
            std::snprintf(acc, sizeof acc, "%.4f", masks[i].accuracy);
            out += std::string(i ? "," : "") + "{\"accuracy\":" + acc +
                   ",\"png_base64\":\"" +
                   b64(encode_png(dlimg::ImageView(masks[i].image))) +
                   "\"}";
        }
        return Response::json(200, out + "]}");
    }

    Response one_shot_segment(Request const& req) {
        using namespace dlimg;
        int v[4];
        bool is_box = false;
        if (!parse_prompt(req, v, &is_box))
            return Response::error(400, "need point=X,Y or box=X0,Y0,X1,Y1");
        Image img = decode_body(req);
        auto seg = Segmentation::process(ImageView(img), *env_);
        Image mask = is_box ? seg.compute_mask(Region{Point{v[0], v[1]},
                                                      Point{v[2], v[3]}})
                            : seg.compute_mask(Point{v[0], v[1]});
        return Response::png(encode_png(ImageView(mask)));
    }

    Response remove_bg(Request const& req) {
        using namespace dlimg;
        Image img = decode_body(req);
        ImageView view(img);
        Image mask = segment_objects(view, *env_);
        if (!req.params.count("cutout"))
            return Response::png(encode_png(ImageView(mask)));
        Image out(view.extent, Channels::rgba);
        int const w = view.extent.width, h = view.extent.height;
        int const sc = count(view.channels);
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                uint8_t const* s =
                    view.pixels + size_t(y) * view.stride + size_t(x) * sc;
                uint8_t* d = out.pixels() + (size_t(y) * w + x) * 4;
                d[0] = s[0];
                d[1] = sc >= 3 ? s[1] : s[0];
                d[2] = sc >= 3 ? s[2] : s[0];
                d[3] = mask.pixels()[size_t(y) * w + x];
            }
        return Response::png(encode_png(ImageView(out)));
    }

    Config cfg_;
    std::unique_ptr<dlimg::Environment> env_;
    std::string backend_name_;
    Sessions sessions_;
    std::unique_ptr<MaskBatcher> batcher_;
    std::mutex warm_mu_;
    std::set<uint64_t> warmed_;
    Stats stats_;
    Clock::time_point start_;
    std::mutex qmu_;
    std::condition_variable qcv_;
    std::deque<int> queue_;
};

}  // namespace

int main(int argc, char** argv) {
    Config cfg;
    for (int i = 1; i < argc; ++i) {
        std::string arg = argv[i];
        auto next = [&]() -> char const* {
            if (i + 1 >= argc) {
                std::fprintf(stderr, "dlimg-serve: missing value for %s\n",
                             arg.c_str());
                std::exit(2);
            }
            return argv[++i];
        };
        if (arg == "--port")
            cfg.port = std::atoi(next());
        else if (arg == "--host")
            cfg.host = next();
        else if (arg == "--backend")
            cfg.backend = next();
        else if (arg == "--models")
            cfg.models = next();
        else if (arg == "--threads")
            cfg.threads = std::max(1, std::atoi(next()));
        else if (arg == "--max-sessions")
            cfg.max_sessions = size_t(std::max(1, std::atoi(next())));
        else if (arg == "--batch-window-ms")
            cfg.batch_window_ms = std::atof(next());
        else if (arg == "--batch-max")
            cfg.batch_max = std::max(1, std::atoi(next()));
        else if (arg == "--batch-warm")
            cfg.batch_warm = std::atoi(next()) != 0;
        else {
            std::fprintf(stderr,
                         "usage: dlimg-serve [--port N] [--host IP] "
                         "[--backend cpu|gpu|auto] [--models DIR] "
                         "[--threads N] [--max-sessions N] "
                         "[--batch-window-ms F] [--batch-max N] "
                         "[--batch-warm 0|1]\n");
            return 2;
        }
    }
    std::signal(SIGINT, on_signal);
    std::signal(SIGTERM, on_signal);
    std::signal(SIGPIPE, SIG_IGN);
    try {
        Server server(std::move(cfg));
        return server.run();
    } catch (dlimg::Exception const& e) {
        std::fprintf(stderr, "dlimg-serve: %s\n", e.what());
        return 1;
    }
}
