// Host-side loops of the port (dlimgedit_tpu_torch), C ABI, no Python
// dependency; a copy of what the port uses of the JAX package's
// native/src/hostops.cpp.
//
// The one host op on the Segmentation.process path is the channel-map
// pack: raw uint8 pixels (rgb/rgba/bgra/argb/mask, any row stride) -> RGB
// triplets in the top-left corner of a bucketed canvas, which is then
// copied to the device (ops/preprocess.py). numpy does it as three strided
// slice copies; this loop does it in one pass.
//
// Built at first use by dlimgedit_tpu_torch/utils/hostops.py with
// `g++ -O3 -shared -fPIC -pthread`. The loops are written so -O3
// auto-vectorizes them (contiguous writes, constant shuffle indices per
// specialization); rows are split over a small persistent thread pool
// (spawning threads per call would cost as much as the pack).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#if defined(_WIN32)
#define DLIMG_HOSTOPS_API extern "C" __declspec(dllexport)
#else
#define DLIMG_HOSTOPS_API extern "C" __attribute__((visibility("default")))
#endif

namespace {

// ---------------------------------------------------------------------------
// Minimal persistent row pool.  Each parallel_rows call allocates its own
// Job (part counter + completion counter) and workers hold a shared_ptr to
// it, so a laggard worker from job N can never touch job N+1's counters or
// call a dangling row function.  Calls are serialized by submit_mu_ (ctypes
// releases the GIL, so two Python threads CAN get here concurrently).
class RowPool {
 public:
  static RowPool& instance() {
    static RowPool pool;
    return pool;
  }

  void parallel_rows(int rows, int want_threads,
                     const std::function<void(int, int)>& fn) {
    int parts = want_threads < 1 ? 1 : want_threads;
    if (parts > rows) parts = rows;
    if (parts > 1 + static_cast<int>(workers_.size()))
      parts = 1 + static_cast<int>(workers_.size());
    if (parts <= 1) {
      if (rows > 0) fn(0, rows);
      return;
    }
    std::lock_guard<std::mutex> submit_lk(submit_mu_);
    auto job = std::make_shared<Job>();
    job->fn = &fn;
    job->rows = rows;
    job->parts = parts;
    job->pending.store(parts, std::memory_order_relaxed);
    {
      std::unique_lock<std::mutex> lk(mu_);
      job_ = job;
      ++epoch_;
      cv_.notify_all();
    }
    drain(*job);  // the caller works too
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return job->pending.load() == 0; });
  }

 private:
  struct Job {
    const std::function<void(int, int)>* fn;
    int rows, parts;
    std::atomic<int> next{0};
    std::atomic<int> pending{0};
  };

  RowPool() {
    unsigned hw = std::thread::hardware_concurrency();
    int n = hw > 1 ? static_cast<int>(hw) - 1 : 0;
    if (n > 7) n = 7;  // the pack is memory-bound; >8 ways stops scaling
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { worker_loop(); });
  }

  ~RowPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      cv_.notify_all();
    }
    for (auto& t : workers_) t.join();
  }

  // Claim and run parts until the job is exhausted.  The completion count
  // is decremented only AFTER the part's rows ran, so parallel_rows cannot
  // return (and invalidate fn) while any part is still executing.
  void drain(Job& job) {
    int part;
    while ((part = job.next.fetch_add(1, std::memory_order_relaxed)) <
           job.parts) {
      int chunk = (job.rows + job.parts - 1) / job.parts;
      int lo = part * chunk;
      int hi = lo + chunk > job.rows ? job.rows : lo + chunk;
      if (lo < hi) (*job.fn)(lo, hi);
      if (job.pending.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.notify_all();
      }
    }
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || epoch_ != seen; });
        if (stop_) return;
        seen = epoch_;
        job = job_;
      }
      if (job) drain(*job);
    }
  }

  std::vector<std::thread> workers_;
  std::mutex submit_mu_;  // one job in flight at a time
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::shared_ptr<Job> job_;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

// One row of the pack, specialized so the shuffle indices are compile-time
// constants and -O3 emits SIMD byte shuffles.
template <int SRC_C, int M0, int M1, int M2>
inline void pack_row(const uint8_t* __restrict s, uint8_t* __restrict d,
                     int w) {
  for (int x = 0; x < w; ++x) {
    d[3 * x + 0] = s[SRC_C * x + M0];
    d[3 * x + 1] = s[SRC_C * x + M1];
    d[3 * x + 2] = s[SRC_C * x + M2];
  }
}

void pack_row_generic(const uint8_t* s, uint8_t* d, int w, int src_c, int m0,
                      int m1, int m2) {
  for (int x = 0; x < w; ++x) {
    d[3 * x + 0] = s[src_c * x + m0];
    d[3 * x + 1] = s[src_c * x + m1];
    d[3 * x + 2] = s[src_c * x + m2];
  }
}

}  // namespace

// Pack the channel-mapped RGB image into dst (row stride dst_stride bytes).
// src rows are src_stride bytes apart; pixels are src_c bytes; output pixel
// channel k takes source channel mk.  Covers every RGB_CHANNEL_MAP entry
// (dlimgedit_tpu_torch/types.py): rgb/rgba (0,1,2), bgra (2,1,0), argb (1,2,3),
// mask (0,0,0).  threads<=0 picks automatically.
DLIMG_HOSTOPS_API void dlimg_hostops_pack_rgb(
    const uint8_t* src, int64_t src_stride, int h, int w, int src_c, int m0,
    int m1, int m2, uint8_t* dst, int64_t dst_stride, int threads) {
  if (threads <= 0) {
    // Memory-bound: one thread per ~512 KB of output, capped by the pool.
    int64_t out_bytes = static_cast<int64_t>(h) * w * 3;
    threads = static_cast<int>(out_bytes >> 19) + 1;
    if (threads > 8) threads = 8;
  }
  auto rows = [&](int lo, int hi) {
    for (int y = lo; y < hi; ++y) {
      const uint8_t* s = src + y * src_stride;
      uint8_t* d = dst + y * dst_stride;
      if (src_c == 3 && m0 == 0 && m1 == 1 && m2 == 2) {
        std::memcpy(d, s, static_cast<size_t>(w) * 3);
      } else if (src_c == 4 && m0 == 0 && m1 == 1 && m2 == 2) {
        pack_row<4, 0, 1, 2>(s, d, w);  // rgba
      } else if (src_c == 4 && m0 == 2 && m1 == 1 && m2 == 0) {
        pack_row<4, 2, 1, 0>(s, d, w);  // bgra
      } else if (src_c == 4 && m0 == 1 && m1 == 2 && m2 == 3) {
        pack_row<4, 1, 2, 3>(s, d, w);  // argb
      } else if (src_c == 1) {
        pack_row<1, 0, 0, 0>(s, d, w);  // mask -> grey RGB
      } else {
        pack_row_generic(s, d, w, src_c, m0, m1, m2);
      }
    }
  };
  RowPool::instance().parallel_rows(h, threads, rows);
}

namespace {

// Per-axis box-filter taps, mirroring image/resize.py filter_matrix
// (kernel "box", support 0.5): output centre i maps to (i+0.5)/scale-0.5,
// the kernel is stretched by min(scale, 1) when minifying, each row is
// normalised, and out-of-range taps clamp to the edge.
struct AxisTaps {
  int width = 0;
  std::vector<int> lo;    // first tap per output index
  std::vector<double> w;  // (n_out, width) row-major, normalised
};

AxisTaps box_taps(int n_in, int n_out) {
  AxisTaps t;
  double scale = double(n_out) / double(n_in);
  double kscale = scale < 1.0 ? scale : 1.0;
  double radius = 0.5 / kscale;
  t.lo.resize(n_out);
  std::vector<double> centers(n_out);
  for (int i = 0; i < n_out; ++i) {
    centers[i] = (i + 0.5) / scale - 0.5;
    t.lo[i] = int(std::floor(centers[i] - radius));
    int hi = int(std::ceil(centers[i] + radius));
    if (hi - t.lo[i] + 1 > t.width) t.width = hi - t.lo[i] + 1;
  }
  t.w.assign(size_t(n_out) * t.width, 0.0);
  for (int i = 0; i < n_out; ++i) {
    double sum = 0.0;
    for (int k = 0; k < t.width; ++k) {
      double x = (double(t.lo[i] + k) - centers[i]) * kscale;
      double wv = (x >= -0.5 && x < 0.5) ? 1.0 : 0.0;
      t.w[size_t(i) * t.width + k] = wv;
      sum += wv;
    }
    double denom = sum > 1e-12 ? sum : 1e-12;
    for (int k = 0; k < t.width; ++k) t.w[size_t(i) * t.width + k] /= denom;
  }
  return t;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

// Single-channel box-filter resize (linear colourspace), the semantics of
// image/resize.py resize_mask:
// separable H-then-W double-precision resample of src/255, then
// clip(round-half-even(x*255)).  Agrees with the Python numpy path to
// within one grey level, differing only where the exact result is a .5
// tie (summation-order ulps flip round-half-even; ~0.1% of pixels on
// binary inputs).
DLIMG_HOSTOPS_API void dlimg_hostops_resize_mask_box(
    const uint8_t* src, int src_h, int src_w, int64_t src_stride,
    uint8_t* dst, int dst_h, int dst_w, int64_t dst_stride) {
  AxisTaps th = box_taps(src_h, dst_h);
  AxisTaps tw = box_taps(src_w, dst_w);
  int64_t out_bytes = int64_t(dst_h) * dst_w;
  int threads = int(out_bytes >> 19) + 1;
  if (threads > 8) threads = 8;
  auto rows = [&](int lo_row, int hi_row) {
    std::vector<double> tmp(src_w);
    for (int i = lo_row; i < hi_row; ++i) {
      // H pass: blend source rows into tmp.
      for (int x = 0; x < src_w; ++x) tmp[x] = 0.0;
      for (int k = 0; k < th.width; ++k) {
        double wv = th.w[size_t(i) * th.width + k];
        if (wv == 0.0) continue;
        const uint8_t* s =
            src + int64_t(clampi(th.lo[i] + k, 0, src_h - 1)) * src_stride;
        for (int x = 0; x < src_w; ++x) tmp[x] += wv * (s[x] / 255.0);
      }
      // W pass + u8 store.
      uint8_t* d = dst + int64_t(i) * dst_stride;
      for (int j = 0; j < dst_w; ++j) {
        double acc = 0.0;
        for (int k = 0; k < tw.width; ++k) {
          double wv = tw.w[size_t(j) * tw.width + k];
          if (wv != 0.0) acc += wv * tmp[clampi(tw.lo[j] + k, 0, src_w - 1)];
        }
        double v = std::nearbyint(acc * 255.0);  // round-half-even = np.round
        d[j] = uint8_t(v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v));
      }
    }
  };
  RowPool::instance().parallel_rows(dst_h, threads, rows);
}

// ABI version tag so the Python loader can refuse a stale cached build.
DLIMG_HOSTOPS_API int dlimg_hostops_abi_version() { return 2; }
