// Python-free serving end to end: the public C++ API (dlimgedit.hpp) over
// the port's serving library (DLIMG_PJRT_BUNDLE), no Python in the process
// (asserted), against the port's Python API on the same weights. The
// port's copy of the JAX package's native/test/test_serving.cpp.
//
//   test_serving [cpu|gpu] [--time N]
//
// DLIMG_PJRT_BUNDLE names the bundle (tools/aot_export.py --program
// serving) and DLIMG_SERVING_CHECK_DIR the goldens the Python API wrote
// (tools/serving_check.py):
//   meta.txt            "w h c" of image.raw
//   prompts.txt         n, then n rows "is_region x0 y0 x1 y1" (a point
//                       uses x0 y0)
//   golden_masks.raw    compute_mask of each prompt (n * w * h bytes)
//   golden_batch_iou.raw  compute_mask_batch's n accuracies (float32)
//   golden3.raw, golden3_iou.raw  compute_masks of the first point prompt
//   meta_small.txt      "w h c x y", image_small.raw, golden_small.raw: a
//                       non-square image in a smaller bucket and a point
//   image2.raw, golden2.raw  a second image of image.raw's size (and
//                       bucket) and the first point prompt's mask on it
// Legs: every prompt's mask, three masks and their accuracies, the small
// image, compute_mask_batch of every prompt, and two threads that process
// image.raw and image2.raw at once, round after round, each holding its
// own image's mask; masks byte-equal and accuracies bit-equal. Prints the K1 / K2 launches of each process (the
// serving library's counters; the main image once more, where its graph
// replays), holds every CUDA graph's replay against its
// eager run, and with --time N prints the medians of N process and
// compute_mask calls, one of each in turn. Exits 77 when the variables are
// unset.

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <exception>
#include <string>
#include <thread>
#include <vector>

#include <dlimgedit/dlimgedit.hpp>

namespace {

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    std::fprintf(stderr, "FATAL: cannot read %s\n", path.c_str());
    std::exit(1);
  }
  return std::string((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
}

[[noreturn]] void fatal(const std::string& msg) {
  std::fprintf(stderr, "FATAL: %s\n", msg.c_str());
  std::exit(1);
}

size_t count_diff(const uint8_t* a, const uint8_t* b, size_t n) {
  size_t d = 0;
  for (size_t i = 0; i < n; ++i) d += a[i] != b[i];
  return d;
}

// The serving library's counters, through its exported C function (it is
// loaded by the C library with RTLD_LOCAL; RTLD_NOLOAD finds it by name).
struct Counters {
  using Fn = void (*)(int64_t*, int64_t*);
  using CheckFn = int (*)(char*, size_t);
  Fn launches = nullptr;
  CheckFn check_replays = nullptr;
  void bind() {
    void* h = dlopen("libdlimgedit_tpu_torch_serving.so",
                     RTLD_NOW | RTLD_NOLOAD);
    if (!h) fatal("the serving library is not loaded in this process");
    launches = reinterpret_cast<Fn>(dlsym(h, "dlimg_serving_launches"));
    check_replays =
        reinterpret_cast<CheckFn>(dlsym(h, "dlimg_serving_check_replays"));
    if (!launches || !check_replays)
      fatal("the serving library lacks its counters");
  }
  std::pair<int64_t, int64_t> now() const {
    int64_t a = 0, b = 0;
    launches(&a, &b);
    return {a, b};
  }
};

dlimg::ImageView view_of(const std::string& pixels, int w, int h, int c) {
  dlimg::ImageView v;
  v.extent = {w, h};
  v.channels = c == 1   ? dlimg::Channels::mask
               : c == 3 ? dlimg::Channels::rgb
                        : dlimg::Channels::rgba;
  v.pixels = reinterpret_cast<const uint8_t*>(pixels.data());
  v.stride = w * c;
  return v;
}

double median(std::vector<double> v) {
  std::sort(v.begin(), v.end());
  size_t n = v.size();
  return n % 2 ? v[n / 2] : 0.5 * (v[n / 2 - 1] + v[n / 2]);
}

}  // namespace

int main(int argc, char** argv) {
  std::setbuf(stdout, nullptr);
  std::string which = "cpu";
  int time_n = 0;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "cpu" || a == "gpu") which = a;
    else if (a == "--time" && i + 1 < argc) time_n = std::atoi(argv[++i]);
    else fatal("usage: test_serving [cpu|gpu] [--time N]");
  }
  const char* dir_c = std::getenv("DLIMG_SERVING_CHECK_DIR");
  if (dir_c == nullptr || std::getenv("DLIMG_PJRT_BUNDLE") == nullptr) {
    std::fprintf(stderr,
                 "SKIP: DLIMG_SERVING_CHECK_DIR / DLIMG_PJRT_BUNDLE unset "
                 "(run dlimgedit_tpu_torch/tools/serving_check.py)\n");
    return 77;
  }
  const std::string dir = dir_c;

  int w, h, c;
  {
    std::ifstream meta(dir + "/meta.txt");
    if (!(meta >> w >> h >> c)) fatal("bad meta.txt");
  }
  struct Prompt {
    int is_region, v[4];
  };
  std::vector<Prompt> prompts;
  {
    std::ifstream pf(dir + "/prompts.txt");
    int n = 0;
    if (!(pf >> n) || n <= 0) fatal("bad prompts.txt");
    prompts.resize(n);
    for (Prompt& p : prompts)
      if (!(pf >> p.is_region >> p.v[0] >> p.v[1] >> p.v[2] >> p.v[3]))
        fatal("bad prompts.txt row");
  }
  const size_t px = size_t(w) * h;
  const std::string pixels = read_file(dir + "/image.raw");
  const std::string golden = read_file(dir + "/golden_masks.raw");
  if (golden.size() != prompts.size() * px) fatal("golden_masks.raw size");
  auto golden_mask = [&](size_t i) {
    return reinterpret_cast<const uint8_t*>(golden.data()) + i * px;
  };

  dlimg::Options opts;
  opts.backend = which == "gpu" ? dlimg::Backend::gpu : dlimg::Backend::cpu;
  if (!dlimg::Environment::is_supported(opts.backend))
    fatal("backend " + which + " not supported by the serving bundle: " +
          dlimg::detail::api().last_error());
  dlimg::Environment env(opts);
  Counters counters;
  counters.bind();

  const dlimg::ImageView view = view_of(pixels, w, h, c);
  auto before = counters.now();
  auto seg = dlimg::Segmentation::process(view, env);
  auto after = counters.now();
  std::printf("launches per process %dx%d: K1 %lld K2 %lld\n", w, h,
              (long long)(after.first - before.first),
              (long long)(after.second - before.second));

  // Every prompt through compute_mask (the point and box legs).
  for (size_t i = 0; i < prompts.size(); ++i) {
    const Prompt& p = prompts[i];
    dlimg::Image m =
        p.is_region
            ? seg.compute_mask(dlimg::Region{dlimg::Point{p.v[0], p.v[1]},
                                             dlimg::Point{p.v[2], p.v[3]}})
            : seg.compute_mask(dlimg::Point{p.v[0], p.v[1]});
    size_t d = count_diff(m.pixels(), golden_mask(i), px);
    std::printf("%s mask %zu vs the Python API: %zu/%zu pixels differ\n",
                p.is_region ? "box" : "point", i, d, px);
    if (d != 0) fatal("a mask differs from the Python API's");
  }

  // Three masks and their accuracies for the first point prompt.
  {
    const std::string g3 = read_file(dir + "/golden3.raw");
    const std::string gi = read_file(dir + "/golden3_iou.raw");
    if (g3.size() != 3 * px || gi.size() != 3 * sizeof(float))
      fatal("golden3 sizes");
    const Prompt* p0 = nullptr;
    for (const Prompt& p : prompts)
      if (!p.is_region) {
        p0 = &p;
        break;
      }
    if (!p0) fatal("prompts.txt has no point");
    auto cands = seg.compute_masks(dlimg::Point{p0->v[0], p0->v[1]});
    size_t d3 = 0, dacc = 0;
    for (int m = 0; m < 3; ++m) {
      d3 += count_diff(cands[m].image.pixels(),
                       reinterpret_cast<const uint8_t*>(g3.data()) + m * px,
                       px);
      dacc += std::memcmp(&cands[m].accuracy, gi.data() + m * sizeof(float),
                          sizeof(float)) != 0;
    }
    std::printf("compute_masks vs the Python API: %zu/%zu pixels differ, "
                "%zu/3 accuracies differ in bits\n", d3, 3 * px, dacc);
    if (d3 != 0 || dacc != 0) fatal("compute_masks differs");
  }

  // compute_mask_batch of every prompt.
  {
    const std::string gi = read_file(dir + "/golden_batch_iou.raw");
    if (gi.size() != prompts.size() * sizeof(float))
      fatal("golden_batch_iou.raw size");
    std::vector<dlimg::Segmentation::Prompt> batch;
    for (const Prompt& p : prompts)
      batch.push_back(p.is_region
                          ? dlimg::Segmentation::Prompt(dlimg::Region{
                                dlimg::Point{p.v[0], p.v[1]},
                                dlimg::Point{p.v[2], p.v[3]}})
                          : dlimg::Segmentation::Prompt(
                                dlimg::Point{p.v[0], p.v[1]}));
    auto masks = seg.compute_mask_batch(batch);
    size_t d = 0, dacc = 0;
    for (size_t i = 0; i < prompts.size(); ++i) {
      d += count_diff(masks[i].image.pixels(), golden_mask(i), px);
      dacc += std::memcmp(&masks[i].accuracy, gi.data() + i * sizeof(float),
                          sizeof(float)) != 0;
    }
    std::printf("compute_mask_batch of %zu vs the Python API: %zu/%zu pixels "
                "differ, %zu/%zu accuracies differ in bits\n", prompts.size(),
                d, prompts.size() * px, dacc, prompts.size());
    if (d != 0 || dacc != 0) fatal("compute_mask_batch differs");
  }

  // A non-square image in a smaller bucket.
  {
    std::ifstream sm(dir + "/meta_small.txt");
    int sw, sh, sc, spx, spy;
    if (!(sm >> sw >> sh >> sc >> spx >> spy)) fatal("bad meta_small.txt");
    const std::string spixels = read_file(dir + "/image_small.raw");
    const std::string sgolden = read_file(dir + "/golden_small.raw");
    const size_t sn = size_t(sw) * sh;
    if (sgolden.size() != sn) fatal("golden_small.raw size");
    auto b2 = counters.now();
    auto sseg = dlimg::Segmentation::process(view_of(spixels, sw, sh, sc), env);
    auto a2 = counters.now();
    std::printf("launches per process %dx%d: K1 %lld K2 %lld\n", sw, sh,
                (long long)(a2.first - b2.first),
                (long long)(a2.second - b2.second));
    dlimg::Image sm_mask = sseg.compute_mask(dlimg::Point{spx, spy});
    size_t d = count_diff(sm_mask.pixels(),
                          reinterpret_cast<const uint8_t*>(sgolden.data()), sn);
    std::printf("small image (%dx%d) mask vs the Python API: %zu/%zu pixels "
                "differ\n", sw, sh, d, sn);
    if (d != 0) fatal("the small image's mask differs");
  }

  // Two threads process two images of one bucket at once: each mask must
  // be its own image's, whatever the other thread does meanwhile.
  {
    const std::string pixels2 = read_file(dir + "/image2.raw");
    const std::string golden2 = read_file(dir + "/golden2.raw");
    if (pixels2.size() != pixels.size() || golden2.size() != px)
      fatal("image2.raw / golden2.raw size");
    size_t first = 0;
    while (first < prompts.size() && prompts[first].is_region) ++first;
    if (first == prompts.size()) fatal("prompts.txt has no point");
    const dlimg::Point point{prompts[first].v[0], prompts[first].v[1]};
    const int rounds = 8;
    size_t diff[2] = {0, 0};
    std::string errors[2];
    auto worker = [&](int k) {
      try {
        const dlimg::ImageView v = k == 0 ? view : view_of(pixels2, w, h, c);
        const uint8_t* want =
            k == 0 ? golden_mask(first)
                   : reinterpret_cast<const uint8_t*>(golden2.data());
        for (int r = 0; r < rounds; ++r) {
          auto s = dlimg::Segmentation::process(v, env);
          diff[k] += count_diff(s.compute_mask(point).pixels(), want, px);
        }
      } catch (const std::exception& e) {
        errors[k] = e.what();
      }
    };
    std::thread a(worker, 0), b(worker, 1);
    a.join();
    b.join();
    for (const std::string& e : errors)
      if (!e.empty()) fatal("concurrent process: " + e);
    std::printf("concurrent process of 2 images x %d rounds vs the Python "
                "API: %zu/%zu pixels differ\n", rounds, diff[0] + diff[1],
                2 * rounds * px);
    if (diff[0] + diff[1] != 0)
      fatal("a mask of a concurrent process differs from the Python API's");
  }

  // The main image again: the embed program's graph replays.
  {
    auto b3 = counters.now();
    auto again = dlimg::Segmentation::process(view, env);
    auto a3 = counters.now();
    std::printf("launches per process %dx%d (replay): K1 %lld K2 %lld\n", w,
                h, (long long)(a3.first - b3.first),
                (long long)(a3.second - b3.second));
  }

  if (time_n > 0) {
    const Prompt& p = prompts[0];
    std::vector<double> tp, tm;
    for (int i = 0; i < time_n; ++i) {
      auto t0 = std::chrono::steady_clock::now();
      auto s2 = dlimg::Segmentation::process(view, env);
      // A process returns once its work is queued; a mask's fetch waits
      // for it. Time the embedding with a mask of the same segmentation.
      dlimg::Image m0 = s2.compute_mask(dlimg::Point{p.v[0], p.v[1]});
      auto t1 = std::chrono::steady_clock::now();
      dlimg::Image m1 = seg.compute_mask(dlimg::Point{p.v[0], p.v[1]});
      auto t2 = std::chrono::steady_clock::now();
      tp.push_back(std::chrono::duration<double, std::milli>(t1 - t0).count());
      tm.push_back(std::chrono::duration<double, std::milli>(t2 - t1).count());
    }
    std::printf("serving times (medians of %d, in turn): process+mask_ms=%.3f "
                "mask_ms=%.3f\n", time_n, median(tp), median(tm));
  }

  std::vector<char> report(1 << 16);
  int held = counters.check_replays(report.data(), report.size());
  std::printf("%s", report.data());
  if (held < 0) fatal("a CUDA graph's replay differs from its eager run");
  std::printf("replays equal eager: %d graphs\n", held);

  using IsInitFn = int (*)();
  auto is_init =
      reinterpret_cast<IsInitFn>(dlsym(RTLD_DEFAULT, "Py_IsInitialized"));
  if (is_init != nullptr && is_init() != 0)
    fatal("Python was initialised in the serving process");
  std::printf("Py_IsInitialized: %s\n",
              is_init ? "0 (libpython linked, never started)" : "not linked");
  std::printf("PASS: Python-free serving equals the Python API\n");
  return 0;
}
