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
//   amg.txt             (with an --amg bundle) "iou stability nms
//                       max_masks count", golden_amg.raw (count masks of
//                       image.raw) and golden_amg_acc.raw (count float32):
//                       Segmentation.generate_masks
//   birefnet.txt        (with a --birefnet bundle) n, then n rows "w h c":
//                       birefnet<i>.raw and golden_birefnet<i>.raw, the
//                       Python API's segment_objects; then "w h", an image
//                       over every BiRefNet bucket
// Legs: every prompt's mask, three masks and their accuracies, the small
// image, compute_mask_batch of the first 3 prompts and of every prompt
// (through the bundle's serve_decode_batch<N> programs where it has them,
// padded slots included), and two threads that process image.raw and
// image2.raw at once, round after round, each holding its own image's
// mask and batch; masks byte-equal and accuracies bit-equal;
// generate_masks (twice: the second call replays its graph on the card)
// with its count, masks and accuracies byte-equal; segment_objects of each
// BiRefNet image within one grey level a pixel of the Python API (the C
// host resizes with the native box filter, the Python API with numpy), and
// the refusal of an image over every bucket (each served mask is written to
// served_birefnet<i>.raw in the working directory). Prints the K1 / K2 / K3 / K4
// / K5 / P1 / P2 / P3 launches of each process, generate_masks and
// segment_objects (the serving library's counters; the main image once
// more, where its graph replays) and the int8 linears of each process (s8
// x s8 products and dequantised w8 products, on any device), holds
// every CUDA graph's replay against its eager run (out of the bundle's
// programs, counted from its spec files), and with --time N prints the
// medians of N process and compute_mask calls, one of each in turn. Exits
// 77 when the variables are unset.

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <filesystem>
#include <fstream>
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

// The serving library's counters of K1..K5, P1, P2 and P3, then of the
// int8 linears (s8 x s8, dequantised), through its exported C functions
// (it is loaded by the C library with RTLD_LOCAL; RTLD_NOLOAD finds it by
// name).
struct Launches {
  int64_t k[10] = {};
  Launches operator-(const Launches& o) const {
    Launches d;
    for (int i = 0; i < 10; ++i) d.k[i] = k[i] - o.k[i];
    return d;
  }
};

void print_launches(const char* what, const Launches& d,
                    const char* per = "process") {
  std::printf("launches per %s %s: K1 %lld K2 %lld K3 %lld K4 %lld K5 %lld "
              "P1 %lld P2 %lld P3 %lld\n", per, what, (long long)d.k[0],
              (long long)d.k[1], (long long)d.k[2], (long long)d.k[3],
              (long long)d.k[4], (long long)d.k[5], (long long)d.k[6],
              (long long)d.k[7]);
  if (std::string(per) == "process")
    std::printf("int8 linears per process %s: s8 %lld dequantised %lld\n",
                what, (long long)d.k[8], (long long)d.k[9]);
}

struct Counters {
  using Fn = void (*)(int64_t*, int);
  using CheckFn = int (*)(char*, size_t);
  Fn launches = nullptr;
  Fn int8_linears = nullptr;
  CheckFn check_replays = nullptr;
  void bind() {
    void* h = dlopen("libdlimgedit_tpu_torch_serving.so",
                     RTLD_NOW | RTLD_NOLOAD);
    if (!h) fatal("the serving library is not loaded in this process");
    launches = reinterpret_cast<Fn>(dlsym(h, "dlimg_serving_launches"));
    int8_linears =
        reinterpret_cast<Fn>(dlsym(h, "dlimg_serving_int8_linears"));
    check_replays =
        reinterpret_cast<CheckFn>(dlsym(h, "dlimg_serving_check_replays"));
    if (!launches || !int8_linears || !check_replays)
      fatal("the serving library lacks its counters");
  }
  Launches now() const {
    Launches l;
    launches(l.k, 8);
    int8_linears(l.k + 8, 2);
    return l;
  }
};

// The bundle's programs: its <name>.spec.txt files.
int bundle_programs(const std::string& bundle) {
  int n = 0;
  for (const auto& e : std::filesystem::directory_iterator(bundle)) {
    const std::string f = e.path().filename().string();
    n += f.size() > 9 && f.compare(f.size() - 9, 9, ".spec.txt") == 0;
  }
  return n;
}

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
  const std::string main_size = std::to_string(w) + "x" + std::to_string(h);
  auto before = counters.now();
  auto seg = dlimg::Segmentation::process(view, env);
  print_launches(main_size.c_str(), counters.now() - before);

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

  // compute_mask_batch of the first k prompts against compute_mask's masks
  // and the Python API's batch accuracies: -> (pixels, accuracies) that
  // differ.
  const std::string batch_iou = read_file(dir + "/golden_batch_iou.raw");
  if (batch_iou.size() != prompts.size() * sizeof(float))
    fatal("golden_batch_iou.raw size");
  auto batch_diff = [&](dlimg::Segmentation& s, size_t k) {
    std::vector<dlimg::Segmentation::Prompt> batch;
    for (size_t i = 0; i < k; ++i) {
      const Prompt& p = prompts[i];
      batch.push_back(p.is_region
                          ? dlimg::Segmentation::Prompt(dlimg::Region{
                                dlimg::Point{p.v[0], p.v[1]},
                                dlimg::Point{p.v[2], p.v[3]}})
                          : dlimg::Segmentation::Prompt(
                                dlimg::Point{p.v[0], p.v[1]}));
    }
    auto masks = s.compute_mask_batch(batch);
    std::pair<size_t, size_t> d{0, 0};
    for (size_t i = 0; i < k; ++i) {
      d.first += count_diff(masks[i].image.pixels(), golden_mask(i), px);
      d.second += std::memcmp(&masks[i].accuracy,
                              batch_iou.data() + i * sizeof(float),
                              sizeof(float)) != 0;
    }
    return d;
  };
  // A request of 3 (a batch program's padded slot) and of every prompt.
  std::vector<size_t> requests = {std::min<size_t>(3, prompts.size())};
  if (prompts.size() > requests[0]) requests.push_back(prompts.size());
  for (size_t k : requests) {
    auto [d, dacc] = batch_diff(seg, k);
    std::printf("compute_mask_batch of %zu vs the Python API: %zu/%zu pixels "
                "differ, %zu/%zu accuracies differ in bits\n", k, d, k * px,
                dacc, k);
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
    const std::string small_size =
        std::to_string(sw) + "x" + std::to_string(sh);
    print_launches(small_size.c_str(), counters.now() - b2);
    dlimg::Image sm_mask = sseg.compute_mask(dlimg::Point{spx, spy});
    size_t d = count_diff(sm_mask.pixels(),
                          reinterpret_cast<const uint8_t*>(sgolden.data()), sn);
    std::printf("small image (%dx%d) mask vs the Python API: %zu/%zu pixels "
                "differ\n", sw, sh, d, sn);
    if (d != 0) fatal("the small image's mask differs");
  }

  // Two threads process two images of one bucket at once: each mask must
  // be its own image's, whatever the other thread does meanwhile; the
  // thread of image.raw also runs the batch of every prompt each round.
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
    size_t diff[2] = {0, 0}, batch_diffs = 0;
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
          if (k == 0) {
            auto [d, dacc] = batch_diff(s, prompts.size());
            batch_diffs += d + dacc;
          }
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
                "API: %zu/%zu pixels differ; batches of %zu: %zu pixels and "
                "accuracies differ\n", rounds, diff[0] + diff[1],
                2 * rounds * px, prompts.size(), batch_diffs);
    if (diff[0] + diff[1] + batch_diffs != 0)
      fatal("a mask of a concurrent process differs from the Python API's");
  }

  // generate_masks of the main image, twice (on the card the second call
  // replays the graph the first captured), against the Python API's.
  if (std::ifstream(dir + "/amg.txt")) {
    std::ifstream am(dir + "/amg.txt");
    float iou, stab, nms;
    int max_masks, count;
    if (!(am >> iou >> stab >> nms >> max_masks >> count))
      fatal("bad amg.txt");
    const std::string gm = read_file(dir + "/golden_amg.raw");
    const std::string ga = read_file(dir + "/golden_amg_acc.raw");
    if (gm.size() != size_t(count) * px || ga.size() != count * sizeof(float))
      fatal("golden_amg sizes");
    for (int call = 1; call <= 2; ++call) {
      auto b4 = counters.now();
      auto masks = seg.generate_masks(iou, stab, nms, max_masks);
      print_launches(main_size.c_str(), counters.now() - b4,
                     "generate_masks");
      size_t d = 0, dacc = 0;
      const size_t n = std::min(masks.size(), size_t(count));
      for (size_t i = 0; i < n; ++i) {
        d += count_diff(masks[i].image.pixels(),
                        reinterpret_cast<const uint8_t*>(gm.data()) + i * px,
                        px);
        dacc += std::memcmp(&masks[i].accuracy, ga.data() + i * sizeof(float),
                            sizeof(float)) != 0;
      }
      std::printf("generate_masks (call %d) vs the Python API: %zu of %d "
                  "masks, %zu/%zu pixels differ, %zu/%d accuracies differ in "
                  "bits\n", call, masks.size(), count, d, n * px, dacc,
                  count);
      if (masks.size() != size_t(count) || d != 0 || dacc != 0)
        fatal("generate_masks differs from the Python API's");
    }
  }

  // segment_objects of each BiRefNet image, within one grey level a pixel
  // of the Python API's, then an image over every bucket, refused.
  if (std::ifstream(dir + "/birefnet.txt")) {
    std::ifstream bf(dir + "/birefnet.txt");
    int n = 0;
    if (!(bf >> n) || n <= 0) fatal("bad birefnet.txt");
    for (int i = 0; i < n; ++i) {
      int bw, bh, bc;
      if (!(bf >> bw >> bh >> bc)) fatal("bad birefnet.txt row");
      const std::string k = std::to_string(i);
      const std::string bp = read_file(dir + "/birefnet" + k + ".raw");
      const std::string bg = read_file(dir + "/golden_birefnet" + k + ".raw");
      const size_t bn = size_t(bw) * bh;
      if (bp.size() != bn * bc || bg.size() != bn) fatal("birefnet sizes");
      const std::string what = std::to_string(bw) + "x" + std::to_string(bh);
      auto b5 = counters.now();
      dlimg::Image m = dlimg::segment_objects(view_of(bp, bw, bh, bc), env);
      print_launches(what.c_str(), counters.now() - b5, "segment_objects");
      // For the caller's own comparisons (the JAX package's masks).
      std::ofstream("served_birefnet" + k + ".raw", std::ios::binary)
          .write(reinterpret_cast<const char*>(m.pixels()), std::streamsize(bn));
      size_t d = 0;
      int worst = 0;
      for (size_t j = 0; j < bn; ++j) {
        int diff = std::abs(int(m.pixels()[j]) - int(uint8_t(bg[j])));
        d += diff != 0;
        worst = std::max(worst, diff);
      }
      std::printf("segment_objects %s (%s) vs the Python API: %zu/%zu "
                  "pixels differ, by at most %d\n", what.c_str(),
                  std::max(bw, bh) > 1536 ? "high_res" : "general", d, bn,
                  worst);
      if (worst > 1) fatal("a segment_objects mask differs by more than 1");
    }
    int ow, oh;
    if (!(bf >> ow >> oh)) fatal("bad birefnet.txt refusal row");
    const std::string over(size_t(ow) * oh * 3, '\0');
    bool refused = false;
    try {
      dlimg::segment_objects(view_of(over, ow, oh, 3), env);
    } catch (const std::exception& e) {
      refused = true;
      std::printf("segment_objects %dx%d: refused (%s)\n", ow, oh, e.what());
    }
    if (!refused) fatal("segment_objects of an image over every bucket ran");
  }

  // The main image again: the embed program's graph replays.
  {
    auto b3 = counters.now();
    auto again = dlimg::Segmentation::process(view, env);
    print_launches((main_size + " (replay)").c_str(), counters.now() - b3);
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
  std::printf("replays equal eager: %d graphs (the bundle has %d programs)\n",
              held, bundle_programs(std::getenv("DLIMG_PJRT_BUNDLE")));

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
