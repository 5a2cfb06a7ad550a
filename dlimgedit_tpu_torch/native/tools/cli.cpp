// dlimg — command-line front end for the PyTorch port's native library.
//
// A copy of the JAX package's native/tools/cli.cpp, built against the
// port's library (dlimgedit_tpu_torch/native/, built by
// dlimgedit_tpu_torch/native_build.py). It drives the public C++ API
// (dlimgedit.hpp), and through it the port's embedded-Python PyTorch
// runtime, from a shell with no code; `--backend gpu` is cuda:0.
// Subcommands:
//
//   dlimg segment <image> --point X,Y [--point ...] [--box X0,Y0,X1,Y1]
//         [-o OUT.png] [--all] [--cutout] [--backend cpu|gpu] [--models DIR]
//   dlimg remove-bg <image> [-o OUT.png] [--cutout]
//   dlimg segment-all <image> [-o OUT.png] [--max-masks N] [--iou F]
//         [--stability F] [--nms F] [--cutout]        (automatic masks)
//   dlimg apply-mask <image> <mask.png> [-o OUT.png]   (no model: RGBA cutout)
//   dlimg info                                         (backend/mode probe)
//
// Multiple --point/--box prompts to `segment` decode in ONE batched device
// program (Segmentation::compute_mask_batch).
//
// `--time` prints per-phase wall milliseconds on stderr.

#include <dlimgedit/dlimgedit.hpp>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "../src/bundle.hpp"

namespace {

using Clock = std::chrono::steady_clock;

bool g_time = false;

double ms_since(Clock::time_point t0) {
    return std::chrono::duration<double, std::milli>(Clock::now() - t0).count();
}

void phase(char const* name, Clock::time_point t0) {
    if (g_time)
        std::fprintf(stderr, "[dlimg] %-10s %8.2f ms\n", name, ms_since(t0));
}

[[noreturn]] void usage(char const* msg = nullptr) {
    if (msg)
        std::fprintf(stderr, "dlimg: %s\n\n", msg);
    std::fprintf(stderr,
        "usage:\n"
        "  dlimg segment <image> (--point X,Y | --box X0,Y0,X1,Y1)...\n"
        "        [-o OUT.png] [--all] [--cutout]\n"
        "  dlimg remove-bg <image> [-o OUT.png] [--cutout]\n"
        "  dlimg segment-all <image> [-o OUT.png] [--max-masks N] [--iou F]\n"
        "        [--stability F] [--nms F] [--cutout]\n"
        "  dlimg apply-mask <image> <mask.png> [-o OUT.png]\n"
        "  dlimg info\n"
        "common: --backend cpu|gpu|auto  --models DIR  --time\n");
    std::exit(2);
}

struct Prompt {
    bool is_box = false;
    int v[4] = {0, 0, 0, 0};
};

bool parse_ints(char const* s, int* out, int n) {
    char const* p = s;
    for (int i = 0; i < n; ++i) {
        char* end = nullptr;
        long v = std::strtol(p, &end, 10);
        if (end == p)
            return false;
        out[i] = int(v);
        p = end;
        if (i + 1 < n) {
            if (*p != ',')
                return false;
            ++p;
        }
    }
    return *p == '\0';
}

std::string default_out(std::string const& input, char const* suffix) {
    size_t dot = input.rfind('.');
    size_t slash = input.rfind('/');
    std::string stem = (dot == std::string::npos ||
                        (slash != std::string::npos && dot < slash))
                           ? input
                           : input.substr(0, dot);
    return stem + suffix + ".png";
}

std::string with_index(std::string const& out, int i) {
    size_t dot = out.rfind('.');
    std::string stem = dot == std::string::npos ? out : out.substr(0, dot);
    return stem + "_" + std::to_string(i) + ".png";
}

// RGBA cutout: source pixels with the mask as alpha (mask 0 -> transparent).
dlimg::Image make_cutout(dlimg::ImageView const& src, uint8_t const* mask) {
    using namespace dlimg;
    Image out(src.extent, Channels::rgba);
    int const w = src.extent.width, h = src.extent.height;
    int const sc = count(src.channels);
    bool const bgra = src.channels == Channels::bgra;
    bool const argb = src.channels == Channels::argb;
    for (int y = 0; y < h; ++y) {
        uint8_t const* srow = src.pixels + size_t(y) * src.stride;
        uint8_t* drow = out.pixels() + size_t(y) * w * 4;
        for (int x = 0; x < w; ++x) {
            uint8_t const* s = srow + size_t(x) * sc;
            uint8_t* d = drow + size_t(x) * 4;
            uint8_t r, g, b;
            if (sc == 1) {
                r = g = b = s[0];
            } else if (argb) {
                r = s[1], g = s[2], b = s[3];
            } else if (bgra) {
                r = s[2], g = s[1], b = s[0];
            } else {
                r = s[0], g = s[1], b = s[2];
            }
            d[0] = r, d[1] = g, d[2] = b;
            d[3] = mask[size_t(y) * w + x];
        }
    }
    return out;
}

struct Args {
    std::string command;
    std::vector<std::string> positional;
    std::vector<Prompt> prompts;
    std::string out;
    std::string backend = "auto";
    std::string models = "models";
    bool all = false;
    bool cutout = false;
    int max_masks = 64;        // segment-all
    float iou = 0.88f;
    float stability = 0.95f;
    float nms = 0.7f;
};

Args parse(int argc, char** argv) {
    if (argc < 2)
        usage();
    Args a;
    a.command = argv[1];
    for (int i = 2; i < argc; ++i) {
        std::string arg = argv[i];
        auto next = [&]() -> char const* {
            if (i + 1 >= argc)
                usage(("missing value for " + arg).c_str());
            return argv[++i];
        };
        if (arg == "--point" || arg == "-p") {
            Prompt p;
            if (!parse_ints(next(), p.v, 2))
                usage("--point expects X,Y");
            a.prompts.push_back(p);
        } else if (arg == "--box" || arg == "-b") {
            Prompt p;
            p.is_box = true;
            if (!parse_ints(next(), p.v, 4))
                usage("--box expects X0,Y0,X1,Y1");
            a.prompts.push_back(p);
        } else if (arg == "-o" || arg == "--output") {
            a.out = next();
        } else if (arg == "--backend") {
            a.backend = next();
        } else if (arg == "--models") {
            a.models = next();
        } else if (arg == "--all") {
            a.all = true;
        } else if (arg == "--max-masks") {
            a.max_masks = std::max(1, std::atoi(next()));
        } else if (arg == "--iou") {
            a.iou = float(std::atof(next()));
        } else if (arg == "--stability") {
            a.stability = float(std::atof(next()));
        } else if (arg == "--nms") {
            a.nms = float(std::atof(next()));
        } else if (arg == "--cutout") {
            a.cutout = true;
        } else if (arg == "--time") {
            g_time = true;
        } else if (arg == "--help" || arg == "-h") {
            usage();
        } else if (!arg.empty() && arg[0] == '-') {
            usage(("unknown option " + arg).c_str());
        } else {
            a.positional.push_back(arg);
        }
    }
    return a;
}

dlimg::Environment make_env(Args const& a) {
    using namespace dlimg;
    Options opts;
    if (a.backend == "cpu") {
        opts.backend = Backend::cpu;
    } else if (a.backend == "gpu") {
        opts.backend = Backend::gpu;
    } else if (a.backend == "auto") {
        opts.backend = Environment::is_supported(Backend::gpu) ? Backend::gpu
                                                               : Backend::cpu;
    } else {
        usage("--backend must be cpu, gpu or auto");
    }
    opts.model_directory = a.models.c_str();
    auto t0 = Clock::now();
    Environment env(opts);
    phase("init", t0);
    return env;
}

int cmd_info() {
    using namespace dlimg;
    std::printf("dlimg (dlimgedit_tpu_torch native CLI)\n");
    bool const cpu = Environment::is_supported(Backend::cpu);
    bool const gpu = Environment::is_supported(Backend::gpu);
    std::printf("backend cpu: %s\n", cpu ? "supported" : "unavailable");
    std::printf("backend gpu: %s\n", gpu ? "supported (cuda:0)"
                                         : "unavailable");
    char const* bundle = std::getenv("DLIMG_PJRT_BUNDLE");
    std::printf("runtime mode: %s\n",
                bundle ? "Python-free serving bundle (libtorch, no "
                         "interpreter)"
                       : "embedded-Python PyTorch");
    if (bundle) {
        std::printf("bundle: %s\n", bundle);
        if (!cpu && !gpu)
            std::printf("bundle refused: %s\n", detail::api().last_error());
        dlimg_bundle::Index index;
        if (dlimg_bundle::read_index(bundle, &index).empty()) {
            std::string batch;
            for (int n : index.batch)
                batch += (batch.empty() ? "" : ",") + std::to_string(n);
            std::printf("bundle variant: %s (encoder %s, kernel route %s)\n",
                        index.variant.c_str(), index.encoder.c_str(),
                        index.kernel_route ? "on" : "off");
            std::printf("bundle batch sizes: %s\n",
                        batch.empty() ? "none (compute_mask_batch decodes "
                                        "each prompt)"
                                      : batch.c_str());
            if (index.amg_grid > 0)
                std::printf("bundle amg: grid %d, %d masks, pre-NMS pool %d\n",
                            index.amg_grid, index.amg_masks,
                            dlimg_bundle::prenms_pool(
                                index.amg_grid * index.amg_grid,
                                index.amg_masks));
            else
                std::printf("bundle amg: none (generate_masks is refused)\n");
            std::string biref;
            for (auto const& b : index.birefnet)
                biref += (biref.empty() ? "" : ",") + b.kind + ":" +
                         std::to_string(b.bucket) + ":" +
                         std::to_string(b.resolution);
            std::printf("bundle birefnet: %s\n",
                        biref.empty() ? "none (segment_objects is refused)"
                                      : biref.c_str());
            std::printf("bundle quant: %s (encoder %s, BiRefNet gathers "
                        "%s)\n", dlimg_bundle::quant_modes(index).c_str(),
                        index.a8   ? "int8 weights and activations"
                        : index.w8 ? "int8 weights"
                                   : "float",
                        index.deform8 ? "int8" : "float");
        }
    }
    return 0;
}

int cmd_segment(Args const& a) {
    using namespace dlimg;
    if (a.positional.size() != 1)
        usage("segment expects exactly one input image");
    if (a.prompts.empty())
        usage("segment needs at least one --point or --box");
    if (a.all && (a.prompts.size() != 1 || a.prompts[0].is_box))
        usage("--all works with exactly one --point");

    auto env = make_env(a);
    auto t0 = Clock::now();
    Image input = Image::load(a.positional[0].c_str());
    phase("load", t0);
    ImageView view(input);

    t0 = Clock::now();
    auto seg = Segmentation::process(view, env);
    phase("process", t0);

    std::string out =
        a.out.empty() ? default_out(a.positional[0], "_mask") : a.out;

    if (a.all) {
        t0 = Clock::now();
        auto masks = seg.compute_masks(Point{a.prompts[0].v[0],
                                             a.prompts[0].v[1]});
        phase("masks", t0);
        for (int i = 0; i < 3; ++i) {
            std::string path = with_index(out, i);
            if (a.cutout)
                Image::save(ImageView(make_cutout(view,
                                                  masks[i].image.pixels())),
                            path.c_str());
            else
                Image::save(ImageView(masks[i].image), path.c_str());
            std::printf("%s accuracy=%.4f\n", path.c_str(),
                        masks[i].accuracy);
        }
        return 0;
    }

    if (a.prompts.size() > 1) {
        // Many prompts: ONE batched device program for all of them.
        std::vector<Segmentation::Prompt> prompts;
        prompts.reserve(a.prompts.size());
        for (Prompt const& p : a.prompts) {
            if (p.is_box)
                prompts.push_back(Segmentation::Prompt(
                    Region{Point{p.v[0], p.v[1]}, Point{p.v[2], p.v[3]}}));
            else
                prompts.push_back(
                    Segmentation::Prompt(Point{p.v[0], p.v[1]}));
        }
        t0 = Clock::now();
        auto masks = seg.compute_mask_batch(prompts);
        phase("masks", t0);
        for (size_t i = 0; i < masks.size(); ++i) {
            std::string path = with_index(out, int(i));
            if (a.cutout)
                Image::save(ImageView(make_cutout(
                                view, masks[i].image.pixels())),
                            path.c_str());
            else
                Image::save(ImageView(masks[i].image), path.c_str());
            std::printf("%s\n", path.c_str());
        }
        return 0;
    }

    Prompt const& p = a.prompts[0];
    t0 = Clock::now();
    Image mask = p.is_box
                     ? seg.compute_mask(Region{Point{p.v[0], p.v[1]},
                                               Point{p.v[2], p.v[3]}})
                     : seg.compute_mask(Point{p.v[0], p.v[1]});
    phase("mask", t0);
    if (a.cutout)
        Image::save(ImageView(make_cutout(view, mask.pixels())),
                    out.c_str());
    else
        Image::save(ImageView(mask), out.c_str());
    std::printf("%s\n", out.c_str());
    return 0;
}

// Automatic mask generation ("segment everything"): every object mask of
// the image, best-first (Segmentation::generate_masks; runtime/amg.py runs
// the whole pipeline as one device program).
int cmd_segment_all(Args const& a) {
    using namespace dlimg;
    if (a.positional.size() != 1)
        usage("segment-all expects exactly one input image");
    auto env = make_env(a);
    auto t0 = Clock::now();
    Image input = Image::load(a.positional[0].c_str());
    phase("load", t0);
    ImageView view(input);
    t0 = Clock::now();
    auto seg = Segmentation::process(view, env);
    phase("process", t0);
    t0 = Clock::now();
    auto masks = seg.generate_masks(a.iou, a.stability, a.nms, a.max_masks);
    phase("generate", t0);
    std::string out =
        a.out.empty() ? default_out(a.positional[0], "_obj") : a.out;
    for (size_t i = 0; i < masks.size(); ++i) {
        std::string path = with_index(out, int(i));
        if (a.cutout)
            Image::save(ImageView(make_cutout(view,
                                              masks[i].image.pixels())),
                        path.c_str());
        else
            Image::save(ImageView(masks[i].image), path.c_str());
        std::printf("%s accuracy=%.4f\n", path.c_str(), masks[i].accuracy);
    }
    if (masks.empty())
        std::printf("no masks passed the thresholds\n");
    return 0;
}

int cmd_remove_bg(Args const& a) {
    using namespace dlimg;
    if (a.positional.size() != 1)
        usage("remove-bg expects exactly one input image");
    auto env = make_env(a);
    auto t0 = Clock::now();
    Image input = Image::load(a.positional[0].c_str());
    phase("load", t0);
    ImageView view(input);
    t0 = Clock::now();
    Image mask = segment_objects(view, env);
    phase("segment", t0);
    std::string out = a.out.empty()
                          ? default_out(a.positional[0],
                                        a.cutout ? "_fg" : "_mask")
                          : a.out;
    if (a.cutout)
        Image::save(ImageView(make_cutout(view, mask.pixels())), out.c_str());
    else
        Image::save(ImageView(mask), out.c_str());
    std::printf("%s\n", out.c_str());
    return 0;
}

int cmd_apply_mask(Args const& a) {
    using namespace dlimg;
    if (a.positional.size() != 2)
        usage("apply-mask expects <image> <mask.png>");
    Image input = Image::load(a.positional[0].c_str());
    Image mask = Image::load(a.positional[1].c_str());
    if (mask.channels() != Channels::mask ||
        mask.extent().width != input.extent().width ||
        mask.extent().height != input.extent().height) {
        std::fprintf(stderr,
                     "dlimg: mask must be single-channel and match the "
                     "image extent\n");
        return 1;
    }
    std::string out =
        a.out.empty() ? default_out(a.positional[0], "_fg") : a.out;
    Image::save(ImageView(make_cutout(ImageView(input), mask.pixels())),
                out.c_str());
    std::printf("%s\n", out.c_str());
    return 0;
}

}  // namespace

int main(int argc, char** argv) {
    Args a = parse(argc, argv);
    try {
        if (a.command == "info")
            return cmd_info();
        if (a.command == "segment")
            return cmd_segment(a);
        if (a.command == "remove-bg")
            return cmd_remove_bg(a);
        if (a.command == "segment-all")
            return cmd_segment_all(a);
        if (a.command == "apply-mask")
            return cmd_apply_mask(a);
        usage(("unknown command " + a.command).c_str());
    } catch (dlimg::Exception const& e) {
        std::fprintf(stderr, "dlimg: %s\n", e.what());
        return 1;
    }
}
