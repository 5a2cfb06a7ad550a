// End-to-end smoke test of the public C++14 API over the PyTorch port's
// runtime (a copy of the JAX package's native/test/test_cpp_api.cpp) — the
// standalone-embedder equivalent of the reference's C++ test suite
// (process -> compute_mask point/region/multi, image codec round-trip,
// error paths).
//
//   test_cpp_api [cpu|gpu]     (default cpu; gpu is cuda:0)
//
// Run with DLIMG_ALLOW_RANDOM_WEIGHTS=1 (and a small DLIMG_SAM_IMAGE_SIZE
// on the CPU) or with a model directory in ./models.

#include <dlimgedit/dlimgedit.hpp>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#define CHECK(cond)                                                            \
    do {                                                                       \
        if (!(cond)) {                                                         \
            std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,      \
                         __LINE__, #cond);                                     \
            return 1;                                                          \
        }                                                                      \
    } while (0)

int main(int argc, char** argv) {
    using namespace dlimg;

    std::string const which = argc > 1 ? argv[1] : "cpu";
    CHECK(which == "cpu" || which == "gpu");
    Backend const backend = which == "gpu" ? Backend::gpu : Backend::cpu;
    CHECK(Environment::is_supported(backend));

    // Error path: bad model directory without random weights.
    // (DLIMG_ALLOW_RANDOM_WEIGHTS=1 is set by the harness for the rest.)

    Options opts;
    opts.backend = backend;
    Environment env(opts);

    // Synthetic RGBA image.
    Extent extent{96, 64};
    std::vector<uint8_t> pixels(size_t(extent.width) * extent.height * 4);
    for (size_t i = 0; i < pixels.size(); ++i) {
        pixels[i] = uint8_t((i * 31) & 0xff);
    }
    ImageView view(pixels.data(), extent, Channels::rgba);

    auto seg = Segmentation::process(view, env);
    CHECK(seg.extent().width == 96);
    CHECK(seg.extent().height == 64);

    auto mask = seg.compute_mask(Point{48, 32});
    CHECK(mask.extent().width == 96);
    CHECK(mask.extent().height == 64);
    CHECK(mask.channels() == Channels::mask);
    bool binary = true;
    for (size_t i = 0; i < mask.size(); ++i) {
        binary = binary && (mask.pixels()[i] == 0 || mask.pixels()[i] == 255);
    }
    CHECK(binary);

    auto region_mask = seg.compute_mask(Region{Point{10, 10}, Point{80, 50}});
    CHECK(region_mask.extent().width == 96);

    auto masks = seg.compute_masks(Point{48, 32});
    CHECK(masks.size() == 3);
    for (auto const& m : masks) {
        CHECK(m.image.extent().width == 96);
    }

    // Codec round-trip through the ABI allocator.
    Image img(Extent{12, 10}, Channels::rgb);
    for (size_t i = 0; i < img.size(); ++i) {
        img.pixels()[i] = uint8_t(i);
    }
    char const* tmp = std::getenv("TMPDIR");
    std::string const path =
        std::string(tmp && *tmp ? tmp : "/tmp") + "/dlimg_cpp_roundtrip.png";
    Image::save(ImageView(img), path.c_str());
    auto loaded = Image::load(path.c_str());
    CHECK(loaded.extent().width == 12);
    CHECK(loaded.extent().height == 10);
    CHECK(std::memcmp(loaded.pixels(), img.pixels(), img.size()) == 0);

    // Error handling: exception carries last_error.
    bool threw = false;
    try {
        Image::load("/nonexistent/nope.png");
    } catch (Exception const& e) {
        threw = e.what() != nullptr && e.what()[0] != '\0';
    }
    CHECK(threw);

    std::printf("CPP_API_OK\n");
    return 0;
}
