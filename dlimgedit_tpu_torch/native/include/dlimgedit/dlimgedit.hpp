// dlimgedit_tpu — public C++14 API.
//
// Header-only wrapper over the C ABI (detail/dlimgedit.h), source-compatible
// with the reference dlimgedit 1.x public API (see SURVEY.md §1 L6): the
// same types and calls drive the TPU runtime. Works linked at compile time
// (auto-initialises through the exported dlimg_init) or loaded at runtime
// (define DLIMGEDIT_LOAD_DYNAMIC, resolve dlimg_init yourself and pass the
// table to dlimg::initialize()).

#pragma once

#include <dlimgedit/detail/dlimgedit.h>
#include <dlimgedit/detail/handle.hpp>

#include <array>
#include <cstdint>
#include <exception>
#include <string>
#include <utility>
#include <vector>
// std::filesystem needs C++17; the rest of the header is C++14. The
// fs::path load/save overloads appear automatically on C++17+ (reference
// parity — it builds as C++20) and can be suppressed there with
// DLIMGEDIT_NO_FILESYSTEM exactly like the reference header.
#if !defined(DLIMGEDIT_NO_FILESYSTEM) && __cplusplus >= 201703L
#    include <filesystem>
#    define DLIMGEDIT_HAS_FILESYSTEM 1
#endif

namespace dlimg {
class Image;

// ---------------------------------------------------------------------------
// Image types
// ---------------------------------------------------------------------------

// Resolution of an image or size of a region.
struct Extent {
    int width = 0;
    int height = 0;
};

// Pixel channel order; one byte per channel.
enum class Channels { mask = 1, rgb = 3, rgba = 4, bgra = 5, argb = 6 };

constexpr int count(Channels c) {
    return (c == Channels::mask) ? 1 : (c == Channels::rgb) ? 3 : 4;
}

// Non-owning view of row-major packed pixels, origin top-left.
struct ImageView {
    Extent extent;
    Channels channels = Channels::rgba;
    int stride = 0;
    uint8_t const* pixels = nullptr;

    ImageView() noexcept = default;
    ImageView(uint8_t const* data, Extent e, Channels c = Channels::rgba) noexcept
        : extent(e), channels(c), stride(e.width * count(c)), pixels(data) {}
    inline ImageView(Image const&) noexcept;
};

// The exception type thrown by all fallible calls.
class Exception : public std::exception {
  public:
    explicit Exception(std::string msg) : msg_(std::move(msg)) {}
    char const* what() const noexcept override { return msg_.c_str(); }

  private:
    std::string msg_;
};

namespace detail {
inline void throw_on_error(dlimg_Result r) {
    if (r != dlimg_success) {
        throw Exception(api().last_error());
    }
}
inline dlimg_ImageView to_c(ImageView const& v) {
    dlimg_ImageView c;
    c.width = v.extent.width;
    c.height = v.extent.height;
    c.channels = int(v.channels);
    c.stride = v.stride;
    c.pixels = const_cast<uint8_t*>(v.pixels);
    return c;
}
} // namespace detail

// Owning image with packed uint8 pixels allocated by the library.
class Image {
  public:
    explicit Image(Extent extent, Channels channels = Channels::rgba)
        : extent_(extent), channels_(channels),
          pixels_(detail::api().create_image(extent.width, extent.height,
                                             count(channels))) {}

    Extent extent() const noexcept { return extent_; }
    Channels channels() const noexcept { return channels_; }
    uint8_t* pixels() noexcept { return pixels_; }
    uint8_t const* pixels() const noexcept { return pixels_; }
    size_t size() const noexcept {
        return size_t(extent_.width) * extent_.height * count(channels_);
    }

    // Decode PNG / JPEG / BMP / TGA from disk.
    static Image load(char const* filepath) {
        int extent[2] = {0, 0};
        int channels = 0;
        uint8_t* pixels = nullptr;
        detail::throw_on_error(detail::api().load_image(filepath, extent,
                                                        &channels, &pixels));
        return Image(Extent{extent[0], extent[1]},
                     channels == 1   ? Channels::mask
                     : channels == 3 ? Channels::rgb
                                     : Channels::rgba,
                     pixels);
    }

    // Encode as PNG.
    static void save(ImageView const& img, char const* filepath) {
        auto v = detail::to_c(img);
        detail::throw_on_error(detail::api().save_image(&v, filepath));
    }

#ifdef DLIMGEDIT_HAS_FILESYSTEM
    static Image load(std::filesystem::path const& p) {
        return load(p.string().c_str());
    }
    static void save(ImageView const& img, std::filesystem::path const& p) {
        save(img, p.string().c_str());
    }
#endif

    ~Image() {
        if (pixels_) {
            detail::api().destroy_image(pixels_);
        }
    }
    Image(Image&& other) noexcept
        : extent_(other.extent_), channels_(other.channels_),
          pixels_(other.pixels_) {
        other.pixels_ = nullptr;
    }
    Image& operator=(Image&& other) noexcept {
        std::swap(extent_, other.extent_);
        std::swap(channels_, other.channels_);
        std::swap(pixels_, other.pixels_);
        return *this;
    }
    Image(Image const&) = delete;
    Image& operator=(Image const&) = delete;

  private:
    Image(Extent e, Channels c, uint8_t* pixels)
        : extent_(e), channels_(c), pixels_(pixels) {}

    Extent extent_;
    Channels channels_;
    uint8_t* pixels_ = nullptr;
};

inline ImageView::ImageView(Image const& img) noexcept
    : extent(img.extent()), channels(img.channels()),
      stride(img.extent().width * count(img.channels())),
      pixels(img.pixels()) {}

// ---------------------------------------------------------------------------
// Environment
// ---------------------------------------------------------------------------

// Inference hardware. `gpu` selects the accelerator backend (TPU here).
enum class Backend { cpu, gpu };

struct Options {
    Backend backend = Backend::cpu;
    char const* model_directory = "models";
};

// Shared inference infrastructure; caches models after first use.
// Safe to use from multiple threads; must outlive dependent objects.
class Environment : public Handle<dlimg_Environment_> {
  public:
    static bool is_supported(Backend b) noexcept {
        return detail::api().is_backend_supported(dlimg_Backend(int(b))) != 0;
    }

    explicit Environment(Options const& opts = {}) {
        dlimg_Options c;
        c.backend = dlimg_Backend(int(opts.backend));
        c.model_directory = opts.model_directory;
        detail::throw_on_error(
            detail::api().create_environment(&emplace(), &c));
    }

    Environment(std::nullptr_t) noexcept {}
};

// ---------------------------------------------------------------------------
// Segmentation
// ---------------------------------------------------------------------------

struct Point {
    int x = 0;
    int y = 0;
};

struct Region {
    Point top_left;
    Point bottom_right;

    constexpr Region() = default;
    constexpr Region(Point tl, Point br) : top_left(tl), bottom_right(br) {}
    constexpr Region(Point origin, Extent extent)
        : top_left(origin),
          bottom_right{origin.x + extent.width, origin.y + extent.height} {}

    constexpr Extent extent() const {
        return Extent{bottom_right.x - top_left.x,
                      bottom_right.y - top_left.y};
    }
};

// A cached image embedding; queries masks for many prompts cheaply.
class Segmentation : public Handle<dlimg_Segmentation_> {
  public:
    struct Mask {
        Image image;             // Channels::mask, values 0 or 255
        float accuracy = 0.0f;   // predicted IoU
    };

    // Embed an image (expensive once; queries afterwards are cheap).
    static Segmentation process(ImageView const& img, Environment const& env) {
        Segmentation s(nullptr);
        auto v = detail::to_c(img);
        detail::throw_on_error(detail::api().process_image_for_segmentation(
            &s.emplace(), &v, env.handle()));
        return s;
    }

    Image compute_mask(Point point) const {
        Image out(extent(), Channels::mask);
        compute_mask(point, out.pixels());
        return out;
    }
    void compute_mask(Point point, uint8_t* result_mask) const {
        int p[2] = {point.x, point.y};
        uint8_t* masks[3] = {result_mask, nullptr, nullptr};
        float acc[3] = {0, 0, 0};
        detail::throw_on_error(
            detail::api().get_segmentation_mask(handle(), p, nullptr, masks,
                                                acc));
    }

    Image compute_mask(Region region) const {
        Image out(extent(), Channels::mask);
        compute_mask(region, out.pixels());
        return out;
    }
    void compute_mask(Region region, uint8_t* result_mask) const {
        int r[4] = {region.top_left.x, region.top_left.y,
                    region.bottom_right.x, region.bottom_right.y};
        uint8_t* masks[3] = {result_mask, nullptr, nullptr};
        float acc[3] = {0, 0, 0};
        detail::throw_on_error(
            detail::api().get_segmentation_mask(handle(), nullptr, r, masks,
                                                acc));
    }

    // Three candidate masks with confidences (ambiguous prompts).
    std::array<Mask, 3> compute_masks(Point point) const {
        auto e = extent();
        std::array<Mask, 3> result = {
            Mask{Image(e, Channels::mask), 0.0f},
            Mask{Image(e, Channels::mask), 0.0f},
            Mask{Image(e, Channels::mask), 0.0f}};
        int p[2] = {point.x, point.y};
        uint8_t* masks[3] = {result[0].image.pixels(),
                             result[1].image.pixels(),
                             result[2].image.pixels()};
        float acc[3] = {0, 0, 0};
        detail::throw_on_error(
            detail::api().get_segmentation_mask(handle(), p, nullptr, masks,
                                                acc));
        for (int i = 0; i < 3; ++i) {
            result[i].accuracy = acc[i];
        }
        return result;
    }

    // Automatic mask generation ("segment everything"): every object mask
    // of the image, sorted by predicted IoU. Runs as one on-device program
    // (runtime/amg.py); requires a serving bundle exported with --amg in
    // serving mode. Extension past the reference API.
    std::vector<Mask> generate_masks(float iou_threshold = 0.88f,
                                     float stability_threshold = 0.95f,
                                     float nms_threshold = 0.7f,
                                     int max_masks = 64) const {
        auto e = extent();
        std::vector<Mask> result;
        result.reserve(max_masks);
        std::vector<uint8_t*> ptrs(max_masks);
        for (int i = 0; i < max_masks; ++i) {
            result.push_back(Mask{Image(e, Channels::mask), 0.0f});
            ptrs[i] = result.back().image.pixels();
        }
        std::vector<float> acc(max_masks, 0.0f);
        float thr[3] = {iou_threshold, stability_threshold, nms_threshold};
        int count = 0;
        detail::throw_on_error(detail::api().generate_masks(
            handle(), thr, max_masks, ptrs.data(), acc.data(), &count));
        result.erase(result.begin() + count, result.end());
        for (int i = 0; i < count; ++i) {
            result[i].accuracy = acc[i];
        }
        return result;
    }

    // A point-or-box prompt for compute_mask_batch. Extension past the
    // reference API.
    struct Prompt {
        Point point{};
        Region region{};
        bool is_region = false;
        Prompt(Point p) : point(p) {}
        Prompt(Region r) : region(r), is_region(true) {}
    };

    // Decode MANY prompts against the cached embedding in ONE device
    // program (one dispatch + one fetch; the best mask per prompt).
    // Mirrors runtime/segmentation.py compute_mask_batch. Extension past
    // the reference API.
    std::vector<Mask> compute_mask_batch(Prompt const* prompts,
                                         int count) const {
        auto e = extent();
        std::vector<Mask> result;
        if (count <= 0)  // parity with the Python API: [] -> []
            return result;
        result.reserve(count);
        std::vector<uint8_t*> ptrs(count);
        std::vector<int> flat(size_t(count) * 4, 0);
        std::vector<int> is_region(count, 0);
        for (int i = 0; i < count; ++i) {
            result.push_back(Mask{Image(e, Channels::mask), 0.0f});
            ptrs[i] = result.back().image.pixels();
            Prompt const& p = prompts[i];
            if (p.is_region) {
                flat[4 * i] = p.region.top_left.x;
                flat[4 * i + 1] = p.region.top_left.y;
                flat[4 * i + 2] = p.region.bottom_right.x;
                flat[4 * i + 3] = p.region.bottom_right.y;
                is_region[i] = 1;
            } else {
                flat[4 * i] = p.point.x;
                flat[4 * i + 1] = p.point.y;
            }
        }
        std::vector<float> acc(count, 0.0f);
        detail::throw_on_error(detail::api().compute_mask_batch(
            handle(), flat.data(), is_region.data(), count, ptrs.data(),
            acc.data()));
        for (int i = 0; i < count; ++i) {
            result[i].accuracy = acc[i];
        }
        return result;
    }
    std::vector<Mask> compute_mask_batch(
        std::vector<Prompt> const& prompts) const {
        return compute_mask_batch(prompts.data(), int(prompts.size()));
    }

    Extent extent() const noexcept {
        int e[2] = {0, 0};
        detail::api().get_segmentation_extent(handle(), e);
        return Extent{e[0], e[1]};
    }

    Segmentation(std::nullptr_t) noexcept {}
};

// Dichotomous foreground segmentation (BiRefNet).
inline Image segment_objects(ImageView const& img, Environment const& env) {
    Image out(img.extent, Channels::mask);
    auto v = detail::to_c(img);
    detail::throw_on_error(
        detail::api().segment_objects(&v, out.pixels(), env.handle()));
    return out;
}
inline void segment_objects(ImageView const& img, uint8_t* out_mask,
                            Environment const& env) {
    auto v = detail::to_c(img);
    detail::throw_on_error(
        detail::api().segment_objects(&v, out_mask, env.handle()));
}

// Initialise the API table (automatic when linked; explicit for dlopen use).
inline void initialize(dlimg_Api const* api = dlimg_init()) {
    detail::set_api(api);
}

} // namespace dlimg
