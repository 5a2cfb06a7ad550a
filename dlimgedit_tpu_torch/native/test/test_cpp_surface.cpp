// Exhaustive compile + behavior sweep of the public C++14 API surface,
// against the PyTorch port's C library (adapted from the JAX package's
// native/test/test_cpp_surface.cpp; built by
// dlimgedit_tpu_torch/native_build.py).
//
// Written as a reference client: every public declaration of the upstream
// header (the reference's src/include/dlimgedit/dlimgedit.hpp:23-191) is
// instantiated and behaviourally checked here — types and aggregates
// (Extent, Channels + count, Point, Region and its constexpr ctors),
// ImageView's three constructors, the full Image surface (alloc, accessors,
// size, load/save via char* AND std::filesystem::path, move ctor/assign,
// deleted copies), Environment (Options, is_supported, nullptr_t ctor,
// handle moves), Segmentation (process, compute_mask Point/Region in both
// overloads, compute_masks, extent, nullptr_t ctor, moves), bgra/argb
// inputs at API level, segment_objects in both overloads, initialize(), and
// Exception. The dlopen/DLIMGEDIT_LOAD_DYNAMIC mode is covered by the
// sibling test_cpp_dynamic.cpp (a separate binary that never links us).
//
// Compile-time contracts are pinned with static_asserts so a silent
// signature drift in the header fails the BUILD, not just the run.
//
// Run: test_cpp_surface (exit 0 and CPP_SURFACE_OK == pass) with the
// environment a CPU bridge needs (DLIMG_ALLOW_RANDOM_WEIGHTS=1, a small
// DLIMG_SAM_IMAGE_SIZE, the slim BiRefNet); its files go to $TMPDIR.

#include <dlimgedit/dlimgedit.hpp>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <filesystem>
#include <type_traits>
#include <vector>

#define CHECK(cond)                                                            \
    do {                                                                       \
        if (!(cond)) {                                                         \
            std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,      \
                         __LINE__, #cond);                                     \
            return 1;                                                          \
        }                                                                      \
    } while (0)

namespace dl = dlimg;

// A file under $TMPDIR (else /tmp).
static std::string tmp_file(char const* name) {
    char const* dir = std::getenv("TMPDIR");
    return std::string(dir && *dir ? dir : "/tmp") + "/" + name;
}

// ---- compile-time surface pins (reference header :23-191) ------------------

// Channels / count (:29-32).
static_assert(dl::count(dl::Channels::mask) == 1, "count(mask)");
static_assert(dl::count(dl::Channels::rgb) == 3, "count(rgb)");
static_assert(dl::count(dl::Channels::rgba) == 4, "count(rgba)");
static_assert(dl::count(dl::Channels::bgra) == 4, "count(bgra)");
static_assert(dl::count(dl::Channels::argb) == 4, "count(argb)");
static_assert(int(dl::Channels::mask) == 1 && int(dl::Channels::rgb) == 3 &&
                  int(dl::Channels::rgba) == 4,
              "reference numeric values (:29)");

// ImageView constructors (:36-45) and noexcept contracts.
static_assert(std::is_nothrow_default_constructible<dl::ImageView>::value,
              "ImageView() noexcept (:41)");
static_assert(std::is_nothrow_constructible<dl::ImageView, uint8_t const*,
                                            dl::Extent, dl::Channels>::value,
              "ImageView(ptr, Extent, Channels) noexcept (:43)");
static_assert(std::is_nothrow_constructible<dl::ImageView,
                                            dl::Image const&>::value,
              "ImageView(Image const&) noexcept (:44)");

// Image move-only semantics (:69-73).
static_assert(!std::is_copy_constructible<dl::Image>::value,
              "Image copy ctor deleted (:72)");
static_assert(!std::is_copy_assignable<dl::Image>::value,
              "Image copy assign deleted (:73)");
static_assert(std::is_nothrow_move_constructible<dl::Image>::value,
              "Image(Image&&) noexcept (:70)");
static_assert(std::is_nothrow_move_assignable<dl::Image>::value,
              "Image& operator=(Image&&) noexcept (:71)");

// Environment / Segmentation handle semantics (:100-168).
static_assert(!std::is_copy_constructible<dl::Environment>::value,
              "Environment is a move-only Handle");
static_assert(std::is_nothrow_constructible<dl::Environment,
                                            std::nullptr_t>::value,
              "Environment(nullptr_t) noexcept (:112)");
static_assert(!std::is_copy_constructible<dl::Segmentation>::value,
              "Segmentation is a move-only Handle");
static_assert(std::is_nothrow_constructible<dl::Segmentation,
                                            std::nullptr_t>::value,
              "Segmentation(nullptr_t) noexcept (:167)");
static_assert(noexcept(dl::Environment::is_supported(dl::Backend::cpu)),
              "is_supported noexcept (:107)");

// Region constexpr constructors (:123-133) usable at compile time.
constexpr dl::Region kR1{dl::Point{3, 4}, dl::Point{13, 24}};
constexpr dl::Region kR2{dl::Point{3, 4}, dl::Extent{10, 20}};
static_assert(kR1.extent().width == 10 && kR1.extent().height == 20,
              "Region(Point, Point).extent()");
static_assert(kR2.bottom_right.x == 13 && kR2.bottom_right.y == 24,
              "Region(Point, Extent)");
constexpr dl::Region kRDefault;
static_assert(kRDefault.top_left.x == 0 && kRDefault.extent().width == 0,
              "Region() constexpr default");

// compute_masks returns std::array<Mask, 3> (:157).
static_assert(
    std::is_same<decltype(std::declval<dl::Segmentation const&>()
                              .compute_masks(dl::Point{})),
                 std::array<dl::Segmentation::Mask, 3>>::value,
    "compute_masks -> std::array<Mask, 3>");

// Exception is a std::exception with what() (:182-191).
static_assert(std::is_base_of<std::exception, dl::Exception>::value,
              "Exception : std::exception");

static bool is_binary_mask(dl::Image const& m) {
    if (m.channels() != dl::Channels::mask) {
        return false;
    }
    for (size_t i = 0; i < m.size(); ++i) {
        if (m.pixels()[i] != 0 && m.pixels()[i] != 255) {
            return false;
        }
    }
    return true;
}

int main() {
    using namespace dlimg;

    // initialize() is idempotent and explicit-callable even when linked
    // (:178-180); the default argument is the exported dlimg_init.
    initialize();
    initialize(dlimg_init());

    // ---- Environment (:100-113) -------------------------------------------
    CHECK(Environment::is_supported(Backend::cpu));
    (void)Environment::is_supported(Backend::gpu); // must not throw

    Environment null_env(nullptr);
    CHECK(!null_env);

    Options opts; // defaults compile: backend=cpu, model_directory="models"
    opts.backend = Backend::cpu;
    Environment env(opts);
    CHECK(env.handle() != nullptr);

    // Handle moves: ownership transfers, source is nulled.
    Environment moved(std::move(env));
    CHECK(moved.handle() != nullptr && env.handle() == nullptr);
    null_env = std::move(moved);
    CHECK(null_env.handle() != nullptr && moved.handle() == nullptr);
    Environment& live_env = null_env;

    // ---- ImageView (:36-45) -----------------------------------------------
    ImageView default_view;
    CHECK(default_view.pixels == nullptr && default_view.stride == 0 &&
          default_view.channels == Channels::rgba);

    Extent extent{96, 64};
    std::vector<uint8_t> rgba(size_t(extent.width) * extent.height * 4);
    for (size_t i = 0; i < rgba.size(); ++i) {
        rgba[i] = uint8_t((i * 31) & 0xff);
    }
    ImageView view(rgba.data(), extent); // default Channels::rgba (:43)
    CHECK(view.stride == extent.width * 4 && view.pixels == rgba.data());

    // ---- Image (:48-84) ----------------------------------------------------
    Image owned(extent, Channels::rgba);
    CHECK(owned.size() == rgba.size());
    std::memcpy(owned.pixels(), rgba.data(), rgba.size());
    ImageView from_image(owned); // ImageView(Image const&) (:44)
    CHECK(from_image.pixels == owned.pixels() &&
          from_image.extent.width == 96 &&
          from_image.channels == Channels::rgba);

    // Move ctor/assign: pixel pointer transfers, source loses ownership.
    uint8_t* raw = owned.pixels();
    Image moved_img(std::move(owned));
    CHECK(moved_img.pixels() == raw && owned.pixels() == nullptr);
    Image assigned(Extent{1, 1}, Channels::mask);
    assigned = std::move(moved_img);
    CHECK(assigned.pixels() == raw);

    // load/save via char* (:60-63) and std::filesystem::path (:65-67).
    std::string const c_path = tmp_file("dlimg_surface_c.png");
    Image::save(ImageView(assigned), c_path.c_str());
    auto loaded_c = Image::load(c_path.c_str());
    CHECK(loaded_c.extent().width == 96 && loaded_c.extent().height == 64);
    CHECK(loaded_c.channels() == Channels::rgba &&
          std::memcmp(loaded_c.pixels(), assigned.pixels(), assigned.size()) ==
              0);
    std::filesystem::path fs_path(tmp_file("dlimg_surface_fs.png"));
    Image::save(ImageView(assigned), fs_path);
    auto loaded_fs = Image::load(fs_path);
    CHECK(loaded_fs.size() == loaded_c.size() &&
          std::memcmp(loaded_fs.pixels(), loaded_c.pixels(),
                      loaded_c.size()) == 0);

    // ---- Segmentation (:138-168) ------------------------------------------
    auto seg = Segmentation::process(view, live_env);
    CHECK(seg.extent().width == 96 && seg.extent().height == 64);

    // compute_mask(Point) in both overloads — identical pixels (:149-150).
    Point pt{48, 32};
    auto point_mask = seg.compute_mask(pt);
    CHECK(is_binary_mask(point_mask));
    std::vector<uint8_t> point_raw(point_mask.size());
    seg.compute_mask(pt, point_raw.data());
    CHECK(std::memcmp(point_raw.data(), point_mask.pixels(),
                      point_mask.size()) == 0);

    // compute_mask(Region) in both overloads (:160-161).
    Region box{Point{10, 10}, Point{80, 50}};
    auto region_mask = seg.compute_mask(box);
    CHECK(is_binary_mask(region_mask));
    std::vector<uint8_t> region_raw(region_mask.size());
    seg.compute_mask(box, region_raw.data());
    CHECK(std::memcmp(region_raw.data(), region_mask.pixels(),
                      region_mask.size()) == 0);

    // compute_masks: 3 candidates, binary, full extent (:152-157).
    auto candidates = seg.compute_masks(pt);
    for (auto const& m : candidates) {
        CHECK(m.image.extent().width == 96 && is_binary_mask(m.image));
    }

    // compute_mask_batch (extension): mixed point/box batch, one device
    // program, per-prompt parity with the single-prompt entries.
    std::vector<Segmentation::Prompt> prompts = {
        Segmentation::Prompt(pt), Segmentation::Prompt(box)};
    auto batched = seg.compute_mask_batch(prompts);
    CHECK(batched.size() == 2);
    CHECK(std::memcmp(batched[0].image.pixels(), point_mask.pixels(),
                      point_mask.size()) == 0);
    CHECK(std::memcmp(batched[1].image.pixels(), region_mask.pixels(),
                      region_mask.size()) == 0);

    // Segmentation handle moves + nullptr ctor (:167).
    Segmentation null_seg(nullptr);
    CHECK(!null_seg);
    null_seg = std::move(seg);
    CHECK(null_seg.handle() != nullptr && seg.handle() == nullptr);
    CHECK(null_seg.extent().width == 96); // still queryable after the move

    // ---- bgra / argb at API level (:29) ------------------------------------
    // The same image fed as bgra (B<->R swapped buffer) must produce the
    // SAME mask as rgba — proving the channel map is honoured end to end.
    std::vector<uint8_t> bgra(rgba.size());
    for (size_t i = 0; i < rgba.size(); i += 4) {
        bgra[i + 0] = rgba[i + 2];
        bgra[i + 1] = rgba[i + 1];
        bgra[i + 2] = rgba[i + 0];
        bgra[i + 3] = rgba[i + 3];
    }
    auto seg_bgra =
        Segmentation::process(ImageView(bgra.data(), extent, Channels::bgra),
                              live_env);
    auto mask_bgra = seg_bgra.compute_mask(pt);
    CHECK(std::memcmp(mask_bgra.pixels(), point_mask.pixels(),
                      point_mask.size()) == 0);

    std::vector<uint8_t> argb(rgba.size());
    for (size_t i = 0; i < rgba.size(); i += 4) {
        argb[i + 0] = rgba[i + 3];
        argb[i + 1] = rgba[i + 0];
        argb[i + 2] = rgba[i + 1];
        argb[i + 3] = rgba[i + 2];
    }
    auto seg_argb =
        Segmentation::process(ImageView(argb.data(), extent, Channels::argb),
                              live_env);
    auto mask_argb = seg_argb.compute_mask(pt);
    CHECK(std::memcmp(mask_argb.pixels(), point_mask.pixels(),
                      point_mask.size()) == 0);

    // rgb (3-channel) input is accepted too.
    std::vector<uint8_t> rgb(size_t(extent.width) * extent.height * 3);
    for (size_t i = 0, j = 0; i < rgba.size(); i += 4, j += 3) {
        rgb[j] = rgba[i];
        rgb[j + 1] = rgba[i + 1];
        rgb[j + 2] = rgba[i + 2];
    }
    auto seg_rgb = Segmentation::process(
        ImageView(rgb.data(), extent, Channels::rgb), live_env);
    CHECK(seg_rgb.extent().width == 96);

    // ---- segment_objects, both overloads (:172-173) ------------------------
    // (A grayscale 0..255 mask, like the reference's — NOT thresholded.)
    auto fg = segment_objects(view, live_env);
    CHECK(fg.extent().width == 96 && fg.channels() == Channels::mask);
    std::vector<uint8_t> fg_raw(fg.size());
    segment_objects(view, fg_raw.data(), live_env);
    CHECK(std::memcmp(fg_raw.data(), fg.pixels(), fg.size()) == 0);

    // ---- Exception (:182-191) ----------------------------------------------
    bool threw = false;
    try {
        Image::load("/nonexistent/nope.png");
    } catch (Exception const& e) {
        threw = e.what() != nullptr && e.what()[0] != '\0';
    }
    CHECK(threw);
    // A null environment handle is an error, not a crash.
    threw = false;
    try {
        Environment empty(nullptr);
        (void)Segmentation::process(view, empty);
    } catch (Exception const&) {
        threw = true;
    }
    CHECK(threw);

    std::printf("CPP_SURFACE_OK\n");
    return 0;
}
