// DLIMGEDIT_LOAD_DYNAMIC mode (a copy of the JAX package's
// native/test/test_cpp_dynamic.cpp, run on the PyTorch port's library):
// the runtime-loading deployment shape the reference documents at
// dlimgedit.hpp:176-179 — the client does NOT link the library
// (libdlimgedit_tpu_torch.so); it defines DLIMGEDIT_LOAD_DYNAMIC (so the header
// never auto-calls dlimg_init), dlopens the library, resolves dlimg_init
// itself, and passes the table to dlimg::initialize(). This binary links
// only libdl; a link-time dependency on the library would defeat the test.

#define DLIMGEDIT_LOAD_DYNAMIC
#include <dlimgedit/dlimgedit.hpp>

#include <dlfcn.h>

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
    char const* libpath = argc > 1 ? argv[1] : "libdlimgedit_tpu_torch.so";
    // RTLD_GLOBAL: the embedded-Python runtime inside the library loads
    // CPython extension modules (numpy, torch) that resolve libpython
    // symbols through the GLOBAL namespace; RTLD_LOCAL would hide them and
    // every backend probe would fail.
    void* lib = dlopen(libpath, RTLD_NOW | RTLD_GLOBAL);
    if (!lib) {
        std::fprintf(stderr, "dlopen(%s): %s\n", libpath, dlerror());
        return 1;
    }
    using InitFn = dlimg_Api const* (*)();
    auto init = reinterpret_cast<InitFn>(dlsym(lib, "dlimg_init"));
    CHECK(init != nullptr);

    // The documented dynamic-mode handshake (reference :176-179).
    dlimg::initialize(init());

    using namespace dlimg;
    CHECK(Environment::is_supported(Backend::cpu));

    // The whole header works off the runtime-resolved table: allocate via
    // the ABI, round-trip a codec, and surface an error as an Exception.
    Image img(Extent{12, 10}, Channels::rgb);
    for (size_t i = 0; i < img.size(); ++i) {
        img.pixels()[i] = uint8_t(i * 7);
    }
    char const* tmp = std::getenv("TMPDIR");
    std::string const path = std::string(tmp && *tmp ? tmp : "/tmp") +
                             "/dlimg_dynamic_roundtrip.png";
    Image::save(ImageView(img), path.c_str());
    auto loaded = Image::load(path.c_str());
    CHECK(loaded.extent().width == 12 && loaded.extent().height == 10);
    CHECK(std::memcmp(loaded.pixels(), img.pixels(), img.size()) == 0);

    bool threw = false;
    try {
        Image::load("/nonexistent/nope.png");
    } catch (Exception const& e) {
        threw = e.what()[0] != '\0';
    }
    CHECK(threw);

    std::printf("CPP_DYNAMIC_OK\n");
    return 0;
}
