// Native codec test of the PyTorch port's C library (adapted from the JAX
// package's native/test/test_codecs.cpp; built by
// dlimgedit_tpu_torch/native_build.py): PNG round trips through the port's
// own codec (png.cpp, no libpng) for 1, 3 and 4 channels, tight and with a
// padded stride, the built-in containers, a JPEG decode where the build
// has libjpeg, and a corrupt-input fuzz, all through the dlimg_Api table,
// asserting the embedded Python interpreter is NEVER initialised — the
// codec path is native end-to-end (the reference's counterpart is stb, its
// src/image.cpp:11-35).
//
// Run: test_codecs [JPEG WIDTH HEIGHT]  (exit 0 == pass). With a JPEG file
// and its size it also decodes that file, and fails if the build cannot;
// its files go to $TMPDIR.

#include <Python.h>  // only for Py_IsInitialized assertions

#include <dlimgedit/detail/dlimgedit.h>

#include <cstdio>
#include <vector>
#include <cstdlib>
#include <cstring>
#include <initializer_list>
#include <string>

#define CHECK(cond)                                                     \
    do {                                                                \
        if (!(cond)) {                                                  \
            std::fprintf(stderr, "FAILED %s:%d: %s\n", __FILE__,        \
                         __LINE__, #cond);                              \
            return 1;                                                   \
        }                                                               \
    } while (0)

// A file under $TMPDIR (else /tmp); the pointer lives until the next call
// with the same slot.
static char const* tmp_file(char const* name, int slot = 0) {
    static std::string paths[4];
    char const* dir = std::getenv("TMPDIR");
    paths[slot] = std::string(dir && *dir ? dir : "/tmp") + "/" + name;
    return paths[slot].c_str();
}

int main(int argc, char** argv) {
    dlimg_Api const* api = dlimg_init();
    CHECK(api != nullptr);
    CHECK(!Py_IsInitialized());

    // --- PNG round-trip (mask, rgb, rgba; tight and padded rows) ---------
    for (int c : {1, 3, 4}) {
        for (int pad : {0, 5}) {
            int const w = 13, h = 7, stride = pad ? w * c + pad : 0;
            int const pitch = w * c + pad;
            std::vector<uint8_t> px(size_t(pitch) * h, 0xEE);
            for (int y = 0; y < h; ++y)
                for (int i = 0; i < w * c; ++i)
                    px[size_t(y) * pitch + i] =
                        uint8_t(((y * w * c + i) * 37 + c) & 0xFF);

            char name[64];
            std::snprintf(name, sizeof name, "dlimg_codec_%d_%d.png", c, pad);
            char const* path = tmp_file(name);
            dlimg_ImageView view{w, h, c, stride, px.data()};
            CHECK(api->save_image(&view, path) == dlimg_success);

            int extent[2] = {0, 0}, channels = 0;
            uint8_t* loaded = nullptr;
            CHECK(api->load_image(path, extent, &channels, &loaded) ==
                  dlimg_success);
            CHECK(extent[0] == w && extent[1] == h && channels == c);
            for (int y = 0; y < h; ++y)
                CHECK(std::memcmp(loaded + size_t(y) * w * c,
                                  px.data() + size_t(y) * pitch,
                                  size_t(w) * c) == 0);
            api->destroy_image(loaded);
            std::remove(path);
        }
    }
    std::puts("png: 1, 3 and 4 channels, tight and padded, read back exact");

    // --- a JPEG decode (a file named on the command line) ------------------
    if (argc == 4) {
        int extent[2] = {0, 0}, channels = 0;
        uint8_t* px = nullptr;
        if (api->load_image(argv[1], extent, &channels, &px) != dlimg_success) {
            std::fprintf(stderr, "load %s: %s\n", argv[1], api->last_error());
            return 1;
        }
        CHECK(extent[0] == std::atoi(argv[2]) &&
              extent[1] == std::atoi(argv[3]) && channels == 3);
        long sum = 0;  // non-degenerate content
        for (int i = 0; i < 1000 && i < extent[0] * extent[1] * 3; ++i)
            sum += px[i];
        CHECK(sum > 0);
        api->destroy_image(px);
        std::printf("jpeg: decoded %s natively (%dx%d)\n", argv[1], extent[0],
                    extent[1]);
    }

    // --- built-in PNM / GIF / PSD / HDR decoders (stb container parity) ---
    auto write_file = [](char const* path, std::initializer_list<int> bytes) {
        std::FILE* o = std::fopen(path, "wb");
        if (!o) return false;
        for (int b : bytes) std::fputc(b, o);
        std::fclose(o);
        return true;
    };
    auto load_ok = [&](char const* path, int ew, int eh, int ec,
                       uint8_t** out) {
        int extent[2] = {0, 0}, channels = 0;
        if (api->load_image(path, extent, &channels, out) != dlimg_success) {
            std::fprintf(stderr, "load %s: %s\n", path, api->last_error());
            return false;
        }
        return extent[0] == ew && extent[1] == eh && channels == ec;
    };
    {
        // P6, 2x2, with a header comment.
        char const* p = tmp_file("dlimg_codec.ppm");
        CHECK(write_file(p, {'P', '6', '\n', '#', 'c', '\n', '2', ' ', '2',
                             '\n', '2', '5', '5', '\n',  //
                             1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12}));
        uint8_t* px = nullptr;
        CHECK(load_ok(p, 2, 2, 3, &px));
        for (int i = 0; i < 12; ++i) CHECK(px[i] == i + 1);
        api->destroy_image(px);
        std::remove(p);

        // P5 16-bit: big-endian samples narrow to the high byte.
        p = tmp_file("dlimg_codec.pgm");
        CHECK(write_file(p, {'P', '5', ' ', '2', ' ', '1', ' ', '6', '5', '5',
                             '3', '5', '\n', 0xAB, 0xCD, 0x12, 0x34}));
        CHECK(load_ok(p, 2, 1, 1, &px));
        CHECK(px[0] == 0xAB && px[1] == 0x12);
        api->destroy_image(px);
        std::remove(p);
    }
    {
        // GIF 2x2, 2-colour global palette, indices {0,1,1,0}; hand-packed
        // LZW (min code 2): clear,0,1,1,0,end with the width bump to 4 bits
        // after the table fills to 8 entries.
        char const* p = tmp_file("dlimg_codec.gif");
        CHECK(write_file(
            p, {'G', 'I', 'F', '8', '9', 'a', 2, 0, 2, 0, 0x80, 0, 0,  //
                10, 20, 30, 200, 150, 100,                 // palette
                0x2C, 0, 0, 0, 0, 2, 0, 2, 0, 0,           // image descriptor
                2, 3, 0x44, 0x02, 0x05, 0,                 // LZW data
                0x3B}));
        uint8_t* px = nullptr;
        CHECK(load_ok(p, 2, 2, 4, &px));
        uint8_t const want[16] = {10, 20, 30, 255, 200, 150, 100, 255,
                                  200, 150, 100, 255, 10, 20, 30, 255};
        CHECK(std::memcmp(px, want, 16) == 0);
        api->destroy_image(px);
        std::remove(p);
    }
    {
        // PSD raw 8-bit RGB 2x2 (planar), alpha filled with 255.
        char const* p = tmp_file("dlimg_codec.psd");
        CHECK(write_file(
            p, {'8', 'B', 'P', 'S', 0, 1, 0, 0, 0, 0, 0, 0,  // sig+ver+resv
                0, 3,                                          // channels
                0, 0, 0, 2, 0, 0, 0, 2,                        // h, w
                0, 8, 0, 3,                                    // depth, RGB
                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,            // 3 sections
                0, 0,                                          // raw
                1, 2, 3, 4, 11, 12, 13, 14, 21, 22, 23, 24})); // R,G,B planes
        uint8_t* px = nullptr;
        CHECK(load_ok(p, 2, 2, 4, &px));
        uint8_t const want[16] = {1, 11, 21, 255, 2, 12, 22, 255,
                                  3, 13, 23, 255, 4, 14, 24, 255};
        CHECK(std::memcmp(px, want, 16) == 0);
        api->destroy_image(px);
        std::remove(p);
    }
    {
        // HDR flat RGBE 2x1: (128,128,128,e=129) == 1.0 -> 255 after the
        // gamma-2.2 LDR conversion; zero exponent -> 0.
        char const* p = tmp_file("dlimg_codec.hdr");
        std::FILE* o = std::fopen(p, "wb");
        CHECK(o != nullptr);
        std::fputs("#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n", o);
        uint8_t const rgbe[8] = {128, 128, 128, 129, 0, 0, 0, 0};
        std::fwrite(rgbe, 1, 8, o);
        std::fclose(o);
        uint8_t* px = nullptr;
        CHECK(load_ok(p, 2, 1, 3, &px));
        CHECK(px[0] == 255 && px[1] == 255 && px[2] == 255);
        CHECK(px[3] == 0 && px[4] == 0 && px[5] == 0);
        api->destroy_image(px);
        std::remove(p);
    }
    {
        // Softimage PIC 2x1 RGB: mixed-RLE packet, one 2-pixel run.
        char const* p = tmp_file("dlimg_codec.pic");
        std::vector<uint8_t> pic = {0x53, 0x80, 0xF6, 0x34, 0, 0, 0, 0};
        pic.resize(88, 'c');                        // version junk + comment
        for (char ch : {'P', 'I', 'C', 'T'}) pic.push_back(uint8_t(ch));
        uint8_t const tail[] = {0, 2, 0, 1,          // w=2, h=1
                                0, 0, 0, 0, 0, 3, 0, 0,  // ratio, fields, pad
                                0, 8, 2, 0xE0,       // one RGB mixed-RLE pkt
                                129, 7, 8, 9};       // run of 2 x (7,8,9)
        pic.insert(pic.end(), tail, tail + sizeof tail);
        std::FILE* o = std::fopen(p, "wb");
        CHECK(o != nullptr);
        CHECK(std::fwrite(pic.data(), 1, pic.size(), o) == pic.size());
        std::fclose(o);
        uint8_t* px = nullptr;
        CHECK(load_ok(p, 2, 1, 3, &px));
        uint8_t const want[6] = {7, 8, 9, 7, 8, 9};
        CHECK(std::memcmp(px, want, 6) == 0);
        api->destroy_image(px);
        std::remove(p);
        std::puts("pnm/gif/psd/hdr/pic: built-in decoders exact");
    }

    // --- error path -------------------------------------------------------
    {
        int extent[2], channels;
        uint8_t* px = nullptr;
        CHECK(api->load_image("/nonexistent/x.png", extent, &channels, &px) ==
              dlimg_error);
        CHECK(std::strlen(api->last_error()) > 0);
    }

    // --- corrupt-input fuzz (deterministic) -------------------------------
    // Truncations and bit-flips of valid encodes, plus magic-prefixed
    // garbage, must return dlimg_error (or succeed, for flips a decoder
    // tolerates) — never crash the host and never initialise Python. The
    // reference gets this from stb's fuzz-hardened decoders (its
    // src/image.cpp:11-35); the port's PNG decoder (png.cpp: CRC-32,
    // Adler-32, lengths and sizes checked) and libjpeg's error path (a
    // setjmp trampoline, codecs.cpp) are what this exercises.
    {
        // Run the fuzz under the serving-mode contract: corrupt inputs
        // whose magic bytes are destroyed fall out of the native sniffer,
        // and in serving mode that must ERROR, not boot the embedded
        // interpreter (capi.cpp gates the Python codec fallback on
        // DLIMG_PJRT_BUNDLE). The final !Py_IsInitialized() check below is
        // what this protects.
        setenv("DLIMG_PJRT_BUNDLE", "/nonexistent-serving-bundle", 1);
        // A real encode to mutate: 16x16 RGB PNG.
        int const w = 16, h = 16, c = 3;
        uint8_t* px = api->create_image(w, h, c);
        CHECK(px != nullptr);
        for (int i = 0; i < w * h * c; ++i) px[i] = uint8_t((i * 131) & 0xFF);
        char const* base = tmp_file("dlimg_fuzz_base.png", 1);
        dlimg_ImageView view{w, h, c, 0, px};
        CHECK(api->save_image(&view, base) == dlimg_success);
        api->destroy_image(px);

        std::FILE* f = std::fopen(base, "rb");
        CHECK(f != nullptr);
        uint8_t buf[1 << 14];
        size_t n = std::fread(buf, 1, sizeof buf, f);
        std::fclose(f);
        CHECK(n > 64 && n < sizeof buf);

        uint32_t lcg = 0x12345678u;  // deterministic PRNG
        auto next = [&lcg]() {
            lcg = lcg * 1664525u + 1013904223u;
            return lcg;
        };
        char const* path = tmp_file("dlimg_fuzz_case.bin", 2);
        int decoded = 0, rejected = 0;
        auto try_load = [&](uint8_t const* data, size_t len) {
            std::FILE* o = std::fopen(path, "wb");
            CHECK(o != nullptr);
            std::fwrite(data, 1, len, o);
            std::fclose(o);
            int extent[2] = {0, 0}, channels = 0;
            uint8_t* out = nullptr;
            int rc = api->load_image(path, extent, &channels, &out);
            if (rc == dlimg_success) {
                CHECK(out != nullptr && extent[0] > 0 && extent[1] > 0);
                api->destroy_image(out);
                ++decoded;
            } else {
                CHECK(std::strlen(api->last_error()) > 0);
                ++rejected;
            }
            return 0;
        };
        // Truncations: every power-of-two prefix + 32 random cut points.
        for (size_t len = 1; len < n; len *= 2) try_load(buf, len);
        for (int i = 0; i < 32; ++i) try_load(buf, 1 + next() % (n - 1));
        // Bit flips: 64 single-byte corruptions at random offsets.
        for (int i = 0; i < 64; ++i) {
            uint8_t tmp[sizeof buf];
            std::memcpy(tmp, buf, n);
            tmp[next() % n] ^= uint8_t(1u << (next() % 8));
            try_load(tmp, n);
        }
        // Magic-prefixed garbage (PNG + JPEG signatures, random tail).
        uint8_t junk[512];
        for (auto& b : junk) b = uint8_t(next());
        std::memcpy(junk, "\x89PNG\r\n\x1a\n", 8);
        try_load(junk, sizeof junk);
        junk[0] = 0xFF; junk[1] = 0xD8; junk[2] = 0xFF; junk[3] = 0xE0;
        try_load(junk, sizeof junk);
        // Built-in decoders (PNM/GIF/PSD/HDR): magic-prefixed garbage plus
        // truncations and bit-flips of the valid encodes from above — these
        // run OUR parsing code, not a system library's.
        {
            char const* magics[] = {"P6 ", "GIF8", "8BPS", "#?RADIANCE\n",
                                    "\x53\x80\xf6\x34"};
            for (auto m : magics) {
                std::memcpy(junk, m, std::strlen(m));
                try_load(junk, sizeof junk);
            }
            uint8_t const gif[] = {'G', 'I', 'F', '8', '9', 'a', 2, 0, 2, 0,
                                   0x80, 0, 0, 10, 20, 30, 200, 150, 100,
                                   0x2C, 0, 0, 0, 0, 2, 0, 2, 0, 0,
                                   2, 3, 0x44, 0x02, 0x05, 0, 0x3B};
            uint8_t const psd[] = {'8', 'B', 'P', 'S', 0, 1, 0, 0, 0, 0, 0,
                                   0, 0, 3, 0, 0, 0, 2, 0, 0, 0, 2, 0, 8,
                                   0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   0, 0, 0, 1, 2, 3, 4, 11, 12, 13, 14, 21,
                                   22, 23, 24};
            uint8_t const pnm[] = {'P', '6', ' ', '2', ' ', '2', ' ', '2',
                                   '5', '5', '\n', 1, 2, 3, 4, 5, 6, 7, 8,
                                   9, 10, 11, 12};
            uint8_t hdr_buf[64];
            size_t hdr_n = 0;
            {
                char const* head =
                    "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n";
                std::memcpy(hdr_buf, head, std::strlen(head));
                hdr_n = std::strlen(head);
                uint8_t const rgbe[8] = {128, 128, 128, 129, 0, 0, 0, 0};
                std::memcpy(hdr_buf + hdr_n, rgbe, 8);
                hdr_n += 8;
            }
            uint8_t pic_buf[128];
            size_t pic_n = 0;
            {
                // The valid PIC from the decode check above: 104-byte
                // header + one mixed-RLE RGB packet + a run of 2 pixels.
                uint8_t const head[8] = {0x53, 0x80, 0xF6, 0x34, 0, 0, 0, 0};
                std::memcpy(pic_buf, head, 8);
                std::memset(pic_buf + 8, 'c', 80);
                std::memcpy(pic_buf + 88, "PICT", 4);
                uint8_t const tail[] = {0, 2, 0, 1, 0, 0, 0, 0, 0, 3, 0, 0,
                                        0, 8, 2, 0xE0, 129, 7, 8, 9};
                std::memcpy(pic_buf + 92, tail, sizeof tail);
                pic_n = 92 + sizeof tail;
            }
            struct { uint8_t const* d; size_t n; } cases[] = {
                {gif, sizeof gif}, {psd, sizeof psd}, {pnm, sizeof pnm},
                {hdr_buf, hdr_n}, {pic_buf, pic_n}};
            for (auto const& cse : cases) {
                for (size_t len = 1; len < cse.n; ++len)  // every truncation
                    try_load(cse.d, len);
                for (int i = 0; i < 64; ++i) {  // single-byte corruptions
                    uint8_t tmp[128];
                    std::memcpy(tmp, cse.d, cse.n);
                    tmp[next() % cse.n] ^= uint8_t(1u << (next() % 8));
                    try_load(tmp, cse.n);
                }
            }
        }
        CHECK(rejected > 0);  // truncations can't all decode
        std::printf("fuzz: %d decoded / %d rejected, no crash\n", decoded,
                    rejected);
        std::remove(base);
        std::remove(path);
    }

    // The whole codec path ran without Python.
    CHECK(!Py_IsInitialized());
    std::puts("native codecs: all checks passed, libpython never initialised");
    return 0;
}
