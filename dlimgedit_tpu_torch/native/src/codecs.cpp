// Native image codecs: libpng/libjpeg + built-in BMP/TGA/PNM/GIF/PSD/HDR/PIC.
//
// A copy of the JAX package's native/src/codecs.cpp. Counterpart of the
// reference's stb-backed layer (its src/image.cpp:11-35) with the same
// contract: decoded images keep their file-native channel count,
// restricted to {1,3,4}; saving is PNG-only. Container coverage matches
// what stbi_load accepts (the reference imposes no format restriction
// beyond the channel check), including Softimage PIC. Semantics are spec-faithful, with stb's LDR
// conventions where a conversion is needed: 16-bit samples narrow by
// taking the high byte, GIF decodes the first frame onto a transparent
// canvas, HDR tone-maps RGBE with gamma 2.2 / scale 1 (stb's
// hdr_to_ldr defaults). Divergence, documented: PSD composites are
// decoded per the spec WITHOUT stb's white-matte removal heuristic.
// Independent implementation on the system codecs.

#include "codecs.hpp"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef DLIMG_HAVE_LIBPNG
#include <png.h>
#endif
#ifdef DLIMG_HAVE_LIBJPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace dlimg_native {
namespace {

struct File {
    std::FILE* f = nullptr;
    explicit File(char const* path, char const* mode)
        : f(std::fopen(path, mode)) {}
    ~File() {
        if (f) std::fclose(f);
    }
    File(File const&) = delete;
    File& operator=(File const&) = delete;
};

// ---------------------------------------------------------------------------
// PNG (libpng)
// ---------------------------------------------------------------------------

#ifdef DLIMG_HAVE_LIBPNG

uint8_t* load_png(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    // Locals written between setjmp and a potential longjmp must be
    // volatile (C11 7.13.2.1 — non-volatile values are indeterminate after
    // the jump) and must not have destructors (longjmp skips them), hence
    // malloc'd row pointers instead of a std::vector.
    uint8_t* volatile out = nullptr;
    png_bytep* volatile rows = nullptr;
    if (!png || !info) {
        *error = "libpng: allocation failed";
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    if (setjmp(png_jmpbuf(png))) {  // libpng error path
        *error = "libpng: decode failed";
        std::free(rows);
        std::free(out);
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    png_init_io(png, f);
    png_read_info(png, info);

    // Normalise to 8-bit {gray, rgb, rgba} keeping the native channel count
    // (palette -> rgb(a), gray+alpha -> rgba like stb's 2->4 promotion is
    // NOT done: gray+alpha stays 2ch in stb; the reference rejects 2ch, so
    // promote GA to RGBA to stay within the {1,3,4} contract).
    png_set_strip_16(png);
    png_set_packing(png);
    png_byte const ct = png_get_color_type(png, info);
    if (ct == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (ct == PNG_COLOR_TYPE_GRAY && png_get_bit_depth(png, info) < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    // GRAY + tRNS becomes gray+alpha (2ch) after tRNS_to_alpha — promote it
    // to RGBA exactly like GRAY_ALPHA so the {1,3,4} contract holds.
    if (ct == PNG_COLOR_TYPE_GRAY_ALPHA ||
        (ct == PNG_COLOR_TYPE_GRAY &&
         png_get_valid(png, info, PNG_INFO_tRNS)))
        png_set_gray_to_rgb(png);
    png_read_update_info(png, info);

    *w = int(png_get_image_width(png, info));
    *h = int(png_get_image_height(png, info));
    *channels = int(png_get_channels(png, info));
    size_t rowbytes = png_get_rowbytes(png, info);
    out = static_cast<uint8_t*>(std::malloc(rowbytes * *h));
    rows = static_cast<png_bytep*>(std::malloc(sizeof(png_bytep) * *h));
    if (!out || !rows) {
        *error = "libpng: allocation failed";
        std::free(rows);
        std::free(out);
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    for (int y = 0; y < *h; ++y) rows[y] = out + size_t(y) * rowbytes;
    png_read_image(png, rows);
    png_read_end(png, nullptr);
    std::free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return out;
}

#endif  // DLIMG_HAVE_LIBPNG

// ---------------------------------------------------------------------------
// JPEG (libjpeg)
// ---------------------------------------------------------------------------

#ifdef DLIMG_HAVE_LIBJPEG

struct JpegError {
    jpeg_error_mgr mgr;
    std::jmp_buf jmp;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    std::longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jmp, 1);
}

uint8_t* load_jpeg(std::FILE* f, int* w, int* h, int* channels,
                   std::string* error) {
    jpeg_decompress_struct cinfo;
    JpegError jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    // volatile: written between setjmp and a potential longjmp (see
    // load_png). No destructor-bearing locals in that window either.
    uint8_t* volatile out = nullptr;
    uint8_t* volatile crow = nullptr;
    if (setjmp(jerr.jmp)) {
        *error = "libjpeg: decode failed";
        std::free(crow);
        std::free(out);
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    // CMYK / Adobe YCCK: libjpeg cannot convert these to RGB itself (its
    // default would hand back 4-component CMYK that downstream code would
    // misread as RGBA). Ask for CMYK (YCCK -> CMYK is supported) and
    // convert manually below, stb-style: Adobe files store the components
    // inverted, so r = c*k/255 etc.
    bool const cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
                      cinfo.jpeg_color_space == JCS_YCCK;
    if (cmyk) cinfo.out_color_space = JCS_CMYK;
    jpeg_start_decompress(&cinfo);
    *w = int(cinfo.output_width);
    *h = int(cinfo.output_height);
    *channels = cmyk ? 3 : int(cinfo.output_components);  // 1 (gray) / 3
    size_t rowbytes = size_t(*w) * *channels;
    out = static_cast<uint8_t*>(std::malloc(rowbytes * *h));
    if (cmyk)
        crow = static_cast<uint8_t*>(std::malloc(size_t(*w) * 4));
    if (!out || (cmyk && !crow)) {
        *error = "libjpeg: allocation failed";
        std::free(crow);
        std::free(out);
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* dst = out + size_t(cinfo.output_scanline) * rowbytes;
        if (cmyk) {
            JSAMPROW row = crow;
            jpeg_read_scanlines(&cinfo, &row, 1);
            for (int x = 0; x < *w; ++x) {
                uint8_t const* s = crow + size_t(x) * 4;
                unsigned k = s[3];
                dst[size_t(x) * 3 + 0] = uint8_t((s[0] * k + 127) / 255);
                dst[size_t(x) * 3 + 1] = uint8_t((s[1] * k + 127) / 255);
                dst[size_t(x) * 3 + 2] = uint8_t((s[2] * k + 127) / 255);
            }
        } else {
            JSAMPROW row = dst;
            jpeg_read_scanlines(&cinfo, &row, 1);
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::free(crow);
    return out;
}

#endif  // DLIMG_HAVE_LIBJPEG

// ---------------------------------------------------------------------------
// BMP (built-in: uncompressed BI_RGB 8/24/32-bit, the format stb supports
// most commonly; compressed variants fall back to the bridge)
// ---------------------------------------------------------------------------

uint32_t rd32(uint8_t const* p) {
    return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
           uint32_t(p[3]) << 24;
}
uint16_t rd16(uint8_t const* p) { return uint16_t(p[0] | (p[1] << 8)); }

uint8_t* load_bmp(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    uint8_t hdr[54];
    if (std::fread(hdr, 1, 54, f) != 54 || hdr[0] != 'B' || hdr[1] != 'M') {
        *error = "bmp: bad header";
        return nullptr;
    }
    uint32_t data_off = rd32(hdr + 10);
    uint32_t dib = rd32(hdr + 14);
    int32_t width = int32_t(rd32(hdr + 18));
    int32_t height = int32_t(rd32(hdr + 22));
    uint16_t bpp = rd16(hdr + 28);
    uint32_t compression = rd32(hdr + 30);
    bool flip = height > 0;  // bottom-up when positive
    height = height < 0 ? -height : height;
    if (dib < 40 || compression != 0 || width <= 0 || height <= 0 ||
        (bpp != 8 && bpp != 24 && bpp != 32)) {
        error->clear();  // not handled natively -> bridge fallback
        return nullptr;
    }
    // 8-bit: palette of (data_off - 54 - ...) entries; treat as grayscale
    // only when the palette is the identity gray ramp, else fall back.
    std::vector<uint8_t> palette;
    if (bpp == 8) {
        // data_off < header+dib would wrap the unsigned subtraction to ~4 GB
        // (crafted/corrupt files); a palette can be at most 256 BGRA
        // entries — anything bigger is malformed, not a gray ramp.
        if (data_off < 14 + dib || data_off - 14 - dib > 256 * 4) {
            error->clear();  // malformed/exotic -> bridge fallback
            return nullptr;
        }
        uint32_t pal_bytes = data_off - 14 - dib;
        palette.resize(pal_bytes);
        if (std::fseek(f, long(14 + dib), SEEK_SET) != 0 ||
            std::fread(palette.data(), 1, pal_bytes, f) != pal_bytes) {
            *error = "bmp: truncated palette";
            return nullptr;
        }
        for (size_t i = 0; i * 4 + 2 < palette.size(); ++i) {
            if (palette[i * 4] != i || palette[i * 4 + 1] != i ||
                palette[i * 4 + 2] != i) {
                error->clear();  // colour palette -> bridge
                return nullptr;
            }
        }
    }
    int c = bpp == 8 ? 1 : (bpp == 24 ? 3 : 4);
    size_t src_row = (size_t(width) * (bpp / 8) + 3) & ~size_t(3);
    size_t dst_row = size_t(width) * c;
    uint8_t* out = static_cast<uint8_t*>(std::malloc(dst_row * height));
    std::vector<uint8_t> row(src_row);
    if (!out || std::fseek(f, long(data_off), SEEK_SET) != 0) {
        std::free(out);
        *error = "bmp: seek/alloc failed";
        return nullptr;
    }
    for (int y = 0; y < height; ++y) {
        if (std::fread(row.data(), 1, src_row, f) != src_row) {
            std::free(out);
            *error = "bmp: truncated pixel data";
            return nullptr;
        }
        uint8_t* dst = out + size_t(flip ? height - 1 - y : y) * dst_row;
        for (int x = 0; x < width; ++x) {
            uint8_t const* s = row.data() + size_t(x) * (bpp / 8);
            if (c == 1) {
                dst[x] = s[0];
            } else {  // BMP stores BGR(A)
                dst[size_t(x) * c + 0] = s[2];
                dst[size_t(x) * c + 1] = s[1];
                dst[size_t(x) * c + 2] = s[0];
                if (c == 4) dst[size_t(x) * c + 3] = s[3];
            }
        }
    }
    *w = width;
    *h = height;
    *channels = c;
    return out;
}

// ---------------------------------------------------------------------------
// TGA (built-in: uncompressed + RLE, 8/24/32-bit — the whole practical set)
// ---------------------------------------------------------------------------

uint8_t* load_tga(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    uint8_t hdr[18];
    if (std::fread(hdr, 1, 18, f) != 18) {
        *error = "tga: bad header";
        return nullptr;
    }
    uint8_t id_len = hdr[0], cmap_type = hdr[1], img_type = hdr[2];
    int width = rd16(hdr + 12), height = rd16(hdr + 14);
    uint8_t bpp = hdr[16], desc = hdr[17];
    bool rle = img_type == 10 || img_type == 11;
    bool gray = img_type == 3 || img_type == 11;
    bool truecolor = img_type == 2 || img_type == 10;
    if (cmap_type != 0 || (!gray && !truecolor) || width <= 0 || height <= 0 ||
        (gray && bpp != 8) || (truecolor && bpp != 24 && bpp != 32)) {
        error->clear();  // palette / exotic -> bridge fallback
        return nullptr;
    }
    if (id_len && std::fseek(f, id_len, SEEK_CUR) != 0) {
        *error = "tga: truncated id";
        return nullptr;
    }
    int c = bpp / 8;
    bool top_origin = (desc & 0x20) != 0;
    size_t n = size_t(width) * height;
    uint8_t* out = static_cast<uint8_t*>(std::malloc(n * c));
    if (!out) {
        *error = "tga: allocation failed";
        return nullptr;
    }
    auto put = [&](size_t i, uint8_t const* px) {
        uint8_t* d = out + i * c;
        if (c == 1) {
            d[0] = px[0];
        } else {  // TGA stores BGR(A)
            d[0] = px[2];
            d[1] = px[1];
            d[2] = px[0];
            if (c == 4) d[3] = px[3];
        }
    };
    uint8_t px[4];
    size_t i = 0;
    bool ok = true;
    if (!rle) {
        for (; i < n && ok; ++i) {
            ok = std::fread(px, 1, c, f) == size_t(c);
            if (ok) put(i, px);
        }
    } else {
        while (i < n && ok) {
            int ctrl = std::fgetc(f);
            if (ctrl == EOF) {
                ok = false;
                break;
            }
            int count = (ctrl & 0x7f) + 1;
            if (ctrl & 0x80) {  // run packet
                ok = std::fread(px, 1, c, f) == size_t(c);
                for (int k = 0; k < count && i < n && ok; ++k) put(i++, px);
            } else {  // raw packet
                for (int k = 0; k < count && i < n && ok; ++k) {
                    ok = std::fread(px, 1, c, f) == size_t(c);
                    if (ok) put(i++, px);
                }
            }
        }
    }
    if (!ok || i != n) {
        std::free(out);
        *error = "tga: truncated pixel data";
        return nullptr;
    }
    if (!top_origin) {  // bottom-up: flip rows in place
        size_t rowb = size_t(width) * c;
        std::vector<uint8_t> tmp(rowb);
        for (int y = 0; y < height / 2; ++y) {
            uint8_t* a = out + size_t(y) * rowb;
            uint8_t* b = out + size_t(height - 1 - y) * rowb;
            std::memcpy(tmp.data(), a, rowb);
            std::memcpy(a, b, rowb);
            std::memcpy(b, tmp.data(), rowb);
        }
    }
    *w = width;
    *h = height;
    *channels = c;
    return out;
}

// ---------------------------------------------------------------------------
// PNM (built-in: binary P5/P6 — the stb-supported subset; maxval <= 65535,
// 16-bit big-endian samples narrow to the high byte, no maxval rescale)
// ---------------------------------------------------------------------------

bool pnm_token(std::FILE* f, long* value) {
    // Skip whitespace and '#' comments, then parse one decimal token.
    int c = std::fgetc(f);
    while (c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '#') {
        if (c == '#')
            while (c != '\n' && c != EOF) c = std::fgetc(f);
        c = std::fgetc(f);
    }
    if (c < '0' || c > '9') return false;
    long v = 0;
    while (c >= '0' && c <= '9') {
        v = v * 10 + (c - '0');
        if (v > 1 << 24) return false;  // absurd dimension/maxval
        c = std::fgetc(f);
    }
    // The byte after the last token is the single whitespace separating the
    // header from the sample data — exactly consumed here.
    if (c != ' ' && c != '\t' && c != '\r' && c != '\n' && c != EOF)
        return false;
    *value = v;
    return true;
}

uint8_t* load_pnm(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    int p = std::fgetc(f), kind = std::fgetc(f);
    if (p != 'P' || (kind != '5' && kind != '6')) {
        error->clear();  // P1-P4/P7 etc. -> bridge fallback
        return nullptr;
    }
    long width = 0, height = 0, maxval = 0;
    if (!pnm_token(f, &width) || !pnm_token(f, &height) ||
        !pnm_token(f, &maxval) || width <= 0 || height <= 0 || maxval <= 0 ||
        maxval > 65535) {
        *error = "pnm: bad header";
        return nullptr;
    }
    int c = kind == '5' ? 1 : 3;
    int bytes = maxval > 255 ? 2 : 1;
    size_t n = size_t(width) * size_t(height) * c;
    std::vector<uint8_t> raw(n * bytes);
    if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
        *error = "pnm: truncated pixel data";
        return nullptr;
    }
    uint8_t* out = static_cast<uint8_t*>(std::malloc(n));
    if (!out) {
        *error = "pnm: allocation failed";
        return nullptr;
    }
    if (bytes == 1)
        std::memcpy(out, raw.data(), n);
    else  // big-endian 16-bit -> high byte (stb's 16->8 narrowing)
        for (size_t i = 0; i < n; ++i) out[i] = raw[i * 2];
    *w = int(width);
    *h = int(height);
    *channels = c;
    return out;
}

// ---------------------------------------------------------------------------
// HDR (built-in: Radiance RGBE, flat + old/new RLE scanlines; tone-mapped
// to 8-bit with stb's LDR defaults — gamma 2.2, scale 1)
// ---------------------------------------------------------------------------

uint8_t hdr_to_ldr(int mantissa, int exponent) {
    if (exponent == 0 || mantissa == 0) return 0;
    double v = double(mantissa) * std::ldexp(1.0, exponent - 136);
    double z = std::pow(v, 1.0 / 2.2) * 255.0 + 0.5;
    return uint8_t(z < 0 ? 0 : z > 255 ? 255 : z);
}

uint8_t* load_hdr(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    // Signature + header lines until the blank line; require the RGBE
    // format declaration (XYZE files are refused, as in stb).
    char line[256];
    if (!std::fgets(line, sizeof line, f) ||
        (std::strncmp(line, "#?RADIANCE", 10) != 0 &&
         std::strncmp(line, "#?RGBE", 6) != 0)) {
        *error = "hdr: bad signature";
        return nullptr;
    }
    bool fmt_ok = false;
    for (;;) {
        if (!std::fgets(line, sizeof line, f)) {
            *error = "hdr: truncated header";
            return nullptr;
        }
        if (line[0] == '\n' || (line[0] == '\r' && line[1] == '\n')) break;
        if (std::strncmp(line, "FORMAT=32-bit_rle_rgbe", 22) == 0)
            fmt_ok = true;
    }
    long width = 0, height = 0;
    if (!fmt_ok || !std::fgets(line, sizeof line, f) ||
        std::sscanf(line, "-Y %ld +X %ld", &height, &width) != 2 ||
        width <= 0 || height <= 0 || width > 1 << 24 || height > 1 << 24) {
        *error = "hdr: unsupported resolution line";  // only -Y +X, like stb
        return nullptr;
    }
    size_t n = size_t(width) * size_t(height);
    uint8_t* out = static_cast<uint8_t*>(std::malloc(n * 3));
    if (!out) {
        *error = "hdr: allocation failed";
        return nullptr;
    }
    std::vector<uint8_t> rgbe(size_t(width) * 4);
    auto fail = [&](char const* why) {
        *error = std::string("hdr: ") + why;
        std::free(out);
        return static_cast<uint8_t*>(nullptr);
    };
    for (long y = 0; y < height; ++y) {
        uint8_t hd[4];
        if (std::fread(hd, 1, 4, f) != 4) return fail("truncated scanline");
        if (width >= 8 && width < 32768 && hd[0] == 2 && hd[1] == 2 &&
            !(hd[2] & 0x80)) {
            if ((long(hd[2]) << 8 | hd[3]) != width)
                return fail("scanline length mismatch");
            for (int k = 0; k < 4; ++k) {  // new-style RLE, planar
                long x = 0;
                while (x < width) {
                    int cnt = std::fgetc(f);
                    if (cnt == EOF) return fail("truncated rle");
                    if (cnt > 128) {  // run
                        int v = std::fgetc(f);
                        if (v == EOF || x + (cnt - 128) > width)
                            return fail("bad rle run");
                        for (int i = 0; i < cnt - 128; ++i)
                            rgbe[size_t(x++) * 4 + k] = uint8_t(v);
                    } else {  // literals
                        if (cnt == 0 || x + cnt > width)
                            return fail("bad rle literals");
                        for (int i = 0; i < cnt; ++i) {
                            int v = std::fgetc(f);
                            if (v == EOF) return fail("truncated rle");
                            rgbe[size_t(x++) * 4 + k] = uint8_t(v);
                        }
                    }
                }
            }
        } else {  // flat RGBE, with old-style (1,1,1,count) run markers
            long x = 0;
            int shift = 0;
            std::memcpy(&rgbe[0], hd, 4);
            ++x;
            while (x < width) {
                uint8_t px[4];
                if (std::fread(px, 1, 4, f) != 4)
                    return fail("truncated scanline");
                if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
                    long run = long(px[3]) << shift;
                    if (x == 0 || x + run > width || shift > 24)
                        return fail("bad old-style run");
                    for (long i = 0; i < run; ++i, ++x)
                        std::memcpy(&rgbe[size_t(x) * 4],
                                    &rgbe[size_t(x - 1) * 4], 4);
                    shift += 8;
                } else {
                    std::memcpy(&rgbe[size_t(x++) * 4], px, 4);
                    shift = 0;
                }
            }
        }
        uint8_t* dst = out + size_t(y) * width * 3;
        for (long x = 0; x < width; ++x) {
            uint8_t const* s = &rgbe[size_t(x) * 4];
            dst[x * 3 + 0] = hdr_to_ldr(s[0], s[3]);
            dst[x * 3 + 1] = hdr_to_ldr(s[1], s[3]);
            dst[x * 3 + 2] = hdr_to_ldr(s[2], s[3]);
        }
    }
    *w = int(width);
    *h = int(height);
    *channels = 3;
    return out;
}

// ---------------------------------------------------------------------------
// GIF (built-in: first frame, like stbi_load — LZW, interlace, local/global
// palettes, transparency; always RGBA on the logical-screen canvas, frame
// drawn over transparent black)
// ---------------------------------------------------------------------------

bool gif_sub_blocks(std::FILE* f, std::vector<uint8_t>* out) {
    // Concatenate data sub-blocks up to the 0 terminator (out==nullptr: skip).
    for (;;) {
        int len = std::fgetc(f);
        if (len == EOF) return false;
        if (len == 0) return true;
        uint8_t buf[255];
        if (std::fread(buf, 1, size_t(len), f) != size_t(len)) return false;
        if (out) out->insert(out->end(), buf, buf + len);
    }
}

bool gif_lzw(std::vector<uint8_t> const& data, int min_code,
             std::vector<uint8_t>* indices, size_t n_pixels) {
    if (min_code < 2 || min_code > 11) return false;
    int const clear = 1 << min_code, end = clear + 1;
    int16_t prefix[4096];
    uint8_t suffix[4096], first[4096];
    for (int i = 0; i < clear; ++i) {
        prefix[i] = -1;
        suffix[i] = first[i] = uint8_t(i);
    }
    int cs = min_code + 1, next = end + 1, prev = -1;
    size_t bitpos = 0;
    uint8_t stack[4096];
    auto read_code = [&]() -> int {
        if ((bitpos + cs + 7) / 8 > data.size()) return -1;
        uint32_t v = 0;
        for (int i = 0; i < 3; ++i) {  // LSB-first, codes span <= 3 bytes
            size_t byte = bitpos / 8 + i;
            if (byte < data.size()) v |= uint32_t(data[byte]) << (8 * i);
        }
        v >>= bitpos % 8;
        bitpos += cs;
        return int(v & ((1u << cs) - 1));
    };
    indices->reserve(n_pixels);
    for (;;) {
        int code = read_code();
        if (code < 0) return false;
        if (code == clear) {
            cs = min_code + 1;
            next = end + 1;
            prev = -1;
            continue;
        }
        if (code == end) return indices->size() == n_pixels;
        if (prev < 0) {  // first code after (implicit) clear: a literal
            if (code >= clear) return false;
            indices->push_back(suffix[code]);
            prev = code;
            if (indices->size() == n_pixels) return true;
            continue;
        }
        if (code > next) return false;
        // code == next is the KwKwK case: the not-yet-added entry is
        // string(prev) + firstchar(string(prev)).
        int walk = code == next ? prev : code;
        int top = 0;
        while (walk >= 0) {
            if (top >= 4096) return false;
            stack[top++] = suffix[walk];
            walk = prefix[walk];
        }
        uint8_t const fc = stack[top - 1];  // first char of the string
        if (indices->size() + size_t(top) + (code == next ? 1 : 0) > n_pixels)
            return false;
        for (int i = top - 1; i >= 0; --i) indices->push_back(stack[i]);
        if (code == next) indices->push_back(fc);
        if (next < 4096) {
            prefix[next] = int16_t(prev);
            suffix[next] = fc;
            first[next] = first[prev];
            ++next;
            if (next == (1 << cs) && cs < 12) ++cs;
        }
        prev = code;
        // Some encoders omit the end code exactly at the boundary; accept.
        if (indices->size() == n_pixels) return true;
    }
}

uint8_t* load_gif(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    uint8_t hdr[13];
    if (std::fread(hdr, 1, 13, f) != 13 || std::memcmp(hdr, "GIF8", 4) != 0 ||
        (hdr[4] != '7' && hdr[4] != '9') || hdr[5] != 'a') {
        *error = "gif: bad header";
        return nullptr;
    }
    int cw = rd16(hdr + 6), ch = rd16(hdr + 8);
    if (cw <= 0 || ch <= 0) {
        *error = "gif: bad canvas size";
        return nullptr;
    }
    uint8_t gct[256 * 3];
    bool has_gct = (hdr[10] & 0x80) != 0;
    int gct_n = 2 << (hdr[10] & 7);
    if (has_gct && std::fread(gct, 1, size_t(gct_n) * 3, f) != size_t(gct_n) * 3) {
        *error = "gif: truncated palette";
        return nullptr;
    }
    int transparent = -1;
    for (;;) {
        int block = std::fgetc(f);
        if (block == 0x3B || block == EOF) {
            *error = "gif: no image data";
            return nullptr;
        }
        if (block == 0x21) {  // extension
            int label = std::fgetc(f);
            if (label == 0xF9) {  // graphic control
                int len = std::fgetc(f);
                uint8_t gce[4];
                if (len != 4 || std::fread(gce, 1, 4, f) != 4) {
                    *error = "gif: bad graphic control";
                    return nullptr;
                }
                transparent = (gce[0] & 1) ? gce[3] : -1;
                if (!gif_sub_blocks(f, nullptr)) {
                    *error = "gif: truncated extension";
                    return nullptr;
                }
            } else if (label == EOF || !gif_sub_blocks(f, nullptr)) {
                *error = "gif: truncated extension";
                return nullptr;
            }
            continue;
        }
        if (block != 0x2C) {
            *error = "gif: unknown block";
            return nullptr;
        }
        uint8_t id[9];
        if (std::fread(id, 1, 9, f) != 9) {
            *error = "gif: truncated image descriptor";
            return nullptr;
        }
        int left = rd16(id), top = rd16(id + 2);
        int fw = rd16(id + 4), fh = rd16(id + 6);
        bool has_lct = (id[8] & 0x80) != 0, interlaced = (id[8] & 0x40) != 0;
        int lct_n = 2 << (id[8] & 7);
        uint8_t lct[256 * 3];
        if (has_lct &&
            std::fread(lct, 1, size_t(lct_n) * 3, f) != size_t(lct_n) * 3) {
            *error = "gif: truncated palette";
            return nullptr;
        }
        uint8_t const* pal = has_lct ? lct : gct;
        int pal_n = has_lct ? lct_n : gct_n;
        if ((!has_lct && !has_gct) || fw <= 0 || fh <= 0 || left + fw > cw ||
            top + fh > ch) {
            *error = "gif: bad frame geometry";
            return nullptr;
        }
        int min_code = std::fgetc(f);
        std::vector<uint8_t> data;
        if (min_code == EOF || !gif_sub_blocks(f, &data)) {
            *error = "gif: truncated image data";
            return nullptr;
        }
        std::vector<uint8_t> idx;
        if (!gif_lzw(data, min_code, &idx, size_t(fw) * fh)) {
            *error = "gif: corrupt lzw stream";
            return nullptr;
        }
        uint8_t* out =
            static_cast<uint8_t*>(std::calloc(size_t(cw) * ch, 4));
        if (!out) {
            *error = "gif: allocation failed";
            return nullptr;
        }
        int const pass_start[4] = {0, 4, 2, 1}, pass_step[4] = {8, 8, 4, 2};
        size_t src = 0;
        for (int pass = 0; pass < (interlaced ? 4 : 1); ++pass) {
            int y0 = interlaced ? pass_start[pass] : 0;
            int dy = interlaced ? pass_step[pass] : 1;
            for (int y = y0; y < fh; y += dy) {
                for (int x = 0; x < fw; ++x, ++src) {
                    int v = idx[src];
                    if (v == transparent) continue;  // canvas stays clear
                    if (v >= pal_n) {
                        std::free(out);
                        *error = "gif: palette index out of range";
                        return nullptr;
                    }
                    uint8_t* d =
                        out + (size_t(top + y) * cw + left + x) * 4;
                    d[0] = pal[v * 3];
                    d[1] = pal[v * 3 + 1];
                    d[2] = pal[v * 3 + 2];
                    d[3] = 255;
                }
            }
        }
        *w = cw;
        *h = ch;
        *channels = 4;
        return out;  // first frame only, like stbi_load
    }
}

// ---------------------------------------------------------------------------
// PSD (built-in: composite image of RGB-mode files, 8/16-bit, raw + RLE —
// the stb-supported shape; always RGBA. Spec-faithful: no white-matte
// removal heuristic)
// ---------------------------------------------------------------------------

uint32_t rd32be(uint8_t const* p) {
    return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 |
           uint32_t(p[3]);
}

uint8_t* load_psd(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    uint8_t hdr[26];
    if (std::fread(hdr, 1, 26, f) != 26 || std::memcmp(hdr, "8BPS", 4) != 0 ||
        (uint16_t(hdr[4]) << 8 | hdr[5]) != 1) {
        *error = "psd: bad header";
        return nullptr;
    }
    int n_ch = int(hdr[12]) << 8 | hdr[13];
    long height = long(rd32be(hdr + 14)), width = long(rd32be(hdr + 18));
    int depth = int(hdr[22]) << 8 | hdr[23];
    int mode = int(hdr[24]) << 8 | hdr[25];
    if (n_ch < 3 || n_ch > 16 || width <= 0 || height <= 0 ||
        width > 1 << 24 || height > 1 << 24 || (depth != 8 && depth != 16) ||
        mode != 3 /* RGB */) {
        error->clear();  // gray/CMYK/PSB etc. -> bridge fallback
        return nullptr;
    }
    for (int i = 0; i < 3; ++i) {  // color-mode data, resources, layers
        uint8_t lb[4];
        if (std::fread(lb, 1, 4, f) != 4 ||
            std::fseek(f, long(rd32be(lb)), SEEK_CUR) != 0) {
            *error = "psd: truncated section";
            return nullptr;
        }
    }
    uint8_t cb[2];
    if (std::fread(cb, 1, 2, f) != 2) {
        *error = "psd: truncated image data";
        return nullptr;
    }
    int compression = cb[0] << 8 | cb[1];
    if (compression > 1 || (compression == 1 && depth != 8)) {
        *error = "psd: unsupported compression";
        return nullptr;
    }
    size_t n = size_t(width) * size_t(height);
    uint8_t* out = static_cast<uint8_t*>(std::malloc(n * 4));
    if (!out) {
        *error = "psd: allocation failed";
        return nullptr;
    }
    // Planar, channel-major: R plane, G, B, [A], extras ignored.
    auto fail = [&](char const* why) {
        *error = std::string("psd: ") + why;
        std::free(out);
        return static_cast<uint8_t*>(nullptr);
    };
    if (compression == 1) {
        if (std::fseek(f, long(size_t(height) * n_ch * 2), SEEK_CUR) != 0)
            return fail("truncated rle table");
        for (int c = 0; c < n_ch; ++c) {
            for (long y = 0; y < height; ++y) {
                long x = 0;
                while (x < width) {  // PackBits
                    int ctrl = std::fgetc(f);
                    if (ctrl == EOF) return fail("truncated rle");
                    if (ctrl > 128) {
                        int v = std::fgetc(f);
                        int run = 257 - ctrl;
                        if (v == EOF || x + run > width)
                            return fail("bad rle run");
                        for (int i = 0; i < run; ++i, ++x)
                            if (c < 4)
                                out[(size_t(y) * width + x) * 4 + c] =
                                    uint8_t(v);
                    } else if (ctrl < 128) {
                        for (int i = 0; i <= ctrl; ++i, ++x) {
                            int v = std::fgetc(f);
                            if (v == EOF || x >= width)
                                return fail("bad rle literals");
                            if (c < 4)
                                out[(size_t(y) * width + x) * 4 + c] =
                                    uint8_t(v);
                        }
                    }  // ctrl == 128: no-op
                }
            }
        }
    } else {
        int bytes = depth / 8;
        std::vector<uint8_t> plane(n * bytes);
        for (int c = 0; c < n_ch && c < 4; ++c) {
            if (std::fread(plane.data(), 1, plane.size(), f) != plane.size())
                return fail("truncated plane");
            for (size_t i = 0; i < n; ++i)
                out[i * 4 + c] = plane[i * bytes];  // BE high byte for 16-bit
        }
    }
    if (n_ch < 4)
        for (size_t i = 0; i < n; ++i) out[i * 4 + 3] = 255;
    *w = int(width);
    *h = int(height);
    *channels = 4;
    return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// Public entry points
// ---------------------------------------------------------------------------

bool available() {
#if defined(DLIMG_HAVE_LIBPNG) && defined(DLIMG_HAVE_LIBJPEG)
    return true;
#else
    return false;
#endif
}


// ---------------------------------------------------------------------------
// Softimage PIC (built-in)
// ---------------------------------------------------------------------------
//
// Closes the last container gap vs the reference's stb layer
// (the reference's src/image.cpp:11-23 accepts everything stbi_load does).
// Spec-faithful independent implementation: 104-byte header (BE32 magic
// 0x5380F634, f32 version, 80-byte comment, "PICT", BE16 width/height,
// f32 ratio, BE16 fields, BE16 pad), then chained 4-byte channel packets
// {chained, bits, type, channel-mask} and per-scanline packet data. Packet
// type 0 = uncompressed, 1 = pure RLE ({u8 count, pixel} pairs, a count
// clamping at the scanline end like stb; zero counts rejected — no
// progress), 2 = mixed RLE (count < 128: count+1 literal pixels;
// count == 128: BE16 run length then one pixel; count > 128:
// count-127 run). Channel masks: 0x80/0x40/0x20/0x10 = R/G/B/A. Output is
// RGBA composed across packets, reported as 4 channels when any packet
// carries alpha, else repacked to RGB (stb reports the same way).

uint8_t* load_pic(std::FILE* f, int* w, int* h, int* channels,
                  std::string* error) {
    uint8_t header[104];
    if (std::fread(header, 1, sizeof header, f) != sizeof header ||
        std::memcmp(header + 88, "PICT", 4) != 0) {
        *error = "pic: bad header";
        return nullptr;
    }
    int const width = (header[92] << 8) | header[93];
    int const height = (header[94] << 8) | header[95];
    // Cap total pixels too: a ~110-byte file claiming 32768x32768 would
    // otherwise force a 4 GiB allocation before any pixel data is read —
    // a DoS vector through serving endpoints that accept uploads.
    if (width <= 0 || height <= 0 || width > (1 << 15) ||
        height > (1 << 15) ||
        int64_t(width) * height > (int64_t(1) << 26)) {
        *error = "pic: bad dimensions";
        return nullptr;
    }
    struct Packet {
        uint8_t type = 0;
        uint8_t mask = 0;
    };
    std::vector<Packet> packets;
    bool alpha = false;
    for (;;) {
        if (packets.size() > 8) {  // 4 channels; a sane file needs <= 4
            *error = "pic: too many channel packets";
            return nullptr;
        }
        uint8_t pkt[4];
        if (std::fread(pkt, 1, 4, f) != 4) {
            *error = "pic: truncated channel packets";
            return nullptr;
        }
        if (pkt[1] != 8) {
            *error = "pic: only 8-bit channels supported";
            return nullptr;
        }
        if (pkt[2] != 0 && pkt[2] != 1 && pkt[2] != 2) {
            *error = "pic: unsupported packet compression";
            return nullptr;
        }
        packets.push_back(Packet{pkt[2], pkt[3]});
        alpha = alpha || (pkt[3] & 0x10) != 0;
        if (!pkt[0]) break;
    }
    std::vector<uint8_t> rgba(size_t(width) * height * 4, 0);
    for (size_t i = 3; i < rgba.size(); i += 4) rgba[i] = 0xff;
    std::vector<uint8_t> buf(size_t(width) * 4);  // reused per row/chunk
    for (int y = 0; y < height; ++y) {
        uint8_t* row = rgba.data() + size_t(y) * width * 4;
        for (Packet const& p : packets) {
            int idx[4];
            int nc = 0;
            for (int bit = 0x80, c = 0; bit >= 0x10; bit >>= 1, ++c)
                if (p.mask & bit) idx[nc++] = c;
            if (nc == 0) continue;
            auto write_px = [&](int x, uint8_t const* px) {
                for (int c = 0; c < nc; ++c)
                    row[size_t(x) * 4 + idx[c]] = px[c];
            };
            if (p.type == 0) {  // uncompressed
                size_t need = size_t(width) * nc;
                if (std::fread(buf.data(), 1, need, f) != need) {
                    *error = "pic: truncated pixel data";
                    return nullptr;
                }
                for (int x = 0; x < width; ++x)
                    write_px(x, buf.data() + size_t(x) * nc);
            } else if (p.type == 1) {  // pure RLE: {count, pixel} pairs
                int x = 0;
                while (x < width) {
                    int c = std::fgetc(f);
                    if (c == EOF) {
                        *error = "pic: truncated pixel data";
                        return nullptr;
                    }
                    if (c == 0) {  // no progress: corrupt
                        *error = "pic: zero-length rle run";
                        return nullptr;
                    }
                    uint8_t px[4];
                    if (std::fread(px, 1, size_t(nc), f) != size_t(nc)) {
                        *error = "pic: truncated pixel data";
                        return nullptr;
                    }
                    int run = c > width - x ? width - x : c;  // stb clamps
                    for (int i = 0; i < run; ++i) write_px(x++, px);
                }
            } else {  // mixed RLE
                int x = 0;
                while (x < width) {
                    int c = std::fgetc(f);
                    if (c == EOF) {
                        *error = "pic: truncated pixel data";
                        return nullptr;
                    }
                    if (c >= 128) {  // run of one repeated pixel
                        int run;
                        if (c == 128) {
                            int hi = std::fgetc(f), lo = std::fgetc(f);
                            if (lo == EOF) {
                                *error = "pic: truncated pixel data";
                                return nullptr;
                            }
                            run = (hi << 8) | lo;
                        } else {
                            run = c - 127;
                        }
                        uint8_t px[4];
                        if (std::fread(px, 1, size_t(nc), f) != size_t(nc)) {
                            *error = "pic: truncated pixel data";
                            return nullptr;
                        }
                        if (run < 0 || x + run > width) {
                            *error = "pic: rle run past end of scanline";
                            return nullptr;
                        }
                        for (int i = 0; i < run; ++i) write_px(x++, px);
                    } else {  // c + 1 literal pixels
                        int cnt = c + 1;
                        if (x + cnt > width) {
                            *error = "pic: rle literals past scanline end";
                            return nullptr;
                        }
                        size_t need = size_t(cnt) * nc;
                        if (std::fread(buf.data(), 1, need, f) != need) {
                            *error = "pic: truncated pixel data";
                            return nullptr;
                        }
                        for (int i = 0; i < cnt; ++i)
                            write_px(x++, buf.data() + size_t(i) * nc);
                    }
                }
            }
        }
    }
    int const out_c = alpha ? 4 : 3;
    uint8_t* out = static_cast<uint8_t*>(
        std::malloc(size_t(width) * height * out_c));
    if (!out) {
        *error = "pic: allocation failed";
        return nullptr;
    }
    if (alpha) {
        std::memcpy(out, rgba.data(), rgba.size());
    } else {
        for (size_t i = 0, n = size_t(width) * height; i < n; ++i) {
            out[i * 3 + 0] = rgba[i * 4 + 0];
            out[i * 3 + 1] = rgba[i * 4 + 1];
            out[i * 3 + 2] = rgba[i * 4 + 2];
        }
    }
    *w = width;
    *h = height;
    *channels = out_c;
    return out;
}

uint8_t* load_image(char const* path, int* w, int* h, int* channels,
                    std::string* error) {
    error->clear();
    File file(path, "rb");
    if (!file.f) {
        *error = std::string("cannot open ") + path;
        return nullptr;
    }
    uint8_t magic[4] = {0, 0, 0, 0};
    size_t got = std::fread(magic, 1, 4, file.f);
    std::rewind(file.f);
    if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P' && magic[2] == 'N' &&
        magic[3] == 'G') {
#ifdef DLIMG_HAVE_LIBPNG
        uint8_t* out = load_png(file.f, w, h, channels, error);
#else
        uint8_t* out = nullptr;
        error->clear();
#endif
        if (out && *channels != 1 && *channels != 3 && *channels != 4) {
            *error = "unsupported number of channels";
            std::free(out);
            return nullptr;
        }
        return out;
    }
    if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
#ifdef DLIMG_HAVE_LIBJPEG
        return load_jpeg(file.f, w, h, channels, error);
#else
        error->clear();
        return nullptr;
#endif
    }
    if (got >= 2 && magic[0] == 'B' && magic[1] == 'M')
        return load_bmp(file.f, w, h, channels, error);
    if (got >= 4 && std::memcmp(magic, "GIF8", 4) == 0)
        return load_gif(file.f, w, h, channels, error);
    if (got >= 4 && std::memcmp(magic, "8BPS", 4) == 0)
        return load_psd(file.f, w, h, channels, error);
    if (got >= 3 && magic[0] == 'P' && (magic[1] == '5' || magic[1] == '6') &&
        (magic[2] == ' ' || magic[2] == '\t' || magic[2] == '\r' ||
         magic[2] == '\n' || magic[2] == '#'))
        return load_pnm(file.f, w, h, channels, error);
    if (got >= 2 && magic[0] == '#' && magic[1] == '?')
        return load_hdr(file.f, w, h, channels, error);
    if (got >= 4 && magic[0] == 0x53 && magic[1] == 0x80 &&
        magic[2] == 0xF6 && magic[3] == 0x34)
        return load_pic(file.f, w, h, channels, error);
    // TGA has no magic; go by extension.
    size_t len = std::strlen(path);
    if (len > 4 && (std::strcmp(path + len - 4, ".tga") == 0 ||
                    std::strcmp(path + len - 4, ".TGA") == 0))
        return load_tga(file.f, w, h, channels, error);
    error->clear();  // unknown container -> bridge fallback
    return nullptr;
}

bool save_png(char const* path, uint8_t const* pixels, int w, int h,
              int channels, int stride, std::string* error) {
#ifndef DLIMG_HAVE_LIBPNG
    (void)path;
    (void)pixels;
    (void)w;
    (void)h;
    (void)channels;
    (void)stride;
    error->clear();  // no native encoder -> bridge fallback
    return false;
#else
    error->clear();
    if (channels != 1 && channels != 3 && channels != 4) {
        *error = "save_png: unsupported channel count";
        return false;
    }
    if (stride <= 0) stride = w * channels;
    File file(path, "wb");
    if (!file.f) {
        *error = std::string("cannot open ") + path;
        return false;
    }
    png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                              nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (!png || !info) {
        *error = "libpng: allocation failed";
        png_destroy_write_struct(&png, &info);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        *error = "libpng: encode failed";
        png_destroy_write_struct(&png, &info);
        return false;
    }
    png_init_io(png, file.f);
    int color = channels == 1   ? PNG_COLOR_TYPE_GRAY
                : channels == 3 ? PNG_COLOR_TYPE_RGB
                                : PNG_COLOR_TYPE_RGBA;
    png_set_IHDR(png, info, w, h, 8, color, PNG_INTERLACE_NONE,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    png_write_info(png, info);
    std::vector<png_bytep> rows(h);
    for (int y = 0; y < h; ++y)
        rows[y] = const_cast<png_bytep>(pixels + size_t(y) * stride);
    png_write_image(png, rows.data());
    png_write_end(png, nullptr);
    png_destroy_write_struct(&png, &info);
    return true;
#endif
}

}  // namespace dlimg_native
