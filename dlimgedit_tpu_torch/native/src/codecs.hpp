// Native image codecs for the C ABI of the PyTorch port (adapted from the
// JAX package's native/src/codecs.hpp).
//
// The reference's codec layer is native C (stb, its src/image.cpp:11-35:
// load PNG/JPEG/BMP/TGA, save PNG). This layer reads and writes PNG with
// the port's own codec (png.hpp, no libpng) on every machine, reads JPEG
// with the system libjpeg where the build finds it, and has small
// built-in readers for the uncompressed containers — no Python on the
// codec path. The embedded-Python bridge remains a fallback in capi.cpp
// for containers these decoders do not read.

#pragma once

#include <cstdint>
#include <string>

namespace dlimg_native {

// Decode `path` into a malloc()d packed row-major uint8 buffer.
// On success: returns buffer, sets w/h/channels (channels in {1,3,4}).
// On failure: returns nullptr and sets `error` (empty error string means
// "format not handled natively" — caller may fall back to the bridge).
uint8_t* load_image(char const* path, int* w, int* h, int* channels,
                    std::string* error);

// Encode packed row-major uint8 pixels (channels in {1,3,4}, stride in
// BYTES; 0 means tight) as PNG. Returns true on success, else sets `error`.
bool save_png(char const* path, uint8_t const* pixels, int w, int h,
              int channels, int stride, std::string* error);

}  // namespace dlimg_native
