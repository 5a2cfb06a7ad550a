// The port's PNG codec: a reader and a writer of PNG files (the PNG
// specification, ISO/IEC 15948) with their zlib streams (RFC 1950) and
// deflate data (RFC 1951), on the C++ standard library alone: no libpng,
// no zlib. It is the C library's only PNG path, on every machine, so the
// Python-free daemon takes and returns PNGs where neither library is
// installed.
//
// decode() reads every colour type at every legal bit depth, tRNS, Adam7
// interlacing and the five filters, and yields what the libpng path of
// the JAX package's native/src/codecs.cpp yields (its load_png
// transformations): 16-bit samples keep their high byte, gray below 8 bits
// is scaled to 8 bits, palette becomes RGB (RGBA with tRNS), gray with
// tRNS and gray+alpha become RGBA; the channel count is 1, 3 or 4. Its
// input may come from a network upload: a wrong CRC-32, Adler-32, chunk
// length, filter type or bit depth, a truncated stream, or a stream that
// inflates to more or fewer bytes than the image needs is an error with a
// non-empty message, and the image's size is checked before any
// allocation.
//
// encode() writes 8-bit gray, RGB or RGBA with a filter per row (the least
// sum of absolute values), LZ77 over hash chains, and per block the
// smaller of fixed- and dynamic-Huffman codes.

#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace dlimg_png {

// The largest image decode() returns, in bytes (width * height * channels).
constexpr uint64_t kMaxDecodedBytes = uint64_t(1) << 30;

// Decode the PNG file held in data[0, size): a malloc()ed packed row-major
// uint8 buffer with *w, *h and *channels (1, 3 or 4) set, or nullptr with
// a non-empty *error.
uint8_t* decode(uint8_t const* data, size_t size, int* w, int* h,
                int* channels, std::string* error);

// Encode w x h 8-bit pixels of `channels` (1, 3 or 4) channels whose rows
// start `stride` bytes apart (0: w * channels) as a PNG file into *out.
// Returns false with a non-empty *error for arguments it cannot encode.
bool encode(uint8_t const* pixels, int w, int h, int channels, int stride,
            std::vector<uint8_t>* out, std::string* error);

}  // namespace dlimg_png
