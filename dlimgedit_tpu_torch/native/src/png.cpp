// The port's PNG codec (png.hpp): written from the PNG specification and
// RFC 1950 / 1951, with no dependency beyond the C++ standard library.

#include "png.hpp"

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <queue>
#include <utility>

namespace dlimg_png {
namespace {

// Errors inside the codec are thrown as Error and caught at the entry
// points, which turn them into the caller's message.
struct Error {
    std::string what;
};

[[noreturn]] void fail(std::string const& msg) { throw Error{"png: " + msg}; }

uint8_t const kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(uint8_t const* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put32(std::vector<uint8_t>* out, uint32_t v) {
    for (int s = 24; s >= 0; s -= 8) out->push_back(uint8_t(v >> s));
}

uint32_t le32(uint8_t const* p) {
    return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
           (uint32_t(p[3]) << 24);
}

uint64_t le64(uint8_t const* p) {
    return uint64_t(le32(p)) | (uint64_t(le32(p + 4)) << 32);
}

// CRC-32 of ISO 3309 as the PNG specification uses it, eight bytes a step
// (t[k][b]: the CRC of byte b followed by k zero bytes); crc32(b,
// crc32(a)) is the CRC of a followed by b.
uint32_t crc32(uint8_t const* p, size_t n, uint32_t crc = 0) {
    struct Tables {
        uint32_t t[8][256];
        Tables() {
            for (uint32_t i = 0; i < 256; ++i) {
                uint32_t c = i;
                for (int k = 0; k < 8; ++k)
                    c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
                t[0][i] = c;
            }
            for (int k = 1; k < 8; ++k)
                for (int i = 0; i < 256; ++i)
                    t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xff];
        }
    };
    static Tables const tb;
    auto const& t = tb.t;
    crc = ~crc;
    for (; n >= 8; n -= 8, p += 8) {
        uint32_t const a = crc ^ le32(p), b = le32(p + 4);
        crc = t[7][a & 0xff] ^ t[6][(a >> 8) & 0xff] ^ t[5][(a >> 16) & 0xff] ^
              t[4][a >> 24] ^ t[3][b & 0xff] ^ t[2][(b >> 8) & 0xff] ^
              t[1][(b >> 16) & 0xff] ^ t[0][b >> 24];
    }
    while (n--) crc = t[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
    return ~crc;
}

uint32_t adler32(uint8_t const* p, size_t n) {
    uint32_t a = 1, b = 0;
    while (n) {
        size_t k = std::min<size_t>(n, 5552);  // b stays below 2^32
        n -= k;
        while (k--) {
            a += *p++;
            b += a;
        }
        a %= 65521;
        b %= 65521;
    }
    return (b << 16) | a;
}

// Deflate's length and distance codes (RFC 1951 3.2.5).
uint16_t const kLenBase[29] = {3,  4,  5,  6,   7,   8,   9,   10,  11, 13,
                               15, 17, 19, 23,  27,  31,  35,  43,  51, 59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
uint8_t const kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
uint16_t const kDistBase[30] = {
    1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,
    97,  129, 193, 257, 385, 513,  769,  1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577};
uint8_t const kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,
                                5, 5, 6, 6, 7, 7, 8, 8,  9,  9,  10, 10,
                                11, 11, 12, 12, 13, 13};
// The order in which a dynamic block stores the code-length code's lengths.
uint8_t const kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                              11, 4,  12, 3, 13, 2, 14, 1, 15};

// The fixed Huffman code's lengths (RFC 1951 3.2.6): literal/length codes
// 0-287, then 32 distance codes (30 and 31 never occur in valid data).
void fixed_lengths(uint8_t* lit, uint8_t* dist) {
    for (int i = 0; i < 288; ++i)
        lit[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    for (int i = 0; i < 32; ++i) dist[i] = 5;
}

uint32_t reverse_bits(uint32_t code, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; ++i, code >>= 1) r = (r << 1) | (code & 1);
    return r;
}

// ---------------------------------------------------------------------------
// Inflate (RFC 1950 / 1951)
// ---------------------------------------------------------------------------

constexpr int kFastBits = 10;

// A canonical Huffman code for decoding: codes up to kFastBits long are
// looked up in `fast` by the next bits of the stream ((length << 9) |
// symbol; 0 where a longer code starts); longer ones are walked through
// the counts per length, as RFC 1951's canonical construction orders them.
struct Decoder {
    uint16_t fast[1 << kFastBits];
    uint16_t count[16];
    uint16_t symbol[320];
};

// Build `d` from n code lengths; false for an over-subscribed set, or an
// incomplete one other than a single one-bit code (which zlib accepts for
// literal/length and distance codes; `single_ok` false refuses it too).
bool build(Decoder* d, uint8_t const* lengths, int n, bool single_ok) {
    std::memset(d->count, 0, sizeof d->count);
    std::memset(d->fast, 0, sizeof d->fast);
    for (int i = 0; i < n; ++i) d->count[lengths[i]]++;
    d->count[0] = 0;
    int left = 1, codes = 0;
    for (int len = 1; len <= 15; ++len) {
        left = (left << 1) - d->count[len];
        if (left < 0) return false;
        codes += d->count[len];
    }
    if (left > 0 && codes > 0 &&
        !(single_ok && codes == 1 && d->count[1] == 1))
        return false;
    uint16_t offs[16];
    uint32_t next[16];
    offs[1] = 0;
    next[1] = 0;
    for (int len = 1; len < 15; ++len) {
        offs[len + 1] = uint16_t(offs[len] + d->count[len]);
        next[len + 1] = (next[len] + d->count[len]) << 1;
    }
    for (int sym = 0; sym < n; ++sym) {
        int len = lengths[sym];
        if (!len) continue;
        d->symbol[offs[len]++] = uint16_t(sym);
        uint32_t code = next[len]++;
        if (len <= kFastBits)
            for (uint32_t k = reverse_bits(code, len); k < (1u << kFastBits);
                 k += 1u << len)
                d->fast[k] = uint16_t((len << 9) | sym);
    }
    return true;
}

// The stream's bits, least significant first: `cnt` valid bits in `buf`
// (above them, bits of the bytes at p, or zeros). Past the end it reads
// zeros and counts them: consuming one of them is a truncated stream.
struct BitReader {
    uint8_t const* p;
    uint8_t const* end;
    uint64_t buf = 0;
    int cnt = 0;
    size_t pad = 0;

    BitReader(uint8_t const* begin, uint8_t const* stop) : p(begin), end(stop) {}

    void refill() {
        if (end - p >= 8) {  // whole bytes up to 56..63 bits
            buf |= le64(p) << cnt;
            p += (63 - cnt) >> 3;
            cnt |= 56;
            return;
        }
        while (cnt <= 56) {
            uint64_t b = 0;
            if (p < end)
                b = *p++;
            else
                ++pad;
            buf |= b << cnt;
            cnt += 8;
        }
    }
    void check() const {
        if (pad * 8 > size_t(cnt)) fail("truncated zlib stream");
    }
    void drop(int n) {
        buf >>= n;
        cnt -= n;
    }
    uint32_t get(int n) {  // n <= 32
        if (cnt < n) refill();
        uint32_t v = uint32_t(buf & ((uint64_t(1) << n) - 1));
        drop(n);
        if (pad) check();
        return v;
    }
    void align() { drop(cnt & 7); }
    // Byte-aligned: give the whole bytes held back to the stream.
    void rewind() {
        p -= size_t(cnt >> 3) - pad;
        buf = 0;
        cnt = 0;
        pad = 0;
    }
};

int decode_symbol(BitReader* br, Decoder const& d) {
    if (br->cnt < 15) br->refill();
    uint32_t e = d.fast[br->buf & ((1u << kFastBits) - 1)];
    if (e) {
        br->drop(int(e >> 9));
        if (br->pad) br->check();
        return int(e & 511);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
        code |= int((br->buf >> (len - 1)) & 1);
        int count = d.count[len];
        if (code - count < first) {
            br->drop(len);
            if (br->pad) br->check();
            return d.symbol[index + (code - first)];
        }
        index += count;
        first = (first + count) << 1;
        code <<= 1;
    }
    if (br->pad * 8 + 15 > size_t(br->cnt))  // the walk read past the data
        fail("truncated zlib stream");
    fail("invalid Huffman code in the zlib stream");
}

// Inflate the zlib stream data[0, n) into exactly `need` bytes at out.
void inflate(uint8_t const* data, size_t n, uint8_t* out, size_t need) {
    if (n < 2) fail("truncated zlib stream");
    unsigned const cmf = data[0], flg = data[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0)
        fail("bad zlib header");
    if (flg & 0x20) fail("zlib preset dictionary in a PNG stream");
    BitReader br(data + 2, data + n);
    Decoder lit, dist;
    size_t pos = 0;
    auto too_much = [&] {
        fail("the image data inflates to more than the " +
             std::to_string(need) + " bytes the image needs");
    };
    for (bool last = false; !last;) {
        last = br.get(1) != 0;
        int const type = int(br.get(2));
        if (type == 0) {  // stored
            br.align();
            br.rewind();
            if (br.end - br.p < 4) fail("truncated zlib stream");
            uint32_t const len = uint32_t(br.p[0]) | (uint32_t(br.p[1]) << 8);
            uint32_t const nlen = uint32_t(br.p[2]) | (uint32_t(br.p[3]) << 8);
            br.p += 4;
            if (len != (~nlen & 0xffff))
                fail("stored block length check failed");
            if (need - pos < len) too_much();
            if (size_t(br.end - br.p) < len) fail("truncated zlib stream");
            std::memcpy(out + pos, br.p, len);
            br.p += len;
            pos += len;
            continue;
        }
        if (type == 1) {
            uint8_t ll[288], dl[32];
            fixed_lengths(ll, dl);
            build(&lit, ll, 288, true);
            build(&dist, dl, 32, true);
        } else if (type == 2) {
            int const nlit = int(br.get(5)) + 257;
            int const ndist = int(br.get(5)) + 1;
            int const ncode = int(br.get(4)) + 4;
            if (nlit > 286 || ndist > 30)
                fail("bad code counts in a dynamic block");
            uint8_t lengths[320] = {0};
            for (int i = 0; i < ncode; ++i)
                lengths[kClOrder[i]] = uint8_t(br.get(3));
            Decoder cl;
            if (!build(&cl, lengths, 19, false))
                fail("bad code-length code in a dynamic block");
            std::memset(lengths, 0, sizeof lengths);
            for (int i = 0; i < nlit + ndist;) {
                int sym = decode_symbol(&br, cl);
                if (sym < 16) {
                    lengths[i++] = uint8_t(sym);
                    continue;
                }
                uint8_t val = 0;
                int rep;
                if (sym == 16) {
                    if (i == 0) fail("length repeat with no length before it");
                    val = lengths[i - 1];
                    rep = 3 + int(br.get(2));
                } else if (sym == 17) {
                    rep = 3 + int(br.get(3));
                } else {
                    rep = 11 + int(br.get(7));
                }
                if (i + rep > nlit + ndist)
                    fail("code lengths overrun a dynamic block's counts");
                while (rep--) lengths[i++] = val;
            }
            if (lengths[256] == 0)
                fail("a dynamic block without an end-of-block code");
            if (!build(&lit, lengths, nlit, true) ||
                !build(&dist, lengths + nlit, ndist, true))
                fail("bad Huffman code in a dynamic block");
        } else {
            fail("bad deflate block type 3");
        }
        for (;;) {
            int sym = decode_symbol(&br, lit);
            if (sym < 256) {
                if (pos == need) too_much();
                out[pos++] = uint8_t(sym);
                continue;
            }
            if (sym == 256) break;
            sym -= 257;
            if (sym >= 29) fail("invalid length code in the zlib stream");
            size_t const len = kLenBase[sym] + br.get(kLenExtra[sym]);
            int const ds = decode_symbol(&br, dist);
            if (ds >= 30) fail("invalid distance code in the zlib stream");
            size_t const d = kDistBase[ds] + br.get(kDistExtra[ds]);
            if (d > pos) fail("a distance too far back in the zlib stream");
            if (need - pos < len) too_much();
            uint8_t* o = out + pos;
            uint8_t const* s = o - d;
            for (size_t i = 0; i < len; ++i) o[i] = s[i];
            pos += len;
        }
    }
    br.align();
    uint32_t adler = 0;
    for (int i = 0; i < 4; ++i) adler = (adler << 8) | br.get(8);
    if (pos != need)
        fail("the image data inflates to " + std::to_string(pos) +
             " bytes, the image needs " + std::to_string(need));
    if (adler != adler32(out, pos)) fail("Adler-32 mismatch");
}

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

struct Pass {
    uint32_t x0, y0, dx, dy;
};
Pass const kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                        {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                        {0, 1, 1, 2}};
Pass const kWhole = {0, 0, 1, 1};

uint32_t pass_extent(uint32_t size, uint32_t start, uint32_t step) {
    return size > start ? (size - start + step - 1) / step : 0;
}

int paeth(int a, int b, int c) {
    int const p = a + b - c;
    int const pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    return pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
}

// Undo the filters of `rows` rows of `rowbytes` bytes, each after its
// filter-type byte, in place; `bpp` is the filter's byte distance.
void unfilter(uint8_t* data, uint32_t rows, size_t rowbytes, size_t bpp) {
    uint8_t const* prev = nullptr;
    for (uint32_t y = 0; y < rows; ++y) {
        uint8_t* row = data + y * (rowbytes + 1);
        int const type = row[0];
        uint8_t* r = row + 1;
        switch (type) {
            case 0:
                break;
            case 1:
                for (size_t i = bpp; i < rowbytes; ++i) r[i] += r[i - bpp];
                break;
            case 2:
                if (prev)
                    for (size_t i = 0; i < rowbytes; ++i) r[i] += prev[i];
                break;
            case 3:
                if (!prev) {
                    for (size_t i = bpp; i < rowbytes; ++i)
                        r[i] += r[i - bpp] >> 1;
                    break;
                }
                for (size_t i = 0; i < bpp && i < rowbytes; ++i)
                    r[i] += prev[i] >> 1;
                for (size_t i = bpp; i < rowbytes; ++i)
                    r[i] += uint8_t((r[i - bpp] + prev[i]) >> 1);
                break;
            case 4:  // with no row above, Paeth predicts the left byte
                if (!prev) {
                    for (size_t i = bpp; i < rowbytes; ++i) r[i] += r[i - bpp];
                    break;
                }
                for (size_t i = 0; i < bpp && i < rowbytes; ++i)
                    r[i] += prev[i];
                for (size_t i = bpp; i < rowbytes; ++i)
                    r[i] += uint8_t(paeth(r[i - bpp], prev[i], prev[i - bpp]));
                break;
            default:
                fail("bad filter type " + std::to_string(type) + " in row " +
                     std::to_string(y));
        }
        prev = r;
    }
}

uint8_t* decode_png(uint8_t const* data, size_t size, int* w_out, int* h_out,
                    int* channels_out) {
    if (size < 8 || std::memcmp(data, kSignature, 8) != 0)
        fail("not a PNG signature");
    size_t pos = 8;
    uint32_t w = 0, h = 0;
    int depth = 0, color = 0, interlace = 0;
    bool have_ihdr = false, have_plte = false, in_idat = false,
         idat_done = false;
    std::vector<uint8_t> idat;
    uint8_t palette[256 * 3] = {0};  // indices past the palette read black
    int palette_n = 0;
    uint8_t trns_alpha[256];
    int trns_n = -1;  // palette alphas given (-1: no tRNS)
    uint32_t key[3] = {0, 0, 0};
    bool have_key = false;
    for (;;) {
        if (size - pos < 12)
            fail("truncated file: a chunk or IEND is missing");
        uint32_t const len = be32(data + pos);
        if (len > 0x7fffffffu) fail("chunk length over 2^31 - 1");
        if (size - pos - 12 < len) fail("truncated chunk");
        uint8_t const* type = data + pos + 4;
        uint8_t const* body = type + 4;
        std::string const name(reinterpret_cast<char const*>(type), 4);
        for (int i = 0; i < 4; ++i)
            if (!((type[i] >= 'A' && type[i] <= 'Z') ||
                  (type[i] >= 'a' && type[i] <= 'z')))
                fail("bad chunk type");
        if (be32(body + len) != crc32(type, size_t(len) + 4))
            fail("CRC-32 mismatch in the " + name + " chunk");
        pos += 12 + size_t(len);
        if (!have_ihdr) {
            if (name != "IHDR") fail("the first chunk is not IHDR");
            if (len != 13) fail("IHDR length " + std::to_string(len));
            w = be32(body);
            h = be32(body + 4);
            depth = body[8];
            color = body[9];
            interlace = body[12];
            if (w == 0 || h == 0 || w > 0x7fffffffu || h > 0x7fffffffu)
                fail("bad image size " + std::to_string(w) + "x" +
                     std::to_string(h));
            bool ok;
            switch (color) {
                case 0:
                    ok = depth == 1 || depth == 2 || depth == 4 ||
                         depth == 8 || depth == 16;
                    break;
                case 3:
                    ok = depth == 1 || depth == 2 || depth == 4 || depth == 8;
                    break;
                case 2:
                case 4:
                case 6:
                    ok = depth == 8 || depth == 16;
                    break;
                default:
                    fail("bad colour type " + std::to_string(color));
            }
            if (!ok)
                fail("bad bit depth " + std::to_string(depth) +
                     " for colour type " + std::to_string(color));
            if (body[10] != 0) fail("unknown compression method");
            if (body[11] != 0) fail("unknown filter method");
            if (interlace > 1) fail("unknown interlace method");
            have_ihdr = true;
            continue;
        }
        if (name == "IDAT") {
            if (idat_done) fail("IDAT chunks that are not consecutive");
            if (color == 3 && !have_plte) fail("a palette image without PLTE");
            in_idat = true;
            idat.insert(idat.end(), body, body + len);
            continue;
        }
        if (in_idat) idat_done = true;
        if (name == "IEND") break;
        if (name == "IHDR") fail("a second IHDR");
        if (name == "PLTE") {
            if (in_idat) fail("PLTE after IDAT");
            if (have_plte) fail("a second PLTE");
            if (len == 0 || len % 3 != 0 || len > 256 * 3)
                fail("PLTE length " + std::to_string(len));
            palette_n = int(len / 3);
            if (color == 3) palette_n = std::min(palette_n, 1 << depth);
            std::memcpy(palette, body, size_t(palette_n) * 3);
            have_plte = true;
            continue;
        }
        if (name == "tRNS") {
            if (in_idat) fail("tRNS after IDAT");
            // As libpng on reading, a tRNS of the wrong length, or on a
            // type with an alpha channel, is ignored.
            if (color == 3 && have_plte && len >= 1 &&
                len <= uint32_t(palette_n)) {
                std::memcpy(trns_alpha, body, len);
                trns_n = int(len);
            } else if (color == 0 && len == 2) {
                key[0] = (uint32_t(body[0]) << 8) | body[1];
                have_key = true;
            } else if (color == 2 && len == 6) {
                for (int i = 0; i < 3; ++i)
                    key[i] = (uint32_t(body[2 * i]) << 8) | body[2 * i + 1];
                have_key = true;
            }
            continue;
        }
        if (!(type[0] & 0x20)) fail("unknown critical chunk " + name);
    }
    if (!in_idat) fail("no IDAT chunk");

    int const nc = color == 0 ? 1 : color == 2 ? 3 : color == 3 ? 1
                   : color == 4 ? 2 : 4;
    bool const alpha = color == 4 || color == 6 || have_key || trns_n >= 0;
    int const oc = alpha ? 4 : (color == 2 || color == 3) ? 3 : 1;
    uint64_t const out_bytes = uint64_t(w) * h * oc;
    if (out_bytes > kMaxDecodedBytes)
        fail("a " + std::to_string(w) + "x" + std::to_string(h) +
             " image is over the decoder's " +
             std::to_string(kMaxDecodedBytes >> 20) + " MiB");
    Pass const* passes = interlace ? kAdam7 : &kWhole;
    int const n_passes = interlace ? 7 : 1;
    uint64_t raw = 0;
    for (int p = 0; p < n_passes; ++p) {
        uint64_t const pw = pass_extent(w, passes[p].x0, passes[p].dx);
        uint64_t const ph = pass_extent(h, passes[p].y0, passes[p].dy);
        if (pw && ph) raw += ph * (1 + (pw * nc * depth + 7) / 8);
    }
    // Deflate codes at most 258 bytes in two bits: a shorter stream cannot
    // hold the image (refused before anything is allocated for it).
    if (raw > uint64_t(idat.size()) * 1032 + 1024)
        fail("the " + std::to_string(idat.size()) + " bytes of image data "
             "cannot inflate to the " + std::to_string(raw) + " bytes a " +
             std::to_string(w) + "x" + std::to_string(h) + " image needs");
    std::vector<uint8_t> buf(raw);
    inflate(idat.data(), idat.size(), buf.data(), raw);
    idat.clear();
    idat.shrink_to_fit();

    uint8_t* out = static_cast<uint8_t*>(std::malloc(out_bytes));
    if (!out) fail("allocation failed");
    uint32_t const mask = depth == 16 ? 0xffffu : (1u << depth) - 1;
    uint32_t const scale = depth == 1 ? 255 : depth == 2 ? 85
                           : depth == 4 ? 17 : 1;
    for (int i = 0; i < 3; ++i) key[i] &= mask;
    size_t const bpp = std::max<size_t>(1, size_t(nc) * depth / 8);
    size_t at = 0;  // the pass's first row in buf
    for (int p = 0; p < n_passes; ++p) {
        Pass const& ps = passes[p];
        uint32_t const pw = pass_extent(w, ps.x0, ps.dx);
        uint32_t const ph = pass_extent(h, ps.y0, ps.dy);
        if (!pw || !ph) continue;
        size_t const rowbytes = (uint64_t(pw) * nc * depth + 7) / 8;
        uint8_t* rows = buf.data() + at;
        at += size_t(ph) * (rowbytes + 1);
        try {
            unfilter(rows, ph, rowbytes, bpp);
        } catch (...) {
            std::free(out);
            throw;
        }
        for (uint32_t y = 0; y < ph; ++y) {
            uint8_t const* r = rows + y * (rowbytes + 1) + 1;
            uint8_t* o = out + (size_t(ps.y0) + size_t(y) * ps.dy) * w * oc;
            if (!interlace && depth == 8 && nc == oc) {  // rows as they are
                std::memcpy(o, r, rowbytes);
                continue;
            }
            auto sample = [&](size_t i) -> uint32_t {
                if (depth == 8) return r[i];
                if (depth == 16) return (uint32_t(r[2 * i]) << 8) | r[2 * i + 1];
                size_t const bit = i * size_t(depth);
                return (uint32_t(r[bit >> 3]) >> (8 - depth - (bit & 7))) &
                       mask;
            };
            auto to8 = [&](uint32_t v) -> uint8_t {
                return uint8_t(depth == 16 ? v >> 8 : v * scale);
            };
            for (uint32_t x = 0; x < pw; ++x) {
                uint8_t* d = o + (size_t(ps.x0) + size_t(x) * ps.dx) * oc;
                size_t const s = size_t(x) * nc;
                switch (color) {
                    case 0: {
                        uint32_t const g = sample(s);
                        d[0] = to8(g);
                        if (oc == 4) {
                            d[1] = d[2] = d[0];
                            d[3] = g == key[0] ? 0 : 255;
                        }
                        break;
                    }
                    case 2: {
                        uint32_t const rr = sample(s), gg = sample(s + 1),
                                       bb = sample(s + 2);
                        d[0] = to8(rr);
                        d[1] = to8(gg);
                        d[2] = to8(bb);
                        if (oc == 4)
                            d[3] = rr == key[0] && gg == key[1] &&
                                           bb == key[2]
                                       ? 0
                                       : 255;
                        break;
                    }
                    case 3: {
                        uint32_t const idx = sample(s);
                        std::memcpy(d, palette + idx * 3, 3);
                        if (oc == 4)
                            d[3] = int(idx) < trns_n ? trns_alpha[idx] : 255;
                        break;
                    }
                    case 4:
                        d[0] = d[1] = d[2] = to8(sample(s));
                        d[3] = to8(sample(s + 1));
                        break;
                    default:
                        for (int c = 0; c < 4; ++c) d[c] = to8(sample(s + c));
                }
            }
        }
    }
    *w_out = int(w);
    *h_out = int(h);
    *channels_out = oc;
    return out;
}

// ---------------------------------------------------------------------------
// Deflate (RFC 1951) with zlib framing (RFC 1950)
// ---------------------------------------------------------------------------

// The stream's bits, least significant first.
struct BitWriter {
    std::vector<uint8_t>* out;
    uint64_t buf = 0;
    int cnt = 0;

    void put(uint32_t v, int n) {  // n <= 32
        buf |= uint64_t(v) << cnt;
        cnt += n;
        while (cnt >= 8) {
            out->push_back(uint8_t(buf));
            buf >>= 8;
            cnt -= 8;
        }
    }
    void flush() {
        if (cnt > 0) out->push_back(uint8_t(buf));
        buf = 0;
        cnt = 0;
    }
};

// A literal (dist 0) or a match of `len` bytes `dist` back.
struct Token {
    uint16_t len;  // the literal byte, or the match length
    uint16_t dist;
};

int length_code(int len) {  // 0..28 for lengths 3..258
    int c = 28;
    while (kLenBase[c] > len) --c;
    return c;
}

int distance_code(int dist) {  // 0..29 for distances 1..32768
    int c = 29;
    while (kDistBase[c] > dist) --c;
    return c;
}

// LZ77 over hash chains of three-byte prefixes, with one step of lazy
// matching. zlib's level-5 parameters: on served masks as fast as or
// faster than Pillow's default encode (zlib level 6, a chain of 128), with
// at most ~7% more bytes.
std::vector<Token> lz77(uint8_t const* data, size_t n) {
    constexpr int kWindow = 32768, kHashBits = 15, kMaxMatch = 258;
    constexpr int kChain = 32, kGoodLength = 8, kMaxLazy = 16,
                  kNiceLength = 32;
    std::vector<int32_t> head(size_t(1) << kHashBits, -1), prev(kWindow, -1);
    auto hash = [&](size_t i) {
        uint32_t const v = uint32_t(data[i]) | (uint32_t(data[i + 1]) << 8) |
                           (uint32_t(data[i + 2]) << 16);
        return (v * 2654435761u) >> (32 - kHashBits);
    };
    auto insert = [&](size_t i) {
        uint32_t const hv = hash(i);
        prev[i & (kWindow - 1)] = head[hv];
        head[hv] = int32_t(i);
    };
    // The longest match at i (length 0 when under 3), given the length
    // the lazy step must beat.
    auto longest = [&](size_t i, int prev_len, int* dist) {
        int const limit = int(std::min<size_t>(kMaxMatch, n - i));
        int best = std::max(prev_len, 2);
        int chain = prev_len >= kGoodLength ? kChain / 4 : kChain;
        int found = 0;
        uint8_t const* b = data + i;
        for (int32_t cand = head[hash(i)];
             cand >= 0 && i - size_t(cand) <= size_t(kWindow) && chain-- > 0;) {
            uint8_t const* a = data + cand;
            if (best < limit && a[best] == b[best] && a[0] == b[0] &&
                a[1] == b[1]) {
                int len = 2;
                for (uint64_t x; len + 8 <= limit; len += 8)
                    if ((x = le64(a + len) ^ le64(b + len)) != 0) {
                        len += __builtin_ctzll(x) >> 3;
                        goto matched;
                    }
                while (len < limit && a[len] == b[len]) ++len;
            matched:
                if (len > best) {
                    best = len;
                    found = len;
                    *dist = int(i - size_t(cand));
                    if (len >= kNiceLength || len == limit) break;
                }
            }
            int32_t const next = prev[size_t(cand) & (kWindow - 1)];
            if (next >= cand) break;  // the slot holds a newer position
            cand = next;
        }
        return found;
    };
    std::vector<Token> tokens;
    tokens.reserve(n / 4 + 16);
    size_t i = 0;
    int prev_len = 0, prev_dist = 0;
    bool pending = false;  // a literal or a match at i - 1 awaits
    while (i < n) {
        int cur_len = 0, cur_dist = 0;
        if (i + 3 <= n) {
            if (!pending || prev_len < kMaxLazy)
                cur_len = longest(i, pending ? prev_len : 0, &cur_dist);
            insert(i);
        }
        if (pending && prev_len >= 3 && cur_len <= prev_len) {
            tokens.push_back({uint16_t(prev_len), uint16_t(prev_dist)});
            size_t const end = i - 1 + size_t(prev_len);
            for (size_t j = i + 1; j < end; ++j)
                if (j + 3 <= n) insert(j);
            i = end;
            pending = false;
            prev_len = 0;
            continue;
        }
        if (pending) tokens.push_back({data[i - 1], 0});
        pending = true;
        prev_len = cur_len >= 3 ? cur_len : 0;
        prev_dist = cur_dist;
        ++i;
    }
    if (pending) {
        if (prev_len >= 3)
            tokens.push_back({uint16_t(prev_len), uint16_t(prev_dist)});
        else
            tokens.push_back({data[n - 1], 0});
    }
    return tokens;
}

// Huffman code lengths of at most `limit` bits for the n frequencies;
// at least two symbols get a code (a complete code).
void huffman_lengths(std::vector<uint32_t> freq, int limit, uint8_t* lengths) {
    int const n = int(freq.size());
    int used = 0;
    for (uint32_t f : freq) used += f > 0;
    for (int i = 0; used < 2 && i < n; ++i)
        if (!freq[i]) {
            freq[i] = 1;
            ++used;
        }
    for (;;) {
        using Node = std::pair<uint64_t, int>;
        std::priority_queue<Node, std::vector<Node>, std::greater<Node>> q;
        std::vector<int> parent(size_t(2 * n), -1);
        for (int i = 0; i < n; ++i)
            if (freq[i]) q.push({freq[i], i});
        int next = n;
        while (q.size() > 1) {
            Node a = q.top();
            q.pop();
            Node b = q.top();
            q.pop();
            parent[size_t(a.second)] = parent[size_t(b.second)] = next;
            q.push({a.first + b.first, next++});
        }
        int longest = 0;
        for (int i = 0; i < n; ++i) {
            int len = 0;
            if (freq[i])
                for (int k = i; parent[size_t(k)] >= 0; k = parent[size_t(k)])
                    ++len;
            lengths[i] = uint8_t(len);
            longest = std::max(longest, len);
        }
        if (longest <= limit) return;
        for (uint32_t& f : freq)  // flatten the distribution and try again
            if (f) f = (f >> 1) | 1;
    }
}

// Canonical codes for the lengths, bit-reversed for the LSB-first writer.
void canonical_codes(uint8_t const* lengths, int n, uint16_t* codes) {
    uint16_t count[16] = {0};
    for (int i = 0; i < n; ++i) count[lengths[i]]++;
    count[0] = 0;
    uint32_t next[16] = {0};
    for (int len = 1; len < 16; ++len)
        next[len] = (next[len - 1] + count[len - 1]) << 1;
    for (int i = 0; i < n; ++i)
        codes[i] = lengths[i] ? uint16_t(reverse_bits(next[lengths[i]]++,
                                                      lengths[i]))
                              : 0;
}

// One deflate block of tokens[begin, end): fixed or dynamic Huffman codes,
// whichever takes fewer bits.
void write_block(BitWriter* bw, std::vector<Token> const& tokens,
                 size_t begin, size_t end, bool last) {
    std::vector<uint32_t> lf(286, 0), df(30, 0);
    uint64_t extra = 0;  // the length and distance extra bits
    for (size_t t = begin; t < end; ++t) {
        Token const& k = tokens[t];
        if (!k.dist) {
            lf[k.len]++;
            continue;
        }
        int const lc = length_code(k.len), dc = distance_code(k.dist);
        lf[size_t(257 + lc)]++;
        df[size_t(dc)]++;
        extra += kLenExtra[lc] + kDistExtra[dc];
    }
    lf[256] = 1;

    uint8_t fl[288], fd[32];
    fixed_lengths(fl, fd);
    uint64_t fixed_bits = 3 + extra;
    for (int i = 0; i < 286; ++i) fixed_bits += uint64_t(lf[size_t(i)]) * fl[i];
    for (int i = 0; i < 30; ++i) fixed_bits += uint64_t(df[size_t(i)]) * 5;

    uint8_t ll[286], dl[30];
    huffman_lengths(lf, 15, ll);
    huffman_lengths(df, 15, dl);
    int nlit = 286, ndist = 30;
    while (nlit > 257 && !ll[nlit - 1]) --nlit;
    while (ndist > 1 && !dl[ndist - 1]) --ndist;
    // The code lengths, run-length coded with symbols 16-18.
    std::vector<uint8_t> seq(ll, ll + nlit);
    seq.insert(seq.end(), dl, dl + ndist);
    std::vector<std::pair<uint8_t, uint8_t>> rle;  // (symbol, extra value)
    for (size_t i = 0; i < seq.size();) {
        uint8_t const v = seq[i];
        size_t run = 1;
        while (i + run < seq.size() && seq[i + run] == v) ++run;
        size_t left = run;
        if (v == 0) {
            while (left >= 11) {
                size_t const r = std::min<size_t>(left, 138);
                rle.push_back({18, uint8_t(r - 11)});
                left -= r;
            }
            if (left >= 3) {
                rle.push_back({17, uint8_t(left - 3)});
                left = 0;
            }
        } else {
            rle.push_back({v, 0});
            --left;
            while (left >= 3) {
                size_t const r = std::min<size_t>(left, 6);
                rle.push_back({16, uint8_t(r - 3)});
                left -= r;
            }
        }
        for (; left; --left) rle.push_back({v, 0});
        i += run;
    }
    std::vector<uint32_t> cf(19, 0);
    for (auto const& r : rle) cf[r.first]++;
    uint8_t cl[19];
    huffman_lengths(cf, 7, cl);
    int ncode = 19;
    while (ncode > 4 && !cl[kClOrder[ncode - 1]]) --ncode;
    uint64_t dynamic_bits = 3 + 5 + 5 + 4 + 3 * uint64_t(ncode) + extra;
    for (auto const& r : rle)
        dynamic_bits += cl[r.first] + (r.first == 16 ? 2 : r.first == 17 ? 3
                                       : r.first == 18 ? 7 : 0);
    for (int i = 0; i < nlit; ++i)
        dynamic_bits += uint64_t(lf[size_t(i)]) * ll[i];
    for (int i = 0; i < ndist; ++i)
        dynamic_bits += uint64_t(df[size_t(i)]) * dl[i];

    uint16_t lcode[288], dcode[32];
    uint8_t const* lit_len;
    uint8_t const* dist_len;
    bw->put(last ? 1 : 0, 1);
    if (fixed_bits <= dynamic_bits) {
        bw->put(1, 2);
        canonical_codes(fl, 288, lcode);
        canonical_codes(fd, 30, dcode);
        lit_len = fl;
        dist_len = fd;
    } else {
        bw->put(2, 2);
        bw->put(uint32_t(nlit - 257), 5);
        bw->put(uint32_t(ndist - 1), 5);
        bw->put(uint32_t(ncode - 4), 4);
        for (int i = 0; i < ncode; ++i) bw->put(cl[kClOrder[i]], 3);
        uint16_t ccode[19];
        canonical_codes(cl, 19, ccode);
        for (auto const& r : rle) {
            bw->put(ccode[r.first], cl[r.first]);
            if (r.first == 16) bw->put(r.second, 2);
            if (r.first == 17) bw->put(r.second, 3);
            if (r.first == 18) bw->put(r.second, 7);
        }
        canonical_codes(ll, 286, lcode);
        canonical_codes(dl, 30, dcode);
        lit_len = ll;
        dist_len = dl;
    }
    for (size_t t = begin; t < end; ++t) {
        Token const& k = tokens[t];
        if (!k.dist) {
            bw->put(lcode[k.len], lit_len[k.len]);
            continue;
        }
        int const lc = length_code(k.len), dc = distance_code(k.dist);
        bw->put(lcode[257 + lc], lit_len[257 + lc]);
        bw->put(uint32_t(k.len - kLenBase[lc]), kLenExtra[lc]);
        bw->put(dcode[dc], dist_len[dc]);
        bw->put(uint32_t(k.dist - kDistBase[dc]), kDistExtra[dc]);
    }
    bw->put(lcode[256], lit_len[256]);
}

// data[0, n) as a zlib stream appended to *out.
void zlib_compress(uint8_t const* data, size_t n, std::vector<uint8_t>* out) {
    out->push_back(0x78);  // deflate, 32 KiB window
    out->push_back(0x9c);  // default level, no dictionary, FCHECK
    std::vector<Token> const tokens = lz77(data, n);
    BitWriter bw{out};
    size_t constexpr kBlockTokens = 1 << 16;
    for (size_t b = 0; b < tokens.size() || b == 0; b += kBlockTokens) {
        size_t const e = std::min(tokens.size(), b + kBlockTokens);
        write_block(&bw, tokens, b, e, e == tokens.size());
    }
    bw.flush();
    put32(out, adler32(data, n));
}

void put_chunk(std::vector<uint8_t>* out, char const* type,
               uint8_t const* body, size_t len) {
    put32(out, uint32_t(len));
    size_t const at = out->size();
    out->insert(out->end(), type, type + 4);
    out->insert(out->end(), body, body + len);
    put32(out, crc32(out->data() + at, len + 4));
}

// Row r (n bytes, the row above it `up`) under filter `type` into out.
void filter_row(int type, uint8_t const* r, uint8_t const* up, size_t bpp,
                size_t n, uint8_t* out) {
    size_t const head = std::min(bpp, n);  // bytes with no left neighbour
    switch (type) {
        case 0:
            std::memcpy(out, r, n);
            break;
        case 1:
            std::memcpy(out, r, head);
            for (size_t i = bpp; i < n; ++i) out[i] = uint8_t(r[i] - r[i - bpp]);
            break;
        case 2:
            for (size_t i = 0; i < n; ++i) out[i] = uint8_t(r[i] - up[i]);
            break;
        case 3:
            for (size_t i = 0; i < head; ++i) out[i] = uint8_t(r[i] - (up[i] >> 1));
            for (size_t i = bpp; i < n; ++i)
                out[i] = uint8_t(r[i] - ((r[i - bpp] + up[i]) >> 1));
            break;
        default:
            for (size_t i = 0; i < head; ++i) out[i] = uint8_t(r[i] - up[i]);
            for (size_t i = bpp; i < n; ++i)
                out[i] = uint8_t(r[i] - paeth(r[i - bpp], up[i], up[i - bpp]));
    }
}

void encode_png(uint8_t const* pixels, int w, int h, int channels, int stride,
                std::vector<uint8_t>* out) {
    if (channels != 1 && channels != 3 && channels != 4)
        fail("cannot encode " + std::to_string(channels) + " channels");
    if (w <= 0 || h <= 0)
        fail("cannot encode a " + std::to_string(w) + "x" +
             std::to_string(h) + " image");
    size_t const rowbytes = size_t(w) * channels;
    size_t const pitch = stride > 0 ? size_t(stride) : rowbytes;
    if (pitch < rowbytes) fail("a stride shorter than a row");
    // Each row under the filter whose bytes, read as signed, have the
    // least sum of absolute values.
    std::vector<uint8_t> filtered(size_t(h) * (rowbytes + 1));
    std::vector<uint8_t> zero(rowbytes, 0), trial(5 * rowbytes);
    size_t const bpp = size_t(channels);
    for (int y = 0; y < h; ++y) {
        uint8_t const* r = pixels + size_t(y) * pitch;
        uint8_t const* up = y ? pixels + size_t(y - 1) * pitch : zero.data();
        int best = 0;
        uint64_t best_sum = ~uint64_t(0);
        for (int type = 0; type < 5; ++type) {
            uint8_t* t = trial.data() + size_t(type) * rowbytes;
            filter_row(type, r, up, bpp, rowbytes, t);
            uint64_t sum = 0;
            for (size_t i = 0; i < rowbytes; ++i)
                sum += t[i] < 128 ? t[i] : 256 - t[i];
            if (sum < best_sum) {
                best_sum = sum;
                best = type;
            }
        }
        uint8_t* o = filtered.data() + size_t(y) * (rowbytes + 1);
        o[0] = uint8_t(best);
        std::memcpy(o + 1, trial.data() + size_t(best) * rowbytes, rowbytes);
    }
    std::vector<uint8_t> z;
    zlib_compress(filtered.data(), filtered.size(), &z);

    out->clear();
    out->insert(out->end(), kSignature, kSignature + 8);
    uint8_t ihdr[13];
    for (int i = 0; i < 4; ++i) {
        ihdr[i] = uint8_t(uint32_t(w) >> (24 - 8 * i));
        ihdr[4 + i] = uint8_t(uint32_t(h) >> (24 - 8 * i));
    }
    ihdr[8] = 8;
    ihdr[9] = channels == 1 ? 0 : channels == 3 ? 2 : 6;
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    put_chunk(out, "IHDR", ihdr, sizeof ihdr);
    size_t constexpr kIdatBytes = size_t(1) << 20;
    for (size_t at = 0; at < z.size(); at += kIdatBytes)
        put_chunk(out, "IDAT", z.data() + at,
                  std::min(kIdatBytes, z.size() - at));
    put_chunk(out, "IEND", nullptr, 0);
}

}  // namespace

uint8_t* decode(uint8_t const* data, size_t size, int* w, int* h,
                int* channels, std::string* error) {
    try {
        return decode_png(data, size, w, h, channels);
    } catch (Error const& e) {
        *error = e.what;
    } catch (std::bad_alloc const&) {
        *error = "png: allocation failed";
    }
    return nullptr;
}

bool encode(uint8_t const* pixels, int w, int h, int channels, int stride,
            std::vector<uint8_t>* out, std::string* error) {
    try {
        encode_png(pixels, w, h, channels, stride, out);
        return true;
    } catch (Error const& e) {
        *error = e.what;
    } catch (std::bad_alloc const&) {
        *error = "png: allocation failed";
    }
    return false;
}

}  // namespace dlimg_png
