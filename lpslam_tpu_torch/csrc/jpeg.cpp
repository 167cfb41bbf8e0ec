// Baseline 8-bit grey JPEG, the native codec behind lpslam_tpu_torch/io/jpeg.py.
//
// C++17 and the standard library only, bound through a C ABI (ctypes drops
// the GIL for the length of a call, so the camera, slam-worker and replay
// threads code frames side by side). Both halves follow io/jpeg.py's numpy
// reference step for step, which the tests hold them to:
//
// - lpslam_jpeg_encode_gray writes encode_gray_reference's bytes (those of
//   OpenCV's imencode with libjpeg-turbo): JFIF 1.01 APP0, one DQT (the
//   Annex K luminance table under IJG quality scaling), SOF0 with one
//   component, the two standard luminance DHTs, one scan, EOI. Samples are
//   edge-replicated to a multiple of 8, go through jfdctint.c's integer
//   forward DCT, are quantized by rounding division and Huffman-coded with
//   0xFF00 stuffing.
// - lpslam_jpeg_decode_gray returns decode_gray_reference's result: the
//   pixels, "no image" (None) or a refusal (ValueError, with the same text),
//   for any Huffman and 8- or 16-bit quantization tables, grey and YCbCr at
//   any sampling with full-size luma, several sequential scans, restart
//   intervals, libjpeg's recovery and suspension rules for a scan cut short,
//   and jidctint.c's inverse DCT on 16-bit lanes. The EXIF orientation is
//   returned for the caller to apply. Every read of the input is
//   bounds-checked: it is untrusted.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <vector>

namespace {

const int ZIGZAG[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
    15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
    62, 63};

// ITU T.81 Annex K.1, luminance, natural order
const int LUMA_QUANT[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

// Annex K.3 Huffman tables as DHT payloads: class/id, 16 counts, values
const uint8_t DHT_DC0[] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a,
    0x0b};
const uint8_t DHT_AC0[] = {
    0x10, 0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00,
    0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23,
    0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a,
    0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a,
    0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88,
    0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4,
    0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9,
    0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5,
    0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t DHT_DC1[] = {
    0x01, 0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a,
    0x0b};
const uint8_t DHT_AC1[] = {
    0x11, 0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04, 0x00,
    0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1,
    0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24,
    0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35,
    0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86,
    0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2,
    0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
    0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// libjpeg's islow fixed-point constants (CONST_BITS 13, PASS1_BITS 2)
const int CB = 13, P1 = 2;
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
const int64_t F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
const int64_t F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// -- encoder ------------------------------------------------------------------

// One pass of jfdctint.c's forward DCT over d[0], d[s], ..., d[7 s].
void fdct_pass(int64_t* d, int s, bool pass2) {
    int64_t t0 = d[0] + d[7 * s], t7 = d[0] - d[7 * s];
    int64_t t1 = d[s] + d[6 * s], t6 = d[s] - d[6 * s];
    int64_t t2 = d[2 * s] + d[5 * s], t5 = d[2 * s] - d[5 * s];
    int64_t t3 = d[3 * s] + d[4 * s], t4 = d[3 * s] - d[4 * s];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    int64_t o[8];
    int n = pass2 ? CB + P1 : CB - P1;
    if (pass2) {
        o[0] = descale(t10 + t11, P1);
        o[4] = descale(t10 - t11, P1);
    } else {
        o[0] = (t10 + t11) * (1 << P1);
        o[4] = (t10 - t11) * (1 << P1);
    }
    int64_t z1 = (t12 + t13) * F0541;
    o[2] = descale(z1 + t13 * F0765, n);
    o[6] = descale(z1 - t12 * F1847, n);
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * F1175;
    t4 *= F0298;
    t5 *= F2053;
    t6 *= F3072;
    t7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    o[7] = descale(t4 + z1 + z3, n);
    o[5] = descale(t5 + z2 + z4, n);
    o[3] = descale(t6 + z2 + z3, n);
    o[1] = descale(t7 + z1 + z4, n);
    for (int i = 0; i < 8; i++) d[i * s] = o[i];
}

struct Codes {
    uint32_t code[256];
    int len[256];
};

// (code, length) per symbol value of a DHT payload (Annex C)
Codes canonical_codes(const uint8_t* dht) {
    Codes c;
    std::memset(&c, 0, sizeof c);
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; length++) {
        for (int i = 0; i < dht[length]; i++) {
            int v = dht[17 + k++];
            c.code[v] = code++;
            c.len[v] = length;
        }
        code <<= 1;
    }
    return c;
}

struct BitWriter {
    uint8_t* out;
    size_t cap, n = 0;
    uint64_t acc = 0;
    int bits = 0;
    bool overflow = false;

    void byte(uint8_t b) {
        if (n + 2 > cap) {
            overflow = true;
            return;
        }
        out[n++] = b;
        if (b == 0xFF) out[n++] = 0x00;
    }
    void put(uint32_t v, int len) {  // len <= 27
        if (len == 0) return;
        acc = (acc << len) | (v & ((uint32_t(1) << len) - 1));
        bits += len;
        while (bits >= 8) {
            bits -= 8;
            byte(uint8_t(acc >> bits));
        }
    }
    void flush() {  // 1-bits to the byte
        if (bits) put((uint32_t(1) << (8 - bits)) - 1, 8 - bits);
    }
};

int bit_length(int64_t v) {
    uint64_t a = v < 0 ? uint64_t(-v) : uint64_t(v);
    int n = 0;
    while (a) {
        n++;
        a >>= 1;
    }
    return n;
}

// The magnitude bits JPEG appends after a symbol of category `size`.
uint32_t extra_bits(int64_t v, int size) {
    return uint32_t(v < 0 ? v + (int64_t(1) << size) - 1 : v);
}

struct Out {
    uint8_t* p;
    size_t cap, n = 0;
    bool overflow = false;
    void raw(const uint8_t* b, size_t len) {
        if (n + len > cap) {
            overflow = true;
            return;
        }
        std::memcpy(p + n, b, len);
        n += len;
    }
    void segment(uint8_t marker, const uint8_t* payload, size_t len) {
        uint8_t head[4] = {0xFF, marker, uint8_t((len + 2) >> 8), uint8_t((len + 2) & 0xFF)};
        raw(head, 4);
        raw(payload, len);
    }
};

// -- decoder ------------------------------------------------------------------

struct Corrupt {};    // a structural error: libjpeg stops, OpenCV returns no image
struct Suspended {};  // the data ends where libjpeg needs more: no image
struct IndexErr {};   // the reference reads past an array: no image
struct Refused {      // the reference's ValueError
    std::string msg;
};

// A DHT's decoding table: lut[w16] = length << 8 | symbol of the code that
// starts the 16-bit window w16 (length 17, symbol 0 where no code does).
struct Huff {
    std::vector<uint8_t> counts, values;
    bool is_dc;
    std::vector<uint32_t> lut;
};

std::shared_ptr<Huff> build_huff(const std::vector<uint8_t>& counts,
                                 const std::vector<uint8_t>& values, bool is_dc) {
    int total = 0;
    for (uint8_t c : counts) total += c;
    if (total > 256) throw Corrupt{};
    if (is_dc)
        for (uint8_t v : values)
            if (v > 15) throw Corrupt{};
    auto h = std::make_shared<Huff>();
    h->counts = counts;
    h->values = values;
    h->is_dc = is_dc;
    h->lut.assign(1 << 16, 17u << 8);
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; length++) {
        for (int i = 0; i < counts[length - 1]; i++) {
            if (code >= (uint32_t(1) << length)) throw Corrupt{};
            uint32_t lo = code << (16 - length);
            uint32_t e = (uint32_t(length) << 8) | values[k];
            std::fill(h->lut.begin() + lo, h->lut.begin() + lo + (1u << (16 - length)), e);
            code++;
            k++;
        }
        code <<= 1;
    }
    return h;
}

// The standard tables recur in every file: keep the last few per thread.
std::shared_ptr<Huff> cached_huff(const std::vector<uint8_t>& counts,
                                  const std::vector<uint8_t>& values, bool is_dc) {
    thread_local std::vector<std::shared_ptr<Huff>> cache;
    for (auto& h : cache)
        if (h->is_dc == is_dc && h->counts == counts && h->values == values) return h;
    auto h = build_huff(counts, values, is_dc);
    if (cache.size() >= 16) cache.erase(cache.begin());
    cache.push_back(h);
    return h;
}

struct Comp {
    int id, h, v, tq;
    bool has_q = false;
    int64_t q[64];
    int64_t bx = 0, by = 0;
};

// The entropy-coded bytes from `start` to the next marker, each FF00 made
// FF; raw_end[i] = the raw offset after data byte i; marker = the offset of
// the marker's FF, or -1 where the data ends first.
void unstuff(const uint8_t* data, int64_t n, int64_t start, std::vector<uint8_t>& out,
             std::vector<int64_t>& raw_end, int64_t& marker) {
    out.clear();
    raw_end.clear();
    int64_t i = start;
    while (true) {
        const void* f = i < n ? std::memchr(data + i, 0xFF, size_t(n - i)) : nullptr;
        int64_t j = f ? int64_t(static_cast<const uint8_t*>(f) - data) : n;
        out.insert(out.end(), data + i, data + j);
        for (int64_t r = i + 1; r <= j; r++) raw_end.push_back(r);
        int64_t k = j + 1;
        while (k < n && data[k] == 0xFF) k++;
        if (k >= n) {
            marker = -1;
            return;
        }
        if (data[k] != 0) {
            marker = k - 1;
            return;
        }
        out.push_back(0xFF);
        raw_end.push_back(k + 1);
        i = k + 1;
    }
}

// Where a scan runs to the end of the data with no marker, libjpeg-turbo
// suspends when a bit-buffer refill cannot load 57 bits: the reference's
// _BitFill, refill for refill.
struct BitFill {
    std::vector<int64_t> raw_end;
    int64_t raw_total;
    bool fast_ok;
    int64_t loaded = 0;
    bool fast = false;

    void begin_mcu(int64_t blocks) {
        int64_t read = 0;
        if (loaded) {
            if (loaded - 1 >= int64_t(raw_end.size())) throw IndexErr{};
            read = raw_end[loaded - 1];
        }
        fast = fast_ok && raw_total - read >= 512 * blocks;
    }
    void take(int64_t p, int64_t nbits) {
        int64_t left = 8 * loaded - p;
        if (fast) {
            if (left <= 16) loaded += 6;
        } else if (left < nbits) {
            int64_t need = (p + 57 + 7) / 8;
            if (need > int64_t(raw_end.size())) throw Suspended{};
            loaded = need;
        }
    }
    void code(int64_t p, int64_t length) { take(p, length > 8 ? length : 8); }
    void bits(int64_t p, int64_t s) { take(p, s); }
};

struct Block {
    const Huff* dc;
    const Huff* ac;
    int slot, nth;
};

class Decoder {
  public:
    Decoder(const uint8_t* d, int64_t n) : data(d), n(n) {}

    // Decodes to the luma coefficients; returns the EXIF orientation.
    int run();
    void render(uint8_t* out) const;

    int64_t height = 0, width = 0;

  private:
    const uint8_t* data;
    int64_t n;
    bool has_qt[4] = {false, false, false, false};
    int64_t qt[4][64];
    bool has_ht[2][4] = {{false}};
    std::vector<uint8_t> ht_counts[2][4], ht_values[2][4];
    bool have_frame = false;
    std::vector<Comp> comps;
    int64_t mx = 0, my = 0, ybw = 0, ybh = 0;
    int restart = 0;
    bool jfif = false;
    int adobe_transform = -1;
    int orientation = 1;
    int single_scan = -1;  // -1 unknown, 0 / 1
    std::vector<int16_t> coefs;  // kept wrapped to 16 bits: the IDCT reads them so

    int64_t segment(int64_t i, int& m, int64_t& seg, int64_t& seg_len);
    void sof(const uint8_t* s, int64_t len);
    void dht(const uint8_t* s, int64_t len);
    void dqt(const uint8_t* s, int64_t len);
    std::shared_ptr<Huff> table(int tc, int th);
    int64_t scan(const uint8_t* s, int64_t len, int64_t i);
    bool decode_interval(const std::vector<uint8_t>& seg, BitFill* fill,
                         const std::vector<Block>& blocks, int64_t mcus, int64_t first,
                         int64_t pad, bool single, int64_t bx, int yslot);
};

// Next marker at or after i: its code, its payload (offset, length) and the
// offset after it.
int64_t Decoder::segment(int64_t i, int& m, int64_t& seg, int64_t& seg_len) {
    while (i < n && data[i] != 0xFF) i++;  // stray bytes
    while (i < n && data[i] == 0xFF) i++;  // fill bytes
    if (i >= n) throw Suspended{};
    m = data[i++];
    seg = i;
    seg_len = 0;
    if (m == 0xD8 || m == 0xD9 || m == 0x01 || (0xD0 <= m && m <= 0xD7)) return i;
    if (i + 2 > n) throw Suspended{};
    int64_t length = (int64_t(data[i]) << 8) | data[i + 1];
    if (length < 2) throw Corrupt{};
    if (i + length > n) throw Suspended{};
    seg = i + 2;
    seg_len = length - 2;
    return i + length;
}

const char* refused_sof(int m) {
    switch (m) {
        case 0xC2: return "progressive";
        case 0xC3: return "lossless";
        case 0xC5: case 0xC6: case 0xC7: return "hierarchical";
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            return "arithmetic-coded";
        default: return nullptr;
    }
}

bool starts_with(const uint8_t* s, int64_t len, const char* prefix, int64_t plen) {
    return len >= plen && std::memcmp(s, prefix, size_t(plen)) == 0;
}

// Tag 0x0112 of IFD0 in an APP1 Exif payload; 1 when absent or bad.
int exif_orientation(const uint8_t* s, int64_t len) {
    if (!starts_with(s, len, "Exif\0\0", 6)) return 1;
    const uint8_t* t = s + 6;
    int64_t tl = len - 6;
    if (tl < 2) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto u16 = [&](int64_t o, uint32_t& v) {
        if (o < 0 || o + 2 > tl) return false;
        v = le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
        return true;
    };
    auto u32 = [&](int64_t o, uint32_t& v) {
        if (o < 0 || o + 4 > tl) return false;
        v = le ? (uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) | (uint32_t(t[o + 2]) << 16) |
                  (uint32_t(t[o + 3]) << 24))
               : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                  (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]));
        return true;
    };
    uint32_t off, count;
    if (!u32(4, off) || !u16(off, count)) return 1;
    for (uint32_t i = 0; i < count; i++) {
        uint32_t tag, typ;
        int64_t e = int64_t(off) + 2 + 12 * int64_t(i);
        if (!u16(e, tag) || !u16(e + 2, typ)) return 1;
        if (tag == 0x0112 && typ == 3) {
            uint32_t v;
            if (!u16(int64_t(off) + 10 + 12 * int64_t(i), v)) return 1;
            return (1 <= v && v <= 8) ? int(v) : 1;
        }
    }
    return 1;
}

int Decoder::run() {
    int64_t i = 2;
    while (true) {
        int m;
        int64_t so, sl;
        i = segment(i, m, so, sl);
        const uint8_t* s = data + so;
        if (m == 0xD9) {
            if (single_scan < 0) throw Corrupt{};  // no image
            break;
        }
        if (m == 0xD8) throw Corrupt{};  // second SOI
        if (const char* what = refused_sof(m)) {
            char buf[160];
            std::snprintf(buf, sizeof buf,
                          "decode_gray: %s JPEG (SOF%d) is not supported; baseline and "
                          "extended sequential only", what, m - 0xC0);
            throw Refused{buf};
        }
        if (m == 0xC0 || m == 0xC1) {
            sof(s, sl);
        } else if (m == 0xC4) {
            dht(s, sl);
        } else if (m == 0xDB) {
            dqt(s, sl);
        } else if (m == 0xDD) {
            if (sl < 2) throw IndexErr{};  // struct.error in the reference
            restart = (s[0] << 8) | s[1];
        } else if (m == 0xE0 && starts_with(s, sl, "JFIF\0", 5)) {
            jfif = true;
        } else if (m == 0xE1 && orientation == 1) {
            orientation = exif_orientation(s, sl);
        } else if (m == 0xEE && starts_with(s, sl, "Adobe", 5) && sl >= 12) {
            adobe_transform = s[11];
        } else if (m == 0xDA) {
            i = scan(s, sl, i);
            if (single_scan == 1) break;  // libjpeg outputs as it reads one scan
        } else if (!(m == 0xCC || m == 0xDC || m == 0xFE || m == 0x01 ||
                     (0xD0 <= m && m <= 0xD7) || (0xE0 <= m && m <= 0xEF))) {
            throw Corrupt{};  // libjpeg: JERR_UNKNOWN_MARKER
        }
    }
    return orientation;
}

void Decoder::sof(const uint8_t* s, int64_t len) {
    if (have_frame) throw Corrupt{};
    if (len < 6) throw IndexErr{};  // struct.error
    int prec = s[0];
    int64_t h = (s[1] << 8) | s[2], w = (s[3] << 8) | s[4];
    int nc = s[5];
    if (prec != 8) {
        char buf[96];
        std::snprintf(buf, sizeof buf, "decode_gray: %d-bit JPEG is not supported (8-bit only)",
                      prec);
        throw Refused{buf};
    }
    if (h == 0 || w == 0 || nc == 0 || len < 6 + 3 * nc) throw Corrupt{};
    comps.clear();
    for (int c = 0; c < nc; c++) {
        const uint8_t* e = s + 6 + 3 * c;
        int hv = e[1];
        if (!(1 <= (hv >> 4) && (hv >> 4) <= 4 && 1 <= (hv & 15) && (hv & 15) <= 4))
            throw Corrupt{};
        Comp k;
        k.id = e[0];
        k.h = hv >> 4;
        k.v = hv & 15;
        k.tq = e[2];
        comps.push_back(k);
    }
    if (nc == 3) {
        // libjpeg's default_decompress_parms: JFIF means YCbCr, else the
        // Adobe transform, else the component ids
        bool rgb_ids = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
        bool rgb = !jfif && (adobe_transform == 0 || (adobe_transform < 0 && rgb_ids));
        if (rgb) throw Refused{"decode_gray: RGB JPEG is not supported (grey and YCbCr only)"};
    } else if (nc != 1) {
        char buf[96];
        std::snprintf(buf, sizeof buf,
                      "decode_gray: %d-component JPEG is not supported (grey and YCbCr only)",
                      nc);
        throw Refused{buf};
    }
    int hmax = 0, vmax = 0;
    for (auto& k : comps) {
        hmax = k.h > hmax ? k.h : hmax;
        vmax = k.v > vmax ? k.v : vmax;
    }
    if (comps[0].h != hmax || comps[0].v != vmax)
        throw Refused{"decode_gray: luma subsampled below a chroma plane is not supported"};
    auto ceil_div = [](int64_t a, int64_t b) { return (a + b - 1) / b; };
    mx = ceil_div(w, 8 * hmax);
    my = ceil_div(h, 8 * vmax);
    for (auto& k : comps) {  // blocks in a scan of k alone
        k.bx = ceil_div(ceil_div(w * k.h, hmax), 8);
        k.by = ceil_div(ceil_div(h * k.v, vmax), 8);
    }
    ybw = mx * comps[0].h;
    ybh = my * comps[0].v;
    coefs.assign(size_t(ybw * ybh * 64), 0);
    height = h;
    width = w;
    have_frame = true;
}

void Decoder::dht(const uint8_t* s, int64_t len) {
    int64_t j = 0;
    while (j < len) {
        int tc = s[j] >> 4, th = s[j] & 15;
        int64_t nco = len - (j + 1);
        nco = nco < 0 ? 0 : (nco > 16 ? 16 : nco);
        int total = 0;
        for (int64_t c = 0; c < nco; c++) total += s[j + 1 + c];
        int64_t nva = len - (j + 17);
        nva = nva < 0 ? 0 : (nva > total ? total : nva);
        if (tc > 1 || th > 3 || nco < 16 || nva < total) throw Corrupt{};
        ht_counts[tc][th].assign(s + j + 1, s + j + 17);
        ht_values[tc][th].assign(s + j + 17, s + j + 17 + nva);
        has_ht[tc][th] = true;
        j += 17 + nva;
    }
}

void Decoder::dqt(const uint8_t* s, int64_t len) {
    int64_t j = 0;
    while (j < len) {
        int pq = s[j] >> 4, tq = s[j] & 15;
        if (tq > 3 || pq > 1) throw Corrupt{};
        int64_t size = pq ? 128 : 64;
        if (j + 1 + size > len) throw IndexErr{};  // struct.error
        for (int k = 0; k < 64; k++) {
            const uint8_t* v = s + j + 1 + (pq ? 2 * k : k);
            qt[tq][ZIGZAG[k]] = pq ? ((v[0] << 8) | v[1]) : v[0];
        }
        has_qt[tq] = true;
        j += 1 + size;
    }
}

// The DC or AC table for an SOS table id; libjpeg-turbo takes the standard
// tables for ids 0 / 1 that no DHT defined (motion JPEG).
std::shared_ptr<Huff> Decoder::table(int tc, int th) {
    if (th <= 3 && has_ht[tc][th]) return cached_huff(ht_counts[tc][th], ht_values[tc][th], tc == 0);
    if (th > 1) throw Corrupt{};
    const uint8_t* d = tc == 0 ? (th == 0 ? DHT_DC0 : DHT_DC1) : (th == 0 ? DHT_AC0 : DHT_AC1);
    int total = 0;
    for (int i = 1; i <= 16; i++) total += d[i];
    return cached_huff(std::vector<uint8_t>(d + 1, d + 17),
                       std::vector<uint8_t>(d + 17, d + 17 + total), tc == 0);
}

// Decode `mcus` MCUs, numbered from `first`, of one restart interval from
// its unstuffed bytes; bits past them read as zeros up to `pad` bytes, and
// past those the reference's window array ends (IndexErr). True when the
// data ran out (libjpeg's insufficient_data).
bool Decoder::decode_interval(const std::vector<uint8_t>& seg, BitFill* fill,
                              const std::vector<Block>& blocks, int64_t mcus, int64_t first,
                              int64_t pad, bool single, int64_t bx, int yslot) {
    const int64_t len = int64_t(seg.size());
    const int64_t end = 8 * len;
    const int64_t last_window = len + pad;  // the reference's windows 0 .. len + pad
    const uint8_t* b = seg.data();
    auto peek = [&](int64_t p) -> uint32_t {
        int64_t i = p >> 3;
        if (i > last_window) throw IndexErr{};
        uint64_t v = 0;
        if (i + 5 <= len) {
            v = (uint64_t(b[i]) << 32) | (uint64_t(b[i + 1]) << 24) | (uint64_t(b[i + 2]) << 16) |
                (uint64_t(b[i + 3]) << 8) | uint64_t(b[i + 4]);
        } else {
            for (int j = 0; j < 5; j++) v = (v << 8) | (i + j < len ? b[i + j] : 0);
        }
        return uint32_t(v >> (8 - (p & 7)));
    };
    const int hy = comps[0].h, vy = comps[0].v;
    const int64_t ncoef = int64_t(coefs.size());
    int64_t pred[4] = {0, 0, 0, 0};
    int64_t p = 0;
    for (int64_t m = first; m < first + mcus; m++) {
        if (fill) fill->begin_mcu(int64_t(blocks.size()));
        for (const Block& blk : blocks) {
            int64_t base = -1;
            if (blk.slot == yslot) {
                base = single ? ((m / bx) * ybw + m % bx) * 64
                              : (((m / mx) * vy + blk.nth / hy) * ybw + (m % mx) * hy +
                                 blk.nth % hy) * 64;
                if (base < 0 || base + 64 > ncoef) throw IndexErr{};
            }
            // DC: code, then `s` extra bits, a difference to the prediction
            uint32_t w = peek(p);
            uint32_t e = blk.dc->lut[w >> 16];
            int ln = int(e >> 8), s = int(e & 0xFF);
            if (fill) {
                fill->code(p, ln);
                if (s) fill->bits(p + ln, s);
            }
            if (s) {
                int64_t r = (w >> (32 - ln - s)) & ((uint32_t(1) << s) - 1);
                pred[blk.slot] += r >= (int64_t(1) << (s - 1)) ? r : r + 1 - (int64_t(1) << s);
            }
            p += ln + s;
            if (base >= 0) coefs[base] = int16_t(uint16_t(uint64_t(pred[blk.slot])));
            const uint32_t* lut = blk.ac->lut.data();
            int k = 1;
            while (k < 64) {
                w = peek(p);
                e = lut[w >> 16];
                ln = int(e >> 8);
                int run = int((e >> 4) & 15);
                s = int(e & 15);
                if (fill) {
                    fill->code(p, ln);
                    if (s) fill->bits(p + ln, s);
                }
                if (s) {
                    k += run;
                    int64_t r = (w >> (32 - ln - s)) & ((uint32_t(1) << s) - 1);
                    if (base >= 0)
                        coefs[base + ZIGZAG[k < 64 ? k : 63]] = int16_t(
                            r >= (int64_t(1) << (s - 1)) ? r : r + 1 - (int64_t(1) << s));
                } else if (run == 15) {  // ZRL
                    k += 15;
                } else {  // EOB
                    p += ln;
                    break;
                }
                p += ln + s;
                k += 1;
            }
        }
        if (p > end) return true;
    }
    return false;
}

// Decode one scan whose entropy-coded data starts at byte i; returns the
// offset of the marker that ends it.
int64_t Decoder::scan(const uint8_t* s, int64_t len, int64_t i) {
    if (!have_frame) throw Corrupt{};
    if (len < 1) throw IndexErr{};
    int ns = s[0];
    if (!(1 <= ns && ns <= 4) || len < 4 + 2 * ns) throw Corrupt{};
    if (!(s[1 + 2 * ns] == 0x00 && s[2 + 2 * ns] == 0x3F && s[3 + 2 * ns] == 0x00))
        throw Corrupt{};
    std::vector<int> scomp;
    std::vector<std::shared_ptr<Huff>> tabs;
    for (int c = 0; c < ns; c++) {
        int ci = -1;
        for (size_t k = 0; k < comps.size(); k++)
            if (comps[k].id == s[1 + 2 * c]) {
                ci = int(k);
                break;
            }
        if (ci < 0) throw Corrupt{};
        Comp& k = comps[size_t(ci)];
        if (!k.has_q) {  // latched at the component's first scan
            if (k.tq > 3 || !has_qt[k.tq]) throw Corrupt{};
            std::memcpy(k.q, qt[k.tq], sizeof k.q);
            k.has_q = true;
        }
        scomp.push_back(ci);
        int t = s[2 + 2 * c];
        tabs.push_back(table(0, t >> 4));
        tabs.push_back(table(1, t & 15));
    }
    if (single_scan < 0) single_scan = ns == int(comps.size()) ? 1 : 0;
    int yslot = -1;
    for (int c = 0; c < ns; c++)
        if (scomp[size_t(c)] == 0) {
            yslot = c;
            break;
        }
    std::vector<Block> blocks;
    int64_t total, bx = 0;
    bool single = ns == 1;
    if (single) {
        const Comp& k = comps[size_t(scomp[0])];
        bx = k.bx;
        total = bx * k.by;
        blocks.push_back({tabs[0].get(), tabs[1].get(), 0, 0});
    } else {
        total = mx * my;
        for (int c = 0; c < ns; c++) {
            const Comp& k = comps[size_t(scomp[size_t(c)])];
            for (int nth = 0; nth < k.h * k.v; nth++)
                blocks.push_back({tabs[size_t(2 * c)].get(), tabs[size_t(2 * c + 1)].get(), c, nth});
        }
    }
    int64_t interval = restart ? restart : total;
    int64_t done = 0, pos = i;
    std::vector<uint8_t> seg;
    std::vector<int64_t> raw_end;
    while (done < total) {
        int64_t mcus = interval < total - done ? interval : total - done;
        int64_t marker;
        unstuff(data, n, pos, seg, raw_end, marker);
        std::unique_ptr<BitFill> fill;
        if (marker < 0) {
            fill.reset(new BitFill());
            fill->raw_end.reserve(raw_end.size());
            for (int64_t r : raw_end) fill->raw_end.push_back(r - pos);
            fill->raw_total = n - pos;
            fill->fast_ok = restart == 0;
        }
        bool short_;
        try {
            short_ = decode_interval(seg, fill.get(), blocks, mcus, done, 8, single, bx, yslot);
        } catch (IndexErr&) {  // ran far past a marker: more zero bits
            short_ = decode_interval(seg, fill.get(), blocks, mcus, done,
                                     2 * 64 * 4 * int64_t(blocks.size()), single, bx, yslot);
        }
        done += mcus;
        if (marker < 0) return n;
        pos = marker;
        if (done < total) {
            int code = data[marker + 1];
            if (0xD0 <= code && code <= 0xD7) {
                pos = marker + 2;  // the restart marker
            } else if (short_) {
                // libjpeg keeps its out-of-data flag against a marker that
                // is no restart: the rest of the scan stays zero
                return pos;
            }
        }
    }
    return pos;
}

inline int64_t wrap16(int64_t x) { return int16_t(uint16_t(uint64_t(x))); }

// One pass of jidctint.c's inverse DCT over d[0], d[s], ..., d[7 s] into
// o[0], o[so], ...; `last` descales to samples.
inline void idct_pass(const int64_t* d, int s, int64_t* o, int so, bool last) {
    int64_t z2 = d[2 * s], z3 = d[6 * s];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t t2 = z1 - z3 * F1847, t3 = z1 + z2 * F0765;
    int64_t t0 = (d[0] + d[4 * s]) * (int64_t(1) << CB), t1 = (d[0] - d[4 * s]) * (int64_t(1) << CB);
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    t0 = d[7 * s];
    t1 = d[5 * s];
    t2 = d[3 * s];
    t3 = d[s];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3;
    int64_t z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    int n = last ? CB + P1 + 3 : CB - P1;
    o[0] = descale(t10 + t3, n);
    o[so] = descale(t11 + t2, n);
    o[2 * so] = descale(t12 + t1, n);
    o[3 * so] = descale(t13 + t0, n);
    o[4 * so] = descale(t13 - t0, n);
    o[5 * so] = descale(t12 - t1, n);
    o[6 * so] = descale(t11 - t2, n);
    o[7 * so] = descale(t10 - t3, n);
}

// The luma samples, cropped to the frame: libjpeg-turbo's SIMD islow IDCT,
// jidctint.c's arithmetic on 16-bit lanes (coefficients and their
// dequantized products wrap to 16 bits, the first pass saturates to them,
// the samples saturate to [0, 255]). A luma plane that no scan named has
// no table latched: its multipliers stay zero, as in libjpeg.
void Decoder::render(uint8_t* out) const {
    const Comp& y = comps[0];
    int64_t q[64];
    for (int k = 0; k < 64; k++) q[k] = y.has_q ? y.q[k] : 0;
    const int64_t bw_used = (width + 7) / 8, bh_used = (height + 7) / 8;
    for (int64_t by = 0; by < bh_used; by++) {
        for (int64_t bxi = 0; bxi < bw_used; bxi++) {
            const int16_t* c = &coefs[size_t((by * ybw + bxi) * 64)];
            int64_t d[64], ws[64], px[64];
            for (int k = 0; k < 64; k++) d[k] = wrap16(int64_t(c[k]) * q[k]);
            for (int col = 0; col < 8; col++) idct_pass(d + col, 8, ws + col, 8, false);
            for (int k = 0; k < 64; k++) ws[k] = ws[k] < -32768 ? -32768 : (ws[k] > 32767 ? 32767 : ws[k]);
            for (int row = 0; row < 8; row++) idct_pass(ws + 8 * row, 1, px + 8 * row, 1, true);
            for (int r = 0; r < 8; r++) {
                int64_t yy = by * 8 + r;
                if (yy >= height) break;
                for (int x = 0; x < 8; x++) {
                    int64_t xx = bxi * 8 + x;
                    if (xx >= width) break;
                    int64_t v = px[8 * r + x] + 128;
                    out[yy * width + xx] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
                }
            }
        }
    }
}

void set_msg(char* msg, int64_t cap, const std::string& s) {
    if (cap <= 0) return;
    std::snprintf(msg, size_t(cap), "%s", s.c_str());
}

}  // namespace

extern "C" {

// A contiguous (h, w) uint8 image as baseline JPEG at `quality` (1-100, the
// caller clamps) into out[0:cap]. Returns the byte count, or -1 when cap is
// too small.
int64_t lpslam_jpeg_encode_gray(const uint8_t* img, int64_t h, int64_t w, int quality,
                                uint8_t* out, int64_t cap) {
    int q[64];
    int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
    for (int i = 0; i < 64; i++) {
        int v = (LUMA_QUANT[i] * scale + 50) / 100;
        q[i] = v < 1 ? 1 : (v > 255 ? 255 : v);
    }
    Out o{out, size_t(cap)};
    const uint8_t soi[2] = {0xFF, 0xD8};
    o.raw(soi, 2);
    const uint8_t app0[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    o.segment(0xE0, app0, 14);
    uint8_t dqt[65];
    dqt[0] = 0;
    for (int k = 0; k < 64; k++) dqt[1 + k] = uint8_t(q[ZIGZAG[k]]);
    o.segment(0xDB, dqt, 65);
    const uint8_t sof[9] = {8, uint8_t(h >> 8), uint8_t(h & 0xFF), uint8_t(w >> 8),
                            uint8_t(w & 0xFF), 1, 1, 0x11, 0};
    o.segment(0xC0, sof, 9);
    o.segment(0xC4, DHT_DC0, sizeof DHT_DC0);
    o.segment(0xC4, DHT_AC0, sizeof DHT_AC0);
    const uint8_t sos[6] = {1, 1, 0, 0, 0x3F, 0};
    o.segment(0xDA, sos, 6);
    if (o.overflow) return -1;

    static const Codes dc = canonical_codes(DHT_DC0);
    static const Codes ac = canonical_codes(DHT_AC0);
    BitWriter bw{out + o.n, size_t(cap) - o.n};
    const int64_t bh = (h + 7) / 8, bwn = (w + 7) / 8;
    int64_t prev_dc = 0;
    int64_t blk[64];
    int64_t zz[64];
    for (int64_t by = 0; by < bh; by++) {
        for (int64_t bx = 0; bx < bwn; bx++) {
            for (int r = 0; r < 8; r++) {
                int64_t yy = by * 8 + r;
                yy = yy < h ? yy : h - 1;  // edge replication
                const uint8_t* row = img + yy * w;
                for (int c = 0; c < 8; c++) {
                    int64_t xx = bx * 8 + c;
                    blk[8 * r + c] = int64_t(row[xx < w ? xx : w - 1]) - 128;
                }
            }
            for (int r = 0; r < 8; r++) fdct_pass(blk + 8 * r, 1, false);
            for (int c = 0; c < 8; c++) fdct_pass(blk + c, 8, true);
            for (int k = 0; k < 64; k++) {
                int64_t coef = blk[ZIGZAG[k]];
                int64_t qq = int64_t(q[ZIGZAG[k]]) << 3;
                int64_t mag = ((coef < 0 ? -coef : coef) + (qq >> 1)) / qq;
                zz[k] = coef < 0 ? -mag : mag;
            }
            int64_t diff = zz[0] - prev_dc;
            prev_dc = zz[0];
            int size = bit_length(diff);
            bw.put(dc.code[size], dc.len[size]);
            bw.put(extra_bits(diff, size), size);
            int run = 0;
            for (int k = 1; k < 64; k++) {
                if (zz[k] == 0) {
                    run++;
                    continue;
                }
                while (run > 15) {
                    bw.put(ac.code[0xF0], ac.len[0xF0]);
                    run -= 16;
                }
                int asize = bit_length(zz[k]);
                int sym = (run << 4) | asize;
                bw.put(ac.code[sym], ac.len[sym]);
                bw.put(extra_bits(zz[k], asize), asize);
                run = 0;
            }
            if (run > 0) bw.put(ac.code[0], ac.len[0]);
        }
    }
    bw.flush();
    if (bw.overflow) return -1;
    o.n += bw.n;
    const uint8_t eoi[2] = {0xFF, 0xD9};
    o.raw(eoi, 2);
    return o.overflow ? -1 : int64_t(o.n);
}

// JPEG bytes -> grey pixels. Returns 0 with *out (malloc'd; free with
// lpslam_jpeg_free), *h, *w and *orientation (EXIF, 1-8) set; 1 where the
// reference gives no image; 2 where it refuses the file (msg says why); 3
// when memory runs out.
int lpslam_jpeg_decode_gray(const uint8_t* data, int64_t n, uint8_t** out, int64_t* h,
                            int64_t* w, int* orientation, char* msg, int64_t msg_cap) {
    *out = nullptr;
    if (n < 3 || data[0] != 0xFF || data[1] != 0xD8 || data[2] != 0xFF) return 1;
    try {
        Decoder d(data, n);
        int o = d.run();
        uint8_t* img = static_cast<uint8_t*>(std::malloc(size_t(d.height * d.width)));
        if (!img) return 3;
        d.render(img);
        *out = img;
        *h = d.height;
        *w = d.width;
        *orientation = o;
        return 0;
    } catch (Corrupt&) {
        return 1;
    } catch (Suspended&) {
        return 1;
    } catch (IndexErr&) {
        return 1;
    } catch (Refused& r) {
        set_msg(msg, msg_cap, r.msg);
        return 2;
    } catch (std::bad_alloc&) {
        return 3;
    }
}

void lpslam_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
