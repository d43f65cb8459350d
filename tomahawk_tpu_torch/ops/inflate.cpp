// Calc's archive inflation: the .twk block payloads of one super-block
// decoded in one call straight into the load's stacked bit planes and
// metadata rows (ops/inflate.py binds it with ctypes, which releases the
// interpreter lock around the call, so a pool of threads decodes
// super-blocks in parallel).
//
// The result is bit for bit what ops/bitpack.py's block_to_planes gives
// for the merged block, padded to B rows, and stack_planes stacks:
// the five planes of uint32 words (bit k of word w is haplotype or
// sample 32w + k; the miss plane's bits past 2N are ones on every row),
// pos / rid / ac / an as int32 (two's-complement casts of the stored
// uint32), n_het / n_hom as popcounts of the built planes (not the
// stored fields, which keep the pre-flip counts of -f flipped sites),
// hwe rounded to float32, has_missing and valid as 0 / 1 bytes.
//
// Block payload: u32 n | u32 m | u32 rid | n records. Record: the 38-byte
// header (u8 pack, u8 alleles, u32 pos, ac, an, rid, n_het, n_hom,
// f64 hwe, u32 n_runs << 1 | miss) and n_runs words of 1, 2 or 4 bytes
// (pack >> 3), all little-endian (io/twk.py). A record without missing
// calls (pack & 1 == 0) writes only its alt plane from the runs; the
// other planes follow from it word by word. A record with missing calls
// takes the general per-run fills.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kHeader = 38;

// error codes (the Python side maps them to CorruptFileError)
constexpr int64_t kTruncated = -1, kWidth = -2, kOverflow = -3,
                  kShort = -4, kRows = -5, kShape = -6;

template <typename T>
inline T load(const uint8_t* p) {
    T v;
    std::memcpy(&v, p, sizeof v);
    return v;
}

template <int W>
inline uint32_t rle_word(const uint8_t* runs, int64_t i) {
    if (W == 1) return runs[i];
    if (W == 2) return load<uint16_t>(runs + 2 * i);
    return load<uint32_t>(runs + 4 * i);
}

// The even bits of x, packed into 32 bits (bit 2k -> bit k).
inline uint32_t even_bits(uint64_t x) {
    x &= 0x5555555555555555ull;
    x = (x | (x >> 1)) & 0x3333333333333333ull;
    x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
    x = (x | (x >> 16)) & 0x00000000FFFFFFFFull;
    return (uint32_t)x;
}

// Alt bits of a record without missing calls into `alt` (Wh / 2 zeroed
// 64-bit words): a 2-bit symbol (a << 1 | b) sets haplotype bits 2s
// (a) and 2s + 1 (b) of each sample s of its run. Returns the samples
// decoded, or kOverflow before a run past n would be written.
template <int W>
int64_t alt_runs(const uint8_t* runs, int64_t n_runs, int64_t n,
                 uint64_t* alt) {
    // the pattern of a symbol over a word: b on odd bits, a on even
    static const uint64_t kPat[4] = {0, 0xAAAAAAAAAAAAAAAAull,
                                     0x5555555555555555ull, ~0ull};
    int64_t s = 0;
    for (int64_t i = 0; i < n_runs; ++i) {
        const uint32_t w = rle_word<W>(runs, i);
        const int64_t run = w >> 2;
        if (run > n - s) return kOverflow;
        if (run) {
            const uint64_t p = kPat[w & 3u];
            const int64_t b0 = 2 * s, b1 = 2 * (s + run) - 1;
            int64_t w0 = b0 >> 6;
            const int64_t w1 = b1 >> 6;
            const uint64_t head = ~0ull << (b0 & 63);
            const uint64_t tail = ~0ull >> (63 - (b1 & 63));
            if (w0 == w1) {
                alt[w0] |= p & head & tail;
            } else {
                alt[w0] |= p & head;
                for (++w0; w0 < w1; ++w0) alt[w0] = p;
                alt[w1] |= p & tail;
            }
        }
        s += run;
    }
    return s;
}

// Bits [start, start + len) of a plane set to the 2-periodic pattern
// (bitA on even positions, bitB on odd), positions absolute.
void fill_pattern(uint32_t* plane, int64_t start, int64_t len, int bitA,
                  int bitB) {
    if (len <= 0 || (!bitA && !bitB)) return;
    const uint32_t pat = (bitA ? 0x55555555u : 0u) |
                         (bitB ? 0xAAAAAAAAu : 0u);
    const int64_t end = start + len;
    const int64_t w0 = start >> 5, w1 = (end - 1) >> 5;
    for (int64_t w = w0; w <= w1; ++w) {
        uint32_t mask = 0xFFFFFFFFu;
        if (w == w0) mask &= 0xFFFFFFFFu << (start & 31);
        if (w == w1) {
            const int64_t tail = end - (w << 5);
            if (tail < 32) mask &= (1u << tail) - 1u;
        }
        plane[w] |= pat & mask;
    }
}

// Bits [start, start + len) of a plane set to ones.
void fill_range(uint32_t* plane, int64_t start, int64_t len) {
    fill_pattern(plane, start, len, 1, 1);
}

// The general path: 4-bit symbols (codeA << 2 | codeB; 0 ref, 1 alt,
// 2 missing) into zeroed alt / het / hom / valid rows and a miss row
// that holds its padding ones.
template <int W>
int64_t all_runs(const uint8_t* runs, int64_t n_runs, int64_t n,
                 uint32_t* alt, uint32_t* miss, uint32_t* het,
                 uint32_t* hom, uint32_t* valid) {
    int64_t s = 0;
    for (int64_t i = 0; i < n_runs; ++i) {
        const uint32_t w = rle_word<W>(runs, i);
        const int64_t run = w >> 4;
        if (run > n - s) return kOverflow;
        const uint32_t ca = (w >> 2) & 3u, cb = w & 3u;
        if (ca != 2 && cb != 2) {
            fill_range(valid, s, run);
            const uint32_t sum = ca + cb;
            if (sum == 1) fill_range(het, s, run);
            else if (sum == 2) fill_range(hom, s, run);
        } else {
            fill_pattern(miss, 2 * s, 2 * run, ca == 2, cb == 2);
        }
        fill_pattern(alt, 2 * s, 2 * run, ca == 1, cb == 1);
        s += run;
    }
    return s;
}

inline int64_t popcount_row(const uint32_t* row, int64_t n_words) {
    int64_t c = 0;
    for (int64_t j = 0; j < n_words; ++j) c += __builtin_popcount(row[j]);
    return c;
}

struct Rows {
    uint32_t *alt, *miss, *het, *hom, *valid;
    int32_t *pos, *rid, *ac, *an, *n_het, *n_hom;
    float* hwe;
    uint8_t *has_missing, *valid_row;
};

}  // namespace

extern "C" {

// Decode super-block payloads[0..n_payloads) (lens[i] bytes each) into
// rows 0..B of `out`: 14 pointers, the super-block's [B, Wh] alt / miss,
// [B, Ws] het / hom / valid planes, then its [B] pos, rid, ac, an,
// n_het, n_hom (int32), hwe (float32), has_missing, valid (bytes).
// Every word and byte of the B rows is written, padding rows too.
// Returns the records decoded, or an error code below 0 with
// info = [records, runs, payload, record in payload, detail, rid, pos]
// (detail: the samples decoded, -1 on an overflowing run, or the bad
// word width). No write leaves a plane row.
int64_t twk_inflate_super(const uint8_t* const* payloads,
                          const int64_t* lens, int64_t n_payloads,
                          int64_t n_samples, int64_t B, int64_t Wh,
                          int64_t Ws, void* const* out, int64_t* info) {
    const int64_t n = n_samples;
    for (int k = 0; k < 7; ++k) info[k] = 0;
    if (n < 0 || B < 0 || Wh % 2 || Wh * 32 < 2 * n || Ws * 32 < n)
        return kShape;
    Rows o{(uint32_t*)out[0],  (uint32_t*)out[1], (uint32_t*)out[2],
           (uint32_t*)out[3],  (uint32_t*)out[4], (int32_t*)out[5],
           (int32_t*)out[6],   (int32_t*)out[7],  (int32_t*)out[8],
           (int32_t*)out[9],   (int32_t*)out[10], (float*)out[11],
           (uint8_t*)out[12],  (uint8_t*)out[13]};
    // the rows every record starts from: miss with its padding ones,
    // valid with ones over the n samples (records without missing calls)
    std::vector<uint32_t> miss0(Wh, 0u), valid0(Ws, 0u);
    for (int64_t b = 2 * n; b < Wh * 32; ++b) miss0[b >> 5] |= 1u << (b & 31);
    for (int64_t b = 0; b < n; ++b) valid0[b >> 5] |= 1u << (b & 31);
    std::vector<uint64_t> alt64(Wh / 2);
    const int64_t used = (n + 31) / 32;   // sample words with bits
    int64_t r = 0, runs_total = 0;

    for (int64_t p = 0; p < n_payloads; ++p) {
        const uint8_t* buf = payloads[p];
        const int64_t len = lens[p];
        info[2] = p;
        if (len < 12) return kTruncated;
        const uint32_t n_rec = load<uint32_t>(buf);
        int64_t off = 12;
        for (uint32_t i = 0; i < n_rec; ++i) {
            info[3] = i;
            if (len - off < kHeader) return kTruncated;
            const uint8_t* h = buf + off;
            const uint8_t pack = h[0];
            const int32_t pos = (int32_t)load<uint32_t>(h + 2);
            const int32_t rid = (int32_t)load<uint32_t>(h + 14);
            info[5] = rid;
            info[6] = pos;
            const int width = pack >> 3;
            if (width != 1 && width != 2 && width != 4) {
                info[4] = width;
                return kWidth;
            }
            const int64_t n_runs = load<uint32_t>(h + 34) >> 1;
            if ((len - off - kHeader) / width < n_runs) return kTruncated;
            if (r >= B) return kRows;
            const uint8_t* runs = h + kHeader;
            const bool missing = pack & 1u;
            uint32_t* alt = o.alt + r * Wh;
            uint32_t* miss = o.miss + r * Wh;
            uint32_t* het = o.het + r * Ws;
            uint32_t* hom = o.hom + r * Ws;
            uint32_t* valid = o.valid + r * Ws;
            std::memcpy(miss, miss0.data(), Wh * 4);
            int64_t got, nh = 0, nm = 0;
            if (!missing) {
                std::memset(alt64.data(), 0, Wh * 4);
                got = width == 1 ? alt_runs<1>(runs, n_runs, n, alt64.data())
                    : width == 2 ? alt_runs<2>(runs, n_runs, n, alt64.data())
                                 : alt_runs<4>(runs, n_runs, n, alt64.data());
                if (got == n) {
                    std::memcpy(alt, alt64.data(), Wh * 4);
                    std::memcpy(valid, valid0.data(), Ws * 4);
                    for (int64_t j = 0; j < used; ++j) {
                        const uint64_t x = alt64[j];
                        const uint32_t a = even_bits(x), b = even_bits(x >> 1);
                        het[j] = a ^ b;
                        hom[j] = a & b;
                        nh += __builtin_popcount(a ^ b);
                        nm += __builtin_popcount(a & b);
                    }
                    for (int64_t j = used; j < Ws; ++j) het[j] = hom[j] = 0;
                }
            } else {
                std::memset(alt, 0, Wh * 4);
                std::memset(het, 0, Ws * 4);
                std::memset(hom, 0, Ws * 4);
                std::memset(valid, 0, Ws * 4);
                got = width == 1 ? all_runs<1>(runs, n_runs, n, alt, miss, het,
                                               hom, valid)
                    : width == 2 ? all_runs<2>(runs, n_runs, n, alt, miss, het,
                                               hom, valid)
                                 : all_runs<4>(runs, n_runs, n, alt, miss, het,
                                               hom, valid);
                nh = popcount_row(het, Ws);
                nm = popcount_row(hom, Ws);
            }
            if (got != n) {
                info[4] = got == kOverflow ? -1 : got;
                return got == kOverflow ? kOverflow : kShort;
            }
            o.pos[r] = pos;
            o.rid[r] = rid;
            o.ac[r] = (int32_t)load<uint32_t>(h + 6);
            o.an[r] = (int32_t)load<uint32_t>(h + 10);
            o.n_het[r] = (int32_t)nh;
            o.n_hom[r] = (int32_t)nm;
            o.hwe[r] = (float)load<double>(h + 26);
            o.has_missing[r] = missing;
            o.valid_row[r] = 1;
            off += kHeader + n_runs * width;
            runs_total += n_runs;
            ++r;
            info[0] = r;
            info[1] = runs_total;
        }
    }
    for (; r < B; ++r) {
        std::memset(o.alt + r * Wh, 0, Wh * 4);
        std::memcpy(o.miss + r * Wh, miss0.data(), Wh * 4);
        std::memset(o.het + r * Ws, 0, Ws * 4);
        std::memset(o.hom + r * Ws, 0, Ws * 4);
        std::memset(o.valid + r * Ws, 0, Ws * 4);
        o.pos[r] = o.rid[r] = o.ac[r] = o.an[r] = 0;
        o.n_het[r] = o.n_hom[r] = 0;
        o.hwe[r] = 0.0f;
        o.has_missing[r] = o.valid_row[r] = 0;
    }
    return info[0];
}

}  // extern "C"
