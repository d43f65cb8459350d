// Native host-side runtime kernels for tomahawk_tpu.
//
// The TPU does the O(V^2) pair math; these C++ kernels cover the O(V*N)
// host paths that the reference implements natively (reference:
// lib/vcf_reader.h htslib parsing, lib/genotype_encoder.h RLE codec,
// lib/ld/ld_structs.cpp bit-plane inflation): VCF genotype-column
// parsing, RLE encode/decode, and direct codes -> bit-plane packing.
//
// Exposed as a plain C ABI consumed through ctypes.

#include <charconv>
#include <cmath>
#include <zlib.h>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// Parse the genotype columns of one VCF body line.
//
// `line`/`len`: the full tab-separated line (no trailing newline
// required). `gt_col`: index of the first sample column (9 for
// standard VCF). Writes one code byte per sample: (cA << 2) | cB with
// 0 = ref, 1 = alt (any non-ref allele), 2 = missing; and one phase
// byte (1 if '|'). Returns:
//   >= 0 : number of samples parsed
//   -1   : wrong sample count / truncated line
//   -2   : non-diploid or unparsable GT encountered
int64_t twk_parse_gt_line(const char* line, int64_t len, int32_t gt_col,
                          int32_t n_samples, uint8_t* codes,
                          uint8_t* phase) {
    int64_t pos = 0;
    int32_t col = 0;
    // skip to the first sample column
    while (col < gt_col && pos < len) {
        if (line[pos] == '\t') ++col;
        ++pos;
    }
    if (col != gt_col) return -1;

    for (int32_t s = 0; s < n_samples; ++s) {
        if (pos >= len) return -1;
        // allele A
        uint8_t ca;
        char c = line[pos];
        if (c == '.') { ca = 2; ++pos; }
        else if (c >= '0' && c <= '9') {
            int v = 0;
            while (pos < len && line[pos] >= '0' && line[pos] <= '9') {
                v = v * 10 + (line[pos] - '0');
                ++pos;
            }
            ca = v >= 1 ? 1 : 0;
        } else return -2;
        if (pos >= len) return -2;   // haploid at end
        char sep = line[pos];
        if (sep != '|' && sep != '/') return -2;  // haploid or malformed
        ++pos;
        uint8_t cb;
        c = pos < len ? line[pos] : '\0';
        if (c == '.') { cb = 2; ++pos; }
        else if (c >= '0' && c <= '9') {
            int v = 0;
            while (pos < len && line[pos] >= '0' && line[pos] <= '9') {
                v = v * 10 + (line[pos] - '0');
                ++pos;
            }
            cb = v >= 1 ? 1 : 0;
        } else return -2;
        // triploid+ check: another separator directly after allele B
        if (pos < len && (line[pos] == '|' || line[pos] == '/')) return -2;
        codes[s] = (uint8_t)((ca << 2) | cb);
        phase[s] = (uint8_t)(sep == '|');
        // skip any per-sample subfields up to next tab
        while (pos < len && line[pos] != '\t') ++pos;
        if (pos < len) ++pos;  // consume tab
    }
    return n_samples;
}

// RLE-decode genotype words into per-sample code bytes.
// width: word size in bytes (1/2/4); miss: 1 if 4-bit symbol space.
// Returns number of samples written, or -1 on overflow of out_cap.
int64_t twk_rle_decode(const void* words, int64_t n_words, int32_t width,
                       int32_t miss, uint8_t* out, int64_t out_cap) {
    const int shift = 2 + 2 * miss;
    const uint32_t sym_mask = (1u << shift) - 1u;
    int64_t n = 0;
    for (int64_t i = 0; i < n_words; ++i) {
        uint32_t w;
        switch (width) {
            case 1: w = ((const uint8_t*)words)[i]; break;
            case 2: w = ((const uint16_t*)words)[i]; break;
            default: w = ((const uint32_t*)words)[i]; break;
        }
        uint32_t run = w >> shift;
        uint8_t sym = (uint8_t)(w & sym_mask);
        if (!miss) sym = (uint8_t)(((sym & 2u) << 1) | (sym & 1u));
        if (n + (int64_t)run > out_cap) return -1;
        memset(out + n, sym, run);
        n += run;
    }
    return n;
}

// RLE-encode per-sample codes ((cA<<2)|cB). Chooses symbols in the
// 2-bit space when miss == 0. Returns the number of words written,
// or -1 on overflow. Words are written in the requested width.
int64_t twk_rle_encode(const uint8_t* codes, int64_t n, int32_t width,
                       int32_t miss, void* words_out, int64_t cap) {
    const int shift = 2 + 2 * miss;
    const uint64_t limit = (1ull << (8 * width - shift)) - 1ull;
    int64_t n_words = 0;

    auto emit = [&](uint32_t sym, uint64_t run) -> bool {
        while (run > 0) {
            uint64_t take = run > limit ? limit : run;
            if (n_words >= cap) return false;
            uint64_t w = (take << shift) | sym;
            switch (width) {
                case 1: ((uint8_t*)words_out)[n_words] = (uint8_t)w; break;
                case 2: ((uint16_t*)words_out)[n_words] = (uint16_t)w;
                        break;
                default: ((uint32_t*)words_out)[n_words] = (uint32_t)w;
                        break;
            }
            ++n_words;
            run -= take;
        }
        return true;
    };

    if (n == 0) return 0;
    auto sym_of = [&](uint8_t code) -> uint32_t {
        if (miss) return code;
        return ((code >> 2) << 1) | (code & 1u);
    };
    uint32_t cur = sym_of(codes[0]);
    uint64_t run = 1;
    for (int64_t i = 1; i < n; ++i) {
        uint32_t s = sym_of(codes[i]);
        if (s == cur) { ++run; continue; }
        if (!emit(cur, run)) return -1;
        cur = s;
        run = 1;
    }
    if (!emit(cur, run)) return -1;
    return n_words;
}

// Pack one variant's codes directly into the five bit planes used by
// the TPU kernels. Planes are uint32 words, little-endian bit order.
// alt/miss are haplotype-level (2N bits, interleaved A,B); het/hom/
// valid are sample-level (N bits). Word buffers must be zeroed by the
// caller (padding stays zero).
void twk_codes_to_planes(const uint8_t* codes, int64_t n_samples,
                         uint32_t* alt_bits, uint32_t* miss_bits,
                         uint32_t* het_bits, uint32_t* hom_bits,
                         uint32_t* valid_bits) {
    for (int64_t s = 0; s < n_samples; ++s) {
        const uint8_t code = codes[s];
        const uint8_t ca = code >> 2, cb = code & 3u;
        const int64_t ha = 2 * s, hb = 2 * s + 1;
        if (ca == 1) alt_bits[ha >> 5] |= 1u << (ha & 31);
        else if (ca == 2) miss_bits[ha >> 5] |= 1u << (ha & 31);
        if (cb == 1) alt_bits[hb >> 5] |= 1u << (hb & 31);
        else if (cb == 2) miss_bits[hb >> 5] |= 1u << (hb & 31);
        if (ca != 2 && cb != 2) {
            valid_bits[s >> 5] |= 1u << (s & 31);
            const int sum = ca + cb;
            if (sum == 1) het_bits[s >> 5] |= 1u << (s & 31);
            else if (sum == 2) hom_bits[s >> 5] |= 1u << (s & 31);
        }
    }
}

// Exact two-sided Hardy-Weinberg p-value per site (Wigginton et al.
// 2005 recurrence; same algorithm as the reference's per-site version,
// reference: lib/core.cpp:103-201 twk1_t::calculateHardyWeinberg).
// O(rare) per site with no transcendentals.
void twk_hwe_exact(const int64_t* n_het, const int64_t* n_hom1,
                   const int64_t* n_hom2, int64_t n_sites, double* out) {
    int64_t cap = 0;
    double* probs = nullptr;
    for (int64_t i = 0; i < n_sites; ++i) {
        const int64_t hets = n_het[i];
        const int64_t homc = n_hom1[i] > n_hom2[i] ? n_hom1[i] : n_hom2[i];
        const int64_t homr = n_hom1[i] > n_hom2[i] ? n_hom2[i] : n_hom1[i];
        const int64_t genot = hets + homc + homr;
        if (genot <= 0) { out[i] = 1.0; continue; }
        const int64_t rare = 2 * homr + hets;
        if (rare + 1 > cap) {
            delete[] probs;
            cap = rare + 1 < 1024 ? 1024 : rare + 1;
            probs = new double[cap];
        }
        // no zero-fill needed: the two recurrences below write every
        // parity-matched entry in [rare&1, rare], which is exactly the
        // stride the tail sum reads
        // start at the distribution mode (parity-matched)
        int64_t mid = rare * (2 * genot - rare) / (2 * genot);
        if (((mid ^ rare) & 1) != 0) ++mid;
        if (mid > rare) mid -= 2;
        if (mid < 0) mid = (rare & 1);
        probs[mid] = 1.0;
        double sum = 1.0;
        int64_t ch = mid, chomr = (rare - mid) / 2,
                chomc = genot - mid - chomr;
        // downward recurrence: h -> h - 2
        while (ch > 1) {
            probs[ch - 2] = probs[ch] * (double)ch * (double)(ch - 1)
                / (4.0 * (double)(chomr + 1) * (double)(chomc + 1));
            sum += probs[ch - 2];
            ch -= 2; ++chomr; ++chomc;
        }
        // upward recurrence: h -> h + 2
        ch = mid; chomr = (rare - mid) / 2; chomc = genot - mid - chomr;
        while (ch <= rare - 2) {
            probs[ch + 2] = probs[ch] * 4.0 * (double)chomr * (double)chomc
                / ((double)(ch + 2) * (double)(ch + 1));
            sum += probs[ch + 2];
            ch += 2; --chomr; --chomc;
        }
        const double p_obs = probs[hets];
        double tail = 0.0;
        for (int64_t h = rare & 1; h <= rare; h += 2)
            if (probs[h] <= p_obs) tail += probs[h];
        tail /= sum;
        out[i] = tail > 1.0 ? 1.0 : tail;
    }
    delete[] probs;
}

// Two-sided Fisher exact p per 2x2 table, O(support range) with
// incremental hypergeometric pmf updates (same tail semantics as the
// reference's kt_fisher_exact, lib/fisher_math.cpp:231-267: left tail
// accumulates while pmf < 0.99999999*q, includes the stopping point if
// pmf < 1.00000001*q; right tail mirrors; two = min(left+right, 1)).
static double twk_lbinom(double n, double k) {
    return lgamma(n + 1.0) - lgamma(k + 1.0) - lgamma(n - k + 1.0);
}

static double twk_fisher1(int64_t t11, int64_t t12, int64_t t21,
                          int64_t t22) {
    const int64_t N1i = t11 + t12;
    const int64_t M1i = t11 + t21;
    const int64_t Ni = t11 + t12 + t21 + t22;
    int64_t kmin = N1i + M1i - Ni;
    if (kmin < 0) kmin = 0;
    const int64_t kmax = N1i < M1i ? N1i : M1i;
    if (Ni <= 0 || kmax <= kmin) return 1.0;
    const double a = (double)t11;
    const double N1 = (double)N1i;
    const double M1 = (double)M1i;
    const double N = (double)Ni;
    const double lN = twk_lbinom(N, M1);
    const double q = exp(twk_lbinom(N1, a)
                         + twk_lbinom(N - N1, M1 - a) - lN);
    if (q <= 0.0) return 0.0;  // observed pmf underflow
    const double lo = 0.99999999 * q;
    const double hi = 1.00000001 * q;
    // pmf ratios: up(k) = pmf(k+1)/pmf(k), down(k) = pmf(k-1)/pmf(k)
    auto rup = [&](int64_t k) {
        return (N1 - (double)k) * (M1 - (double)k)
            / (((double)k + 1.0) * (N - N1 - M1 + (double)k + 1.0));
    };
    auto rdown = [&](int64_t k) {
        return ((double)k * (N - N1 - M1 + (double)k))
            / ((N1 - (double)k + 1.0) * (M1 - (double)k + 1.0));
    };
    // Both tail scans start at the OBSERVED cell and walk outward:
    // pmf(kmin)/pmf(kmax) underflow double precision for large
    // tables (which zeroed the whole inward scan), while terms
    // walking outward from pmf(n11)=q decay geometrically, so the
    // sums converge in O(hundreds) of steps independent of range.
    // Every k in [s_left, n11] has pmf >= lo (unimodality), so the
    // first k below n11 with pmf(k) < lo is the up-scan's stop.
    double left = 0.0;
    {
        double p = q;
        int64_t k = t11;
        while (k > kmin && p * rdown(k) >= lo) {
            p *= rdown(k);
            --k;
        }
        if (p < hi) left += p;      // boundary (stop) term
        // strict prefix below the stop, largest terms first
        double pp = p * rdown(k);
        --k;
        while (k >= kmin && pp > 0.0 && pp > left * 1e-18) {
            left += pp;
            pp *= rdown(k);
            --k;
        }
    }
    double right = 0.0;
    {
        double p = q;
        int64_t k = t11;
        while (k < kmax && p * rup(k) >= lo) {
            p *= rup(k);
            ++k;
        }
        if (p < hi) right += p;
        double pp = p * rup(k);
        ++k;
        while (k <= kmax && pp > 0.0 && pp > right * 1e-18) {
            right += pp;
            pp *= rup(k);
            ++k;
        }
    }
    const double two = left + right;
    return two > 1.0 ? 1.0 : two;
}

void twk_fisher_exact(const int64_t* n11, const int64_t* n12,
                      const int64_t* n21, const int64_t* n22,
                      int64_t n_tables, double* out) {
    for (int64_t t = 0; t < n_tables; ++t)
        out[t] = twk_fisher1(n11[t], n12[t], n21[t], n22[t]);
}

// Choose the cheapest RLE word width (1/2/4 bytes) for one variant's
// codes (reference: lib/genotype_encoder.h:138-195 AssessGenotypes).
int32_t twk_rle_assess(const uint8_t* codes, int64_t n, int32_t miss) {
    const int shift = 2 + 2 * miss;
    const uint64_t lim1 = (1ull << (8 - shift)) - 1ull;
    const uint64_t lim2 = (1ull << (16 - shift)) - 1ull;
    const uint64_t lim4 = (1ull << (32 - shift)) - 1ull;
    auto sym_of = [&](uint8_t code) -> uint32_t {
        if (miss) return code;
        return ((code >> 2) << 1) | (code & 1u);
    };
    uint64_t c1 = 0, c2 = 0, c4 = 0;
    if (n == 0) return 1;
    uint32_t cur = sym_of(codes[0]);
    uint64_t run = 1;
    // short runs dominate; avoid the 3 integer divisions per run
    // boundary in the common case
    auto account = [&](uint64_t r) {
        c1 += r <= lim1 ? 1 : (r + lim1 - 1) / lim1;
        c2 += r <= lim2 ? 1 : (r + lim2 - 1) / lim2;
        c4 += r <= lim4 ? 1 : (r + lim4 - 1) / lim4;
    };
    for (int64_t i = 1; i < n; ++i) {
        const uint32_t s = sym_of(codes[i]);
        if (s == cur) { ++run; continue; }
        account(run);
        cur = s; run = 1;
    }
    account(run);
    const uint64_t b1 = c1 * 1, b2 = c2 * 2, b4 = c4 * 4;
    if (b1 <= b2 && b1 <= b4) return 1;
    if (b2 <= b4) return 2;
    return 4;
}

// Set bits [start, start+len) of a uint32 little-endian bit plane to
// the 2-periodic pattern (bitA on even positions, bitB on odd),
// where positions are absolute bit indices.
static void twk_fill_pattern(uint32_t* plane, int64_t start, int64_t len,
                             int bitA, int bitB) {
    if (len <= 0 || (!bitA && !bitB)) return;
    const uint32_t even = 0x55555555u, odd = 0xAAAAAAAAu;
    const int64_t end = start + len;
    int64_t w0 = start >> 5, w1 = (end - 1) >> 5;
    for (int64_t w = w0; w <= w1; ++w) {
        // pattern phase: absolute bit (w*32) is even
        uint32_t pat = (bitA ? even : 0u) | (bitB ? odd : 0u);
        uint32_t mask = 0xFFFFFFFFu;
        if (w == w0) mask &= 0xFFFFFFFFu << (start & 31);
        if (w == w1) {
            const int64_t tail = end - (w << 5);
            if (tail < 32) mask &= (1u << tail) - 1u;
        }
        plane[w] |= pat & mask;
    }
}

// Set bits [start, start+len) of a plane (all ones).
static void twk_fill_range(uint32_t* plane, int64_t start, int64_t len) {
    if (len <= 0) return;
    const int64_t end = start + len;
    int64_t w0 = start >> 5, w1 = (end - 1) >> 5;
    for (int64_t w = w0; w <= w1; ++w) {
        uint32_t mask = 0xFFFFFFFFu;
        if (w == w0) mask &= 0xFFFFFFFFu << (start & 31);
        if (w == w1) {
            const int64_t tail = end - (w << 5);
            if (tail < 32) mask &= (1u << tail) - 1u;
        }
        plane[w] |= mask;
    }
}

// Decode RLE genotype runs STRAIGHT into the five bit planes, without
// materializing per-sample codes (the unpack hot path for calc loads;
// ref-ref runs -- the vast majority -- touch nothing except the valid
// plane). Word buffers must be zeroed by the caller except miss_bits,
// whose padding bits carry 1s. Returns samples decoded.
int64_t twk_runs_to_planes(const void* words, int64_t n_words,
                           int32_t width, int32_t miss,
                           uint32_t* alt_bits, uint32_t* miss_bits,
                           uint32_t* het_bits, uint32_t* hom_bits,
                           uint32_t* valid_bits, int64_t n_samples) {
    const int shift = 2 + 2 * miss;
    const uint32_t sym_mask = (1u << shift) - 1u;
    int64_t s = 0;
    for (int64_t i = 0; i < n_words; ++i) {
        uint32_t w;
        switch (width) {
            case 1: w = ((const uint8_t*)words)[i]; break;
            case 2: w = ((const uint16_t*)words)[i]; break;
            default: w = ((const uint32_t*)words)[i]; break;
        }
        const int64_t run = w >> shift;
        // corrupt/crafted run lengths must not write past the plane
        // rows (the numpy fallback raises on the same input); the
        // caller checks the returned sample count against n_samples
        if (run > n_samples - s) return -1;
        uint8_t sym = (uint8_t)(w & sym_mask);
        if (!miss) sym = (uint8_t)(((sym & 2u) << 1) | (sym & 1u));
        const uint8_t ca = sym >> 2, cb = sym & 3u;
        if (ca != 2 && cb != 2) {
            twk_fill_range(valid_bits, s, run);
            const int sum = ca + cb;
            if (sum == 1) twk_fill_range(het_bits, s, run);
            else if (sum == 2) twk_fill_range(hom_bits, s, run);
            twk_fill_pattern(alt_bits, 2 * s, 2 * run, ca == 1, cb == 1);
        } else {
            twk_fill_pattern(alt_bits, 2 * s, 2 * run, ca == 1, cb == 1);
            twk_fill_pattern(miss_bits, 2 * s, 2 * run, ca == 2, cb == 2);
        }
        s += run;
    }
    return s;
}

// Summary statistics of one variant's codes in a single pass.
// out layout: [n_refref, n_refalt, n_altref, n_altalt, n_missing_alleles,
//              n_alt_alleles, n_ref_alleles, n_full]
void twk_code_stats(const uint8_t* codes, int64_t n_samples,
                    int64_t* out) {
    int64_t rr = 0, ra = 0, ar = 0, aa = 0, miss = 0, alt = 0, ref = 0,
            full = 0;
    for (int64_t s = 0; s < n_samples; ++s) {
        const uint8_t ca = codes[s] >> 2, cb = codes[s] & 3u;
        miss += (ca == 2) + (cb == 2);
        alt += (ca == 1) + (cb == 1);
        ref += (ca == 0) + (cb == 0);
        if (ca != 2 && cb != 2) {
            ++full;
            rr += (ca == 0) & (cb == 0);
            ra += (ca == 0) & (cb == 1);
            ar += (ca == 1) & (cb == 0);
            aa += (ca == 1) & (cb == 1);
        }
    }
    out[0] = rr; out[1] = ra; out[2] = ar; out[3] = aa;
    out[4] = miss; out[5] = alt; out[6] = ref; out[7] = full;
}

// Fused per-site import step: parse the GT column blob, compute code
// stats, pick the RLE width, and encode -- one C call instead of four
// (ctypes call overhead dominates the per-site import cost otherwise).
// Returns n_words (>= 0), or the parse error (-1 count / -2 ploidy),
// or -3 on runs_cap overflow. meta_out = [width, phase_state, miss]
// with phase_state -1 = no called sample, 0/1 = uniform, 2 = mixed.
int64_t twk_encode_site(const char* blob, int64_t len, int32_t n_samples,
                        uint8_t* codes, uint8_t* phase,
                        int64_t* stats_out, int32_t* meta_out,
                        void* runs_out, int64_t runs_cap) {
    const int64_t r = twk_parse_gt_line(blob, len, 0, n_samples, codes,
                                        phase);
    if (r != n_samples) return r < 0 ? r : -1;
    twk_code_stats(codes, n_samples, stats_out);
    const int32_t miss = stats_out[4] > 0 ? 1 : 0;
    const int32_t width = twk_rle_assess(codes, n_samples, miss);
    const int64_t n_words = twk_rle_encode(codes, n_samples, width, miss,
                                           runs_out, runs_cap);
    if (n_words < 0) return -3;
    int32_t state = -1;
    for (int64_t s = 0; s < n_samples; ++s) {
        if ((codes[s] & 3u) == 2u) continue;
        const int32_t p = phase[s];
        if (state == -1) state = p;
        else if (state != p) { state = 2; break; }
    }
    meta_out[0] = width;
    meta_out[1] = state;
    meta_out[2] = miss;
    return n_words;
}

// Scan one BCF record (shared + indiv blocks) for the import fast
// path. Fills out[] = {rid, pos, n_allele, ref_byte, alt_byte,
// gt_offset, gt_width, n_sample}; ref/alt bytes are 0 for multi-char
// alleles (caller treats as non-SNP), gt_offset/width = -1 when no
// plain diploid int GT vector exists. Returns 0, or -1 when the
// typed-value walk hits something unsupported (caller falls back to
// the python parser).
static int64_t twk_bcf_desc(const uint8_t* buf, int64_t len, int64_t* off,
                            int32_t* type, int64_t* n) {
    if (*off >= len) return -1;
    const uint8_t b = buf[(*off)++];
    *type = b & 0x0F;
    *n = b >> 4;
    if (*n == 15) {
        int32_t t2; int64_t n2;
        if (twk_bcf_desc(buf, len, off, &t2, &n2) < 0) return -1;
        int64_t sz;
        switch (t2) { case 1: sz = 1; break; case 2: sz = 2; break;
                      case 3: sz = 4; break; default: return -1; }
        if (*off + sz * n2 > len || n2 < 1) return -1;
        int64_t v = 0;
        switch (t2) {
            case 1: v = *(const int8_t*)(buf + *off); break;
            case 2: { int16_t x; memcpy(&x, buf + *off, 2); v = x; break; }
            default: { int32_t x; memcpy(&x, buf + *off, 4); v = x; break; }
        }
        *off += sz * n2;
        *n = v;
    }
    return 0;
}

static int64_t twk_bcf_type_size(int32_t t) {
    switch (t) { case 0: return 0; case 1: return 1; case 2: return 2;
                 case 3: return 4; case 5: return 4; case 7: return 1; }
    return -1;
}

int32_t twk_bcf_scan(const uint8_t* shared, int64_t l_shared,
                     const uint8_t* indiv, int64_t l_indiv,
                     int64_t gt_key, int64_t* out) {
    if (l_shared < 24) return -1;
    int32_t rid, pos;
    memcpy(&rid, shared, 4);
    memcpy(&pos, shared + 4, 4);
    uint16_t n_allele;
    memcpy(&n_allele, shared + 18, 2);
    uint32_t ns4;
    memcpy(&ns4, shared + 20, 4);
    const int64_t n_sample = ns4 & 0xFFFFFF;
    const int32_t n_fmt = shared[23];
    out[0] = rid; out[1] = pos; out[2] = n_allele;
    out[3] = 0; out[4] = 0; out[5] = -1; out[6] = -1; out[7] = n_sample;

    int64_t off = 24;
    int32_t t; int64_t n;
    // ID string: skip
    if (twk_bcf_desc(shared, l_shared, &off, &t, &n) < 0) return -1;
    int64_t sz = twk_bcf_type_size(t);
    if (sz < 0 || off + sz * n > l_shared) return -1;
    off += sz * n;
    // alleles
    for (int64_t a = 0; a < n_allele && a < 2; ++a) {
        if (twk_bcf_desc(shared, l_shared, &off, &t, &n) < 0) return -1;
        if (t != 7) return -1;
        if (off + n > l_shared) return -1;
        if (n == 1) out[3 + a] = shared[off];
        off += n;
    }
    // indiv: find a plain diploid int GT vector
    int64_t io = 0;
    for (int32_t f = 0; f < n_fmt; ++f) {
        int32_t kt; int64_t kn;
        if (twk_bcf_desc(indiv, l_indiv, &io, &kt, &kn) < 0) return -1;
        int64_t ksz = twk_bcf_type_size(kt);
        if (ksz < 0 || kn < 1 || io + ksz > l_indiv) return -1;
        int64_t key = 0;
        switch (kt) {
            case 1: key = *(const int8_t*)(indiv + io); break;
            case 2: { int16_t x; memcpy(&x, indiv + io, 2); key = x;
                      break; }
            case 3: { int32_t x; memcpy(&x, indiv + io, 4); key = x;
                      break; }
            default: return -1;
        }
        io += ksz * kn;
        int32_t vt; int64_t per;
        if (twk_bcf_desc(indiv, l_indiv, &io, &vt, &per) < 0) return -1;
        const int64_t vsz = twk_bcf_type_size(vt);
        if (vsz < 0) return -1;
        const int64_t size = vsz * per * n_sample;
        if (io + size > l_indiv) return -1;
        if (key == gt_key) {
            if ((vt == 1 || vt == 2 || vt == 3) && per == 2) {
                out[5] = io;
                out[6] = vsz;
            }
            return 0;
        }
        io += size;
    }
    return 0;
}

// BCF GT value pairs -> tomahawk codes/phase. vals holds 2 ints per
// sample in the given byte width; value = (allele+1)<<1 | phased,
// 0/1 = missing. Returns 0, or -2 when a second slot holds the
// END_OF_VECTOR sentinel (haploid-in-diploid => non-diploid site).
}  // extern "C" (width-templated helper below needs C++ linkage)

// Per-width GT decode loop: keeping the width dispatch OUTSIDE the
// loop lets the compiler vectorize the common int8 case (the decode
// runs once per sample per site, the hottest BCF-parse inner loop).
template <class T>
static int32_t twk_bcf_gt_t(const T* v, int32_t n_samples,
                            uint8_t* codes, uint8_t* phase,
                            int64_t eov) {
    for (int64_t s = 0; s < n_samples; ++s) {
        const int64_t a = v[2 * s];
        const int64_t b = v[2 * s + 1];
        if (b == eov) return -2;   // haploid-in-diploid row
        const int64_t aa = (a >> 1) - 1;
        const int64_t ab = (b >> 1) - 1;
        const uint8_t ca = aa < 0 ? 2 : (aa > 1 ? 1 : (uint8_t)aa);
        const uint8_t cb = ab < 0 ? 2 : (ab > 1 ? 1 : (uint8_t)ab);
        codes[s] = (uint8_t)((ca << 2) | cb);
        phase[s] = (uint8_t)(b & 1);
    }
    return 0;
}

// width-1 fast path: one 64K LUT over the little-endian (a, b) byte
// pair yields code + phase + eov flag in a single indexed load; the
// genotype histogram folds into the same pass (the BCF bulk importer
// otherwise re-scans the codes for it).
struct TwkGtLut {
    uint8_t code[65536];
    uint8_t flag[65536];   // bit0 phase, bit1 eov-b
    TwkGtLut() {
        for (int b = 0; b < 256; ++b) {
            for (int a = 0; a < 256; ++a) {
                const int64_t sa = (int8_t)a, sb = (int8_t)b;
                const int64_t aa = (sa >> 1) - 1;
                const int64_t ab = (sb >> 1) - 1;
                const uint8_t ca = aa < 0 ? 2 : (aa > 1 ? 1 : (uint8_t)aa);
                const uint8_t cb = ab < 0 ? 2 : (ab > 1 ? 1 : (uint8_t)ab);
                const uint32_t idx = (uint32_t)a | ((uint32_t)b << 8);
                code[idx] = (uint8_t)((ca << 2) | cb);
                flag[idx] = (uint8_t)((sb & 1) | (sb == -127 ? 2 : 0));
            }
        }
    }
};

static int32_t twk_bcf_gt_w1(const uint8_t* v, int32_t n_samples,
                             uint8_t* codes, uint8_t* phase,
                             int64_t* hist) {
    static const TwkGtLut L;          // C++11 thread-safe init
    uint8_t bad = 0;
    for (int64_t s = 0; s < n_samples; ++s) {
        uint16_t pr;
        memcpy(&pr, v + 2 * s, 2);
        const uint8_t c = L.code[pr];
        const uint8_t f = L.flag[pr];
        codes[s] = c;
        phase[s] = (uint8_t)(f & 1);
        bad |= f;
        if (hist) ++hist[c & 15u];
    }
    return (bad & 2) ? -2 : 0;
}

extern "C" {

int32_t twk_bcf_gt_hist(const void* vals, int32_t width,
                        int32_t n_samples, uint8_t* codes,
                        uint8_t* phase, int64_t* hist) {
    int32_t r;
    switch (width) {
        case 1:
            return twk_bcf_gt_w1((const uint8_t*)vals, n_samples,
                                 codes, phase, hist);
        case 2:
            r = twk_bcf_gt_t((const int16_t*)vals, n_samples, codes,
                             phase, -32767);
            break;
        default:
            r = twk_bcf_gt_t((const int32_t*)vals, n_samples, codes,
                             phase, -2147483647LL);
            break;
    }
    if (r == 0 && hist)
        for (int32_t s = 0; s < n_samples; ++s)
            ++hist[codes[s] & 15u];
    return r;
}

int32_t twk_bcf_gt(const void* vals, int32_t width, int32_t n_samples,
                   uint8_t* codes, uint8_t* phase) {
    return twk_bcf_gt_hist(vals, width, n_samples, codes, phase,
                           nullptr);
}

// Same fusion for already-parsed codes (the BCF reader decodes GT
// vectors itself): stats + RLE width + encode + phase summary.
int64_t twk_encode_codes(const uint8_t* codes, const uint8_t* phase,
                         int32_t n_samples, int64_t* stats_out,
                         int32_t* meta_out, void* runs_out,
                         int64_t runs_cap) {
    twk_code_stats(codes, n_samples, stats_out);
    const int32_t miss = stats_out[4] > 0 ? 1 : 0;
    const int32_t width = twk_rle_assess(codes, n_samples, miss);
    const int64_t n_words = twk_rle_encode(codes, n_samples, width, miss,
                                           runs_out, runs_cap);
    if (n_words < 0) return -3;
    int32_t state = -1;
    for (int64_t s = 0; s < n_samples; ++s) {
        if ((codes[s] & 3u) == 2u) continue;
        const int32_t p = phase[s];
        if (state == -1) state = p;
        else if (state != p) { state = 2; break; }
    }
    meta_out[0] = width;
    meta_out[1] = state;
    meta_out[2] = miss;
    return n_words;
}

// ---------------------------------------------------------------------------
// Bulk VCF body import: parse every complete line of a text chunk in
// one call (the per-site ctypes round trip dominated import time).
// Combines the column walk, a fixed-stride fast path for the GT blob
// (4 bytes per diploid sample: allele, separator, allele, tab), code
// stats, RLE width selection and RLE encoding — the same fused step as
// twk_encode_site, amortized over a whole chunk. (Reference equivalent:
// htslib's threaded bcf_read + GenotypeEncoder, lib/importer.cpp:33.)
//
// Per-site meta layout (19 int64):
//   0 pos (0-based; -1 if the line is unusable)
//   1 chrom_off  2 chrom_len      (into buf)
//   3 status: 0 ok, 1 no GT FORMAT, 2 bad/non-diploid GT,
//             3 not biallelic, 4 not SNP, 5 malformed line
//   4 ref_char  5 alt_char
//   6 width  7 phase_state  8 miss  9 n_runs  10 runs_byte_off
//   11..18 stats[8] (refref, refalt, altref, altalt, n_missing,
//                    n_alt, n_ref, n_full)
// Returns the number of sites written; *consumed = bytes of complete
// processed lines (the caller re-feeds the remainder with more data).

static const int TWK_META_N = 19;

}  // templates below need C++ linkage
// Single-pass run walker: invokes f(symbol, length) per run without
// materializing a run list. Boundaries come from one cmpeq+movemask
// per 32 samples between codes[i] and codes[i+1], so dense short runs
// (common at 1000G-like MAF spectra: ~0.75 runs/sample) cost ~2 ops
// per boundary instead of an overlapping vector load per run.
template <class F>
static inline void twk_walk_runs(const uint8_t* codes, int64_t n,
                                 F&& f) {
    if (n <= 0) return;
    int64_t start = 0;
    int64_t i = 0;
#if defined(__AVX2__)
    while (i + 33 <= n) {
        const __m256i a = _mm256_loadu_si256(
            (const __m256i*)(codes + i));
        const __m256i b = _mm256_loadu_si256(
            (const __m256i*)(codes + i + 1));
        uint32_t neq = ~(uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(a, b));
        while (neq) {
            const int t = __builtin_ctz(neq);
            const int64_t end = i + t + 1;
            f(codes[start], end - start);
            start = end;
            neq &= neq - 1;
        }
        i += 32;
    }
#endif
    for (int64_t j = i; j < n - 1; ++j) {
        if (codes[j] != codes[j + 1]) {
            f(codes[start], j + 1 - start);
            start = j + 1;
        }
    }
    f(codes[start], n - start);
}

// Emit pass of the fused RLE encoder (word type fixed at compile time
// so the store is branch-free inside the run loop).
template <class W>
static inline int64_t twk_emit_runs(const uint8_t* codes, int64_t n,
                                    int shift, uint64_t limit,
                                    int miss, W* out) {
    int64_t w = 0;
    twk_walk_runs(codes, n, [&](uint8_t s, int64_t len) {
        const uint64_t sym = miss ? s : (((uint64_t)(s >> 2) << 1)
                                         | (s & 1u));
        uint64_t run = (uint64_t)len;
        while (run > 0) {
            const uint64_t take = run > limit ? limit : run;
            out[w++] = (W)((take << shift) | sym);
            run -= take;
        }
    });
    return w;
}
extern "C" {

// Shared per-site finish for the bulk importers: stats from the code
// histogram, RLE width from a SIMD run scan (predictable-branch loops
// over ~n_runs entries), RLE encode from the run list, and a
// branchless phase-uniformity sweep. Writes m[6..18] and advances
// *runs_off. Returns 0, or -1 when the runs buffer is out of space
// (caller re-feeds the site later).
static int twk_finish_site(const uint8_t* codes, const uint8_t* phase,
                           int32_t n_samples, const int64_t* hist,
                           int64_t* m,
                           uint8_t* runs_out, int64_t runs_cap,
                           int64_t* runs_off_p) {
    int64_t runs_off = *runs_off_p;
    {
        // stats from the histogram (same fields as twk_code_stats)
        int64_t missc = 0, altc = 0, refc = 0, fullc = 0;
        for (int c = 0; c < 16; ++c) {
            const int64_t ca = c >> 2, cb = c & 3;
            if (!hist[c]) continue;
            missc += hist[c] * ((ca == 2) + (cb == 2));
            altc += hist[c] * ((ca == 1) + (cb == 1));
            refc += hist[c] * ((ca == 0) + (cb == 0));
            if (ca != 2 && cb != 2) fullc += hist[c];
        }
        m[11] = hist[0]; m[12] = hist[1]; m[13] = hist[4];
        m[14] = hist[5];
        m[15] = missc; m[16] = altc; m[17] = refc; m[18] = fullc;
    }
    const int32_t miss = m[15] > 0 ? 1 : 0;

    // fused scan+assess: one boundary pass counts runs and the word
    // totals each width would need, with no run list materialized
    const int64_t lim1 = miss ? 15 : 63;
    const int64_t lim2 = miss ? 4095 : 16383;
    int64_t nr = 0, c1 = 0, c2 = 0;
    twk_walk_runs(codes, n_samples, [&](uint8_t, int64_t len) {
        ++nr;
        c1 += len > lim1 ? (len + lim1 - 1) / lim1 : 1;
        c2 += len > lim2 ? (len + lim2 - 1) / lim2 : 1;
    });
    const int64_t b1 = c1, b2 = 2 * c2, b4 = 4 * nr;
    const int32_t width = (b1 <= b2 && b1 <= b4) ? 1
                          : (b2 <= b4 ? 2 : 4);
    const int64_t want_words = width == 1 ? c1 : (width == 2 ? c2 : nr);

    runs_off = (runs_off + 3) & ~(int64_t)3;   // 4-byte aligned
    if (want_words > (runs_cap - runs_off) / width) return -1;
    const int shift = 2 + 2 * miss;
    const uint64_t limit = (1ull << (8 * width - shift)) - 1ull;
    void* wout = runs_out + runs_off;
    int64_t n_words;
    if (width == 1)
        n_words = twk_emit_runs(codes, n_samples, shift, limit, miss,
                                (uint8_t*)wout);
    else if (width == 2)
        n_words = twk_emit_runs(codes, n_samples, shift, limit, miss,
                                (uint16_t*)wout);
    else
        n_words = twk_emit_runs(codes, n_samples, shift, limit, miss,
                                (uint32_t*)wout);

    // phase uniformity without early exit (branchless sweep;
    // "called" matches twk_encode_codes: allele B not missing)
    uint32_t any_called = 0, all_phased = 1, any_phased = 0;
    for (int32_t s = 0; s < n_samples; ++s) {
        const uint32_t called = (codes[s] & 3u) != 2u;
        any_called |= called;
        any_phased |= called & phase[s];
        all_phased &= (~called | phase[s]) & 1u;
    }
    const int32_t state = !any_called ? -1
                          : (any_phased != all_phased ? 2
                             : (int32_t)any_phased);
    m[6] = width;
    m[7] = state;
    m[8] = miss;
    m[9] = n_words;
    m[10] = runs_off;
    *runs_off_p = runs_off + n_words * width;
    return 0;
}

extern "C" int64_t twk_import_chunk(
        const char* buf, int64_t size, int32_t n_samples,
        int64_t max_sites, int64_t* meta, uint8_t* runs_out,
        int64_t runs_cap, uint8_t* codes, uint8_t* phase,
        int64_t* consumed) {
    int64_t off = 0;
    int64_t n_sites = 0;
    int64_t runs_off = 0;
    const int64_t max_site_runs = ((int64_t)2 * n_samples + 16) * 4;
    *consumed = 0;
    while (off < size && n_sites < max_sites) {
        const char* nl = (const char*)memchr(buf + off, '\n', size - off);
        if (nl == nullptr) break;                  // partial line: stop
        const int64_t line_len = nl - (buf + off); // excl. newline
        if (runs_off + max_site_runs > runs_cap) break;
        const char* line = buf + off;
        int64_t* m = meta + n_sites * TWK_META_N;
        for (int k = 0; k < TWK_META_N; ++k) m[k] = 0;
        m[0] = -1;
        m[1] = off;   // line start (chrom offset), set even when malformed

        // column walk: offsets of the first 9 tabs
        int64_t tabs[9];
        int n_tabs = 0;
        for (int64_t i = 0; i < line_len && n_tabs < 9; ++i)
            if (line[i] == '\t') tabs[n_tabs++] = i;
        if (n_tabs < 8 || line_len == 0) {
            m[3] = 5;
            off += line_len + 1;
            ++n_sites;
            *consumed = off;
            continue;
        }
        // CHROM
        m[2] = tabs[0];
        // POS (1-based in the file)
        int64_t pos = 0;
        bool pos_ok = tabs[1] > tabs[0] + 1;
        for (int64_t i = tabs[0] + 1; i < tabs[1]; ++i) {
            if (line[i] < '0' || line[i] > '9') { pos_ok = false; break; }
            pos = pos * 10 + (line[i] - '0');
        }
        if (!pos_ok) {
            m[3] = 5;
            off += line_len + 1;
            ++n_sites;
            *consumed = off;
            continue;
        }
        m[0] = pos - 1;
        const int64_t ref_len = tabs[3] - tabs[2] - 1;
        const int64_t alt_len = tabs[4] - tabs[3] - 1;
        m[4] = ref_len > 0 ? (unsigned char)line[tabs[2] + 1] : 0;
        m[5] = alt_len > 0 ? (unsigned char)line[tabs[3] + 1] : 0;
        // FORMAT must be GT or GT:...
        const int64_t fmt_s = tabs[7] + 1;
        const int64_t fmt_e = n_tabs >= 9 ? tabs[8] : line_len;
        const bool has_gt = (fmt_e - fmt_s >= 2 && line[fmt_s] == 'G'
                             && line[fmt_s + 1] == 'T'
                             && (fmt_e - fmt_s == 2
                                 || line[fmt_s + 2] == ':'));
        if (!has_gt || n_tabs < 9) {
            m[3] = 1;
            off += line_len + 1;
            ++n_sites;
            *consumed = off;
            continue;
        }
        // biallelic: ALT must not contain a comma
        if (memchr(line + tabs[3] + 1, ',', alt_len) != nullptr) {
            m[3] = 3;
            off += line_len + 1;
            ++n_sites;
            *consumed = off;
            continue;
        }
        // SNP: single-base ACGT ref and alt
        auto acgt = [](char c) {
            return c == 'A' || c == 'C' || c == 'G' || c == 'T';
        };
        if (ref_len != 1 || alt_len != 1 || !acgt(line[tabs[2] + 1])
                || !acgt(line[tabs[3] + 1])) {
            m[3] = 4;
            off += line_len + 1;
            ++n_sites;
            *consumed = off;
            continue;
        }

        // GT blob
        const char* gt = line + tabs[8] + 1;
        const int64_t gt_len = line_len - tabs[8] - 1;
        bool parsed = false;
        // per-code histogram accumulated inside the parse loop: the
        // stats fields all derive from it, so the codes are only
        // re-walked by the width assessment and the RLE encode
        int64_t hist[16] = {0};
        if (gt_len == (int64_t)4 * n_samples - 1) {
            // fixed-stride fast path: each diploid sample is exactly
            // "a|b\t" (4 bytes); validity accumulates and is checked
            // once at the end.
            uint32_t ok = 1;
            int32_t s = 0;
#if defined(__AVX2__)
            // 8 samples per iteration: one 32-bit lane per sample
            // [a, sep, b, tab]; stop 8 samples early so the final
            // (3-byte) sample never makes the load run past the line.
            const __m256i v0 = _mm256_set1_epi8('0');
            const __m256i v1 = _mm256_set1_epi8('1');
            const __m256i vd = _mm256_set1_epi8('.');
            const __m256i vp = _mm256_set1_epi8('|');
            const __m256i vs = _mm256_set1_epi8('/');
            const __m256i vt = _mm256_set1_epi8('\t');
            const __m256i two = _mm256_set1_epi8(2);
            // byte roles per 32-bit lane (little-endian):
            // 0 = allele a, 1 = separator, 2 = allele b, 3 = tab
            const __m256i m_ab = _mm256_set1_epi32(0x00FF00FF);
            const __m256i m_sep = _mm256_set1_epi32(0x0000FF00);
            const __m256i m_tab = _mm256_set1_epi32((int)0xFF000000);
            const __m256i lane_pick = _mm256_setr_epi8(
                0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                -1, -1,
                0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                -1, -1);
            __m256i okv = _mm256_set1_epi8(-1);
            for (; s + 16 <= n_samples; s += 8) {
                __m256i x = _mm256_loadu_si256(
                    (const __m256i*)(gt + 4 * s));
                const __m256i isd = _mm256_cmpeq_epi8(x, vd);
                const __m256i allele_ok = _mm256_or_si256(
                    _mm256_or_si256(_mm256_cmpeq_epi8(x, v0),
                                    _mm256_cmpeq_epi8(x, v1)), isd);
                const __m256i isp = _mm256_cmpeq_epi8(x, vp);
                const __m256i sep_ok = _mm256_or_si256(
                    isp, _mm256_cmpeq_epi8(x, vs));
                const __m256i tab_ok = _mm256_cmpeq_epi8(x, vt);
                const __m256i want = _mm256_or_si256(
                    _mm256_or_si256(_mm256_and_si256(m_ab, allele_ok),
                                    _mm256_and_si256(m_sep, sep_ok)),
                    _mm256_and_si256(m_tab, tab_ok));
                okv = _mm256_and_si256(okv, want);
                // code bytes: '.'-aware value = (c=='.') ? 2 : c-'0'
                const __m256i val = _mm256_blendv_epi8(
                    _mm256_sub_epi8(x, v0), two, isd);
                // per-lane: code = (a << 2) | b
                const __m256i a32 = _mm256_and_si256(
                    val, _mm256_set1_epi32(0xFF));
                const __m256i b32 = _mm256_and_si256(
                    _mm256_srli_epi32(val, 16), _mm256_set1_epi32(0xFF));
                const __m256i code32 = _mm256_or_si256(
                    _mm256_slli_epi32(a32, 2), b32);
                // per-lane phase: 1 iff separator is '|'
                const __m256i ph32 = _mm256_and_si256(
                    _mm256_srli_epi32(isp, 8), _mm256_set1_epi32(1));
                // pack the 8 lane low bytes to 8 contiguous bytes
                const __m256i cp = _mm256_shuffle_epi8(code32, lane_pick);
                const __m256i pp = _mm256_shuffle_epi8(ph32, lane_pick);
                const uint32_t clo = (uint32_t)_mm256_extract_epi32(cp, 0);
                const uint32_t chi = (uint32_t)_mm256_extract_epi32(cp, 4);
                const uint32_t plo = (uint32_t)_mm256_extract_epi32(pp, 0);
                const uint32_t phi = (uint32_t)_mm256_extract_epi32(pp, 4);
                memcpy(codes + s, &clo, 4);
                memcpy(codes + s + 4, &chi, 4);
                memcpy(phase + s, &plo, 4);
                memcpy(phase + s + 4, &phi, 4);
            }
            ok &= (uint32_t)(_mm256_movemask_epi8(okv) == -1);
#endif
            for (; s < n_samples; ++s) {
                uint32_t a, sep, b;
                if (s + 1 < n_samples) {
                    uint32_t x;
                    memcpy(&x, gt + 4 * s, 4);
                    a = x & 0xFF;
                    sep = (x >> 8) & 0xFF;
                    b = (x >> 16) & 0xFF;
                    ok &= (x >> 24) == '\t';
                } else {
                    a = (uint8_t)gt[4 * s];
                    sep = (uint8_t)gt[4 * s + 1];
                    b = (uint8_t)gt[4 * s + 2];
                }
                ok &= ((a == '0') | (a == '1') | (a == '.'))
                    & ((b == '0') | (b == '1') | (b == '.'))
                    & ((sep == '|') | (sep == '/'));
                const uint32_t ca = a == '.' ? 2u : (a - '0');
                const uint32_t cb = b == '.' ? 2u : (b - '0');
                codes[s] = (uint8_t)((ca << 2) | cb);
                phase[s] = (uint8_t)(sep == '|');
            }
            if (ok) {
                for (int32_t q = 0; q < n_samples; ++q)
                    ++hist[codes[q] & 15u];
            }
            parsed = ok != 0;
        }
        if (!parsed) {
            const int64_t r = twk_parse_gt_line(gt, gt_len, 0, n_samples,
                                                codes, phase);
            if (r != n_samples) {
                m[3] = 2;
                off += line_len + 1;
                ++n_sites;
                *consumed = off;
                continue;
            }
            memset(hist, 0, sizeof(hist));
            for (int32_t s = 0; s < n_samples; ++s) ++hist[codes[s] & 15u];
        }

        if (twk_finish_site(codes, phase, n_samples, hist,
                            m, runs_out, runs_cap, &runs_off) < 0)
            break;   // no runs space: re-feed this line later
        off += line_len + 1;
        ++n_sites;
        *consumed = off;
    }
    return n_sites;
}

// Bulk BCF body import: the binary-record twin of twk_import_chunk.
// Walks (l_shared, l_indiv)-framed records in a decompressed chunk,
// scans each with the twk_bcf_scan walk, converts the diploid GT
// vector, and runs the shared stats/width/RLE finish. Meta layout as
// twk_import_chunk except m[1] = rid directly and m[2] = -1 (no chrom
// string); for fallback statuses m[1] = the record's byte offset and
// m[2] = its total length so the caller can re-feed those bytes
// through the exact single-record path.
extern "C" int64_t twk_bcf_import_chunk(
        const uint8_t* buf, int64_t size, int32_t n_samples,
        int64_t gt_key, int64_t max_sites, int64_t* meta,
        uint8_t* runs_out, int64_t runs_cap, uint8_t* codes,
        uint8_t* phase, int64_t* consumed) {
    int64_t off = 0;
    int64_t n_sites = 0;
    int64_t runs_off = 0;
    const int64_t max_site_runs = ((int64_t)2 * n_samples + 16) * 4;
    *consumed = 0;
    int64_t scan[8];
    while (off + 8 <= size && n_sites < max_sites) {
        uint32_t l_shared, l_indiv;
        memcpy(&l_shared, buf + off, 4);
        memcpy(&l_indiv, buf + off + 4, 4);
        const int64_t rec_len = 8 + (int64_t)l_shared + l_indiv;
        if (off + rec_len > size) break;           // partial record
        if (runs_off + max_site_runs > runs_cap) break;
        const uint8_t* shared = buf + off + 8;
        const uint8_t* indiv = shared + l_shared;
        int64_t* m = meta + n_sites * TWK_META_N;
        for (int k = 0; k < TWK_META_N; ++k) m[k] = 0;
        m[0] = -1;
        m[1] = off;
        m[2] = -rec_len;   // negative length marks "raw record bytes"

        const int32_t r = twk_bcf_scan(shared, l_shared, indiv, l_indiv,
                                       gt_key, scan);
        if (r < 0) {
            m[3] = 5;                  // unsupported layout: fall back
            off += rec_len;
            ++n_sites;
            *consumed = off;
            continue;
        }
        m[0] = scan[1];
        m[4] = scan[3];
        m[5] = scan[4];
        auto acgt = [](int64_t c) {
            return c == 'A' || c == 'C' || c == 'G' || c == 'T';
        };
        int status = 0;
        if (scan[7] != n_samples) status = 5;      // sample-count odd
        else if (scan[2] != 2) status = 3;         // not biallelic
        else if (!acgt(scan[3]) || !acgt(scan[4])) status = 4;
        else if (scan[5] < 0) status = 5;          // no plain GT vector
        if (status == 3 || status == 4) {
            m[1] = scan[0];                        // rid for dup filter
            m[2] = -1;
        }
        if (status) {
            m[3] = status;
            off += rec_len;
            ++n_sites;
            *consumed = off;
            continue;
        }
        const int32_t vw = (int32_t)scan[6];
        int64_t hist[16] = {0};
        if (twk_bcf_gt_hist(indiv + scan[5], vw, n_samples, codes,
                            phase, hist) != 0) {
            // haploid-in-diploid: keep the raw-record form so the
            // caller's exact fallback can classify it
            m[3] = 2;
            off += rec_len;
            ++n_sites;
            *consumed = off;
            continue;
        }
        m[1] = scan[0];
        m[2] = -2 - off;   // <= -2 encodes the record's byte offset
        if (twk_finish_site(codes, phase, n_samples, hist,
                            m, runs_out, runs_cap, &runs_off) < 0)
            break;
        off += rec_len;
        ++n_sites;
        *consumed = off;
    }
    return n_sites;
}

// ---------------------------------------------------------------------------
// Permutation sort of .two sort keys: LSD radix over (k1:u64, k2:u32)
// with constant byte planes skipped (positions rarely use the high
// bytes). Replaces np.lexsort in the external sorter's phase 1 / merge
// batches (reference sorts records with std::sort,
// two_sorter_structs.cpp:38-160; this sorts a permutation instead so
// the 106-byte records move once, via a numpy gather).

extern "C" int64_t twk_radix_sort_idx(const uint64_t* k1,
                                      const uint32_t* k2, int64_t n,
                                      int64_t* idx, int64_t* tmp) {
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    if (n < 2) return 0;
    int64_t count[256];
    int64_t offs[256];
    int n_passes = 0;
    int64_t* src = idx;
    int64_t* dst = tmp;
    // passes from least-significant: k2 bytes 0..3, then k1 bytes 0..7
    for (int pass = 0; pass < 12; ++pass) {
        const int shift = (pass < 4) ? 8 * pass : 8 * (pass - 4);
        const bool use_k2 = pass < 4;
        memset(count, 0, sizeof(count));
        if (use_k2) {
            for (int64_t i = 0; i < n; ++i)
                ++count[(k2[i] >> shift) & 0xFF];
        } else {
            for (int64_t i = 0; i < n; ++i)
                ++count[(k1[i] >> shift) & 0xFF];
        }
        bool trivial = false;
        for (int b = 0; b < 256; ++b)
            if (count[b] == n) { trivial = true; break; }
        if (trivial) continue;
        int64_t off = 0;
        for (int b = 0; b < 256; ++b) { offs[b] = off; off += count[b]; }
        if (use_k2) {
            for (int64_t i = 0; i < n; ++i) {
                const int64_t j = src[i];
                dst[offs[(k2[j] >> shift) & 0xFF]++] = j;
            }
        } else {
            for (int64_t i = 0; i < n; ++i) {
                const int64_t j = src[i];
                dst[offs[(k1[j] >> shift) & 0xFF]++] = j;
            }
        }
        int64_t* t = src; src = dst; dst = t;
        ++n_passes;
    }
    if (src != idx) memcpy(idx, src, (size_t)n * sizeof(int64_t));
    return n_passes;
}

// ---------------------------------------------------------------------------
// LD record text formatting (the hot loop of `view`; the reference
// streams records through C++ ostreams, core.cpp:520-532 PrintLD /
// PrintLDJson). Floats print as %.6g (ostream default precision) via
// std::to_chars.

static inline char* fmt_u64(char* p, uint64_t v) {
    char tmp[20];
    int k = 0;
    do { tmp[k++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

static inline char* fmt_g6(char* p, double v) {
    // integral fast path: haplotype counts (4 of 11 float columns) are
    // whole numbers; below 1e6 the %.6g rendering is the plain integer
    // range guards FIRST: casting a non-finite/out-of-range double to
    // int64 is UB, so it must only run once v is known to be in range
    if (v >= 0 && v < 1e6 && v == (double)(int64_t)v) {
        return fmt_u64(p, (uint64_t)v);
    }
    auto r = std::to_chars(p, p + 64, v, std::chars_format::general, 6);
    return r.ptr;
}

extern "C" int64_t twk_format_ld(
        int64_t n, const uint16_t* controller,
        const uint32_t* ridA, const uint32_t* ridB,
        const uint32_t* posA, const uint32_t* posB,
        const double* cnt,                      /* [n*4] */
        const double* D, const double* Dprime, const double* R,
        const double* R2, const double* P, const double* csf,
        const double* csm,
        const char* names, const int64_t* name_off, int64_t n_contigs,
        int32_t json, char* out, int64_t out_cap, int64_t* rows_done) {
    char* p = out;
    char* const end = out + out_cap;
    int64_t i = 0;
    for (; i < n; ++i) {
        // worst case per row: 16 fields x ~24 chars + 2 contig names
        int64_t max_name = 0;
        if ((int64_t)ridA[i] < n_contigs)
            max_name += name_off[ridA[i] + 1] - name_off[ridA[i]];
        else max_name += 20;
        if ((int64_t)ridB[i] < n_contigs)
            max_name += name_off[ridB[i] + 1] - name_off[ridB[i]];
        else max_name += 20;
        if (end - p < 420 + max_name) break;
        const char sep = json ? ',' : '\t';
        if (json) *p++ = '[';
        p = fmt_u64(p, controller[i]);
        *p++ = sep;
        if (!json && (int64_t)ridA[i] < n_contigs) {
            const int64_t o = name_off[ridA[i]];
            const int64_t len = name_off[ridA[i] + 1] - o;
            memcpy(p, names + o, len); p += len;
        } else {
            p = fmt_u64(p, ridA[i]);
        }
        *p++ = sep;
        p = fmt_u64(p, posA[i]);
        *p++ = sep;
        if (!json && (int64_t)ridB[i] < n_contigs) {
            const int64_t o = name_off[ridB[i]];
            const int64_t len = name_off[ridB[i] + 1] - o;
            memcpy(p, names + o, len); p += len;
        } else {
            p = fmt_u64(p, ridB[i]);
        }
        *p++ = sep;
        p = fmt_u64(p, posB[i]);
        *p++ = sep;
        for (int c = 0; c < 4; ++c) {
            p = fmt_g6(p, cnt[4 * i + c]);
            *p++ = sep;
        }
        p = fmt_g6(p, D[i]);      *p++ = sep;
        p = fmt_g6(p, Dprime[i]); *p++ = sep;
        p = fmt_g6(p, R[i]);      *p++ = sep;
        p = fmt_g6(p, R2[i]);     *p++ = sep;
        p = fmt_g6(p, P[i]);      *p++ = sep;
        p = fmt_g6(p, csf[i]);    *p++ = sep;
        p = fmt_g6(p, csm[i]);
        if (json) *p++ = ']';
        *p++ = '\n';
    }
    *rows_done = i;
    return p - out;
}

// %.6g TSV rendering of an [R, C] f64 matrix (kinship / IBS output,
// reference lib/relationship.h prints cell-by-cell via ostream).
// Returns bytes written, or -1 if out_cap is insufficient.
int64_t twk_format_g6_matrix(const double* m, int64_t R, int64_t C,
                             uint8_t* out, int64_t out_cap) {
    char* p = (char*)out;
    char* const end = (char*)out + out_cap;
    for (int64_t i = 0; i < R; ++i) {
        const double* row = m + i * C;
        for (int64_t j = 0; j < C; ++j) {
            if (p + 80 > end) return -1;
            p = fmt_g6(p, row[j]);
            *p++ = (j + 1 == C) ? '\n' : '\t';
        }
    }
    return p - (char*)out;
}

// Positional-decay row rendering: "rid\tpos\tn\tmean(%.6f)\n" per
// row (the reference prints these cell-by-cell via ostream,
// lib/two_reader.cpp:477-541).  Returns bytes or -1 on overflow.
int64_t twk_format_decay(const int64_t* rid, const int64_t* pos,
                         const int64_t* n, const double* mean,
                         int64_t rows, uint8_t* out, int64_t out_cap) {
    char* p = (char*)out;
    char* const end = (char*)out + out_cap;
    for (int64_t i = 0; i < rows; ++i) {
        if (p + 96 > end) return -1;
        p = fmt_u64(p, (uint64_t)rid[i]); *p++ = '\t';
        p = fmt_u64(p, (uint64_t)pos[i]); *p++ = '\t';
        p = fmt_u64(p, (uint64_t)n[i]);   *p++ = '\t';
        auto r = std::to_chars(p, p + 64, mean[i],
                               std::chars_format::fixed, 6);
        p = r.ptr;
        *p++ = '\n';
    }
    return p - (char*)out;
}

// Permutation gather of fixed-size rows: out[k] = base[idx[k]].  The
// external sort permutes 106-byte .two records by the sort order;
// numpy's fancy indexing on structured dtypes walks field descriptors
// per element, while this is a straight memcpy per row (memory-bound).
int64_t twk_gather_rows(const uint8_t* base, int64_t itemsize,
                        const int64_t* idx, int64_t n, uint8_t* out) {
    if (itemsize == 106) {        // .two record fast path
        for (int64_t k = 0; k < n; ++k)
            memcpy(out + k * 106, base + idx[k] * 106, 106);
    } else {
        for (int64_t k = 0; k < n; ++k)
            memcpy(out + k * itemsize, base + idx[k] * itemsize,
                   (size_t)itemsize);
    }
    return n;
}

// Serialize kept import records straight from the bulk-import meta
// matrix into .twk block payload bytes: 38-byte little-endian header
// (pack, alleles, pos, ac, an, rid, n_het, n_hom, hwe, n_runs-word)
// followed by the RLE words copied from the parse-time runs buffer.
// Replaces the per-site Python record construction + struct packing
// that dominated import wall time (the analogue of the reference's
// twk1_t serialization in its block flush, importer.cpp:227-260).
// `rows` selects kept meta rows; `rids`/`hwe` run parallel to `rows`.
// Returns bytes written, or -1 if `out_cap` would be exceeded.
int64_t twk_pack_records(const int64_t* meta, const int64_t* rows,
                         int64_t n, const int64_t* rids,
                         const double* hwe, const uint8_t* runs_buf,
                         uint8_t* out, int64_t out_cap) {
    // matches io/constants.py BASE_MAP (unknown bases encode as 0)
    uint8_t base[256] = {0};
    base['A'] = 0; base['T'] = 1; base['G'] = 2; base['C'] = 3;
    base['N'] = 4;
    uint8_t* p = out;
    uint8_t* const end = out + out_cap;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t* m = meta + rows[k] * TWK_META_N;
        const int64_t nw = m[9];
        const int32_t width = (int32_t)m[6];
        const int64_t nbytes = 38 + nw * width;
        if (p + nbytes > end) return -1;
        const uint8_t miss = m[8] ? 1 : 0;
        p[0] = (uint8_t)(((uint32_t)width << 3)
                         | ((m[7] == 1 ? 1u : 0u) << 1) | miss);
        p[1] = (uint8_t)((base[(uint8_t)m[4]] << 4)
                         | base[(uint8_t)m[5]]);
        uint32_t u;
        u = (uint32_t)m[0];  memcpy(p + 2, &u, 4);          // pos
        u = (uint32_t)m[16]; memcpy(p + 6, &u, 4);          // ac
        u = (uint32_t)m[15]; memcpy(p + 10, &u, 4);         // an
        u = (uint32_t)rids[k]; memcpy(p + 14, &u, 4);       // rid
        u = (uint32_t)(m[12] + m[13]); memcpy(p + 18, &u, 4);  // n_het
        u = (uint32_t)m[14]; memcpy(p + 22, &u, 4);         // n_hom
        memcpy(p + 26, hwe + k, 8);                         // hwe
        u = (uint32_t)((nw << 1) | miss); memcpy(p + 34, &u, 4);
        memcpy(p + 38, runs_buf + m[10], (size_t)(nw * width));
        p += nbytes;
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// Batched unphased cubic-EM solver: per-table root finding, biological
// admissibility, chi-square root scoring and the reference's flag
// semantics, mirroring ops/ld_math.solve_unphased_f11 op-for-op
// (reference: lib/ld/ld_engine.cpp:1363-1558 case analysis; degenerate
// yN2 == h2 branch never sets MultipleRoots, :1523-1558). Compiled
// with fp contraction off so FMA fusion cannot flip the discriminant
// sign against the numpy fallback.
#pragma GCC push_options
#pragma GCC optimize ("fp-contract=off")
static double twk_em_chi(const int64_t* t, double n, double f11,
                         double p, double q) {
    const double f12 = p - f11;
    const double f21 = q - f11;
    const double f22 = 1.0 - (f11 + f12 + f21);
    const double e[9] = {
        n * (f11 * f11),
        ((2.0 * n) * f11) * f12,
        n * (f12 * f12),
        ((2.0 * n) * f11) * f21,
        ((2.0 * n) * f12) * f21 + ((2.0 * n) * f11) * f22,
        ((2.0 * n) * f12) * f22,
        n * (f21 * f21),
        ((2.0 * n) * f21) * f22,
        n * (f22 * f22),
    };
    // observed cells accumulate in the reference's 1111..2222 order,
    // which is the table's own row-major order
    double chi = 0.0;
    for (int i = 0; i < 9; ++i) {
        if (e[i] > 0) {
            const double d = (double)t[i] - e[i];
            chi += (d * d) / e[i];
        }
    }
    return chi;
}

// One table's EM root solve; shared by twk_unphased_em (the batched
// export) and the fused twk_unphased_records pipeline below.
static void twk_em_row(const int64_t* t,
                       double* f11_out, double* p_out, double* q_out,
                       double* n_out, uint8_t* valid_out,
                       uint8_t* multiple_out, double* chi_out) {
    const double EPS = 1e-5;   // TWK_ALLOWED_ROUNDING_ERROR
    const double PI = 3.14159265358979323846;
    {
        double n = 0.0;
        for (int i = 0; i < 9; ++i) n += (double)t[i];
        const double ns = n > 0 ? n : 1.0;
        const double row0 = (double)(t[0] + t[1] + t[2]);
        const double row1 = (double)(t[3] + t[4] + t[5]);
        const double col0 = (double)(t[0] + t[3] + t[6]);
        const double col1 = (double)(t[1] + t[4] + t[7]);
        const double p = (2.0 * row0 + row1) / (2.0 * ns);
        const double q = (2.0 * col0 + col1) / (2.0 * ns);
        const double n11 = 2.0 * (double)t[0] + (double)t[1] + (double)t[3];
        const double ndh = (double)t[4];
        const double minhap = n11 / (2.0 * ns);
        const double maxhap = (n11 + ndh) / (2.0 * ns);
        const double a = 4.0 * n;
        const double b = 2.0 * n * (1.0 - 2.0 * p - 2.0 * q)
            - 2.0 * n11 - ndh;
        const double c = -n11 * (1.0 - 2.0 * p - 2.0 * q)
            - ndh * (1.0 - p - q) + 2.0 * n * p * q;
        const double dee = -(n11 * p) * q;
        const double a_s = a != 0.0 ? a : 1.0;
        // numpy's fast scalar-power path only covers exponent 2, so
        // `x ** 3` is libm pow(x, 3.0) there; match it exactly or the
        // discriminant sign flips at knife edges vs the fallback
        const double xN = -b / (3.0 * a_s);
        const double d2 = (b * b - 3.0 * a_s * c) / (9.0 * (a_s * a_s));
        const double yN = a * pow(xN, 3.0) + b * (xN * xN)
            + c * xN + dee;
        const double yN2 = yN * yN;
        const double h2 = 4.0 * (a * a) * pow(d2, 3.0);
        const double diff = yN2 - h2;

        double roots[3];
        roots[0] = roots[1] = roots[2] = NAN;
        bool case3 = false;
        if (diff < 0) {            // three real roots
            const double h = sqrt(h2);
            const double arg = h != 0.0 ? -yN / h : -yN;
            // no clamp: acos(|arg| > 1) = NaN roots -> pair dropped,
            // exactly like the reference (ld_engine.cpp:1444)
            const double theta = acos(arg) / 3.0;
            const double delta = sqrt(d2 > 0.0 ? d2 : 0.0);
            roots[0] = xN + (2.0 * delta) * cos(theta);
            roots[1] = xN + (2.0 * delta) * cos(2.0 * PI / 3.0 + theta);
            roots[2] = xN + (2.0 * delta) * cos(4.0 * PI / 3.0 + theta);
        } else if (diff > 0) {     // one real root
            const double s = sqrt(diff);
            const double u = (1.0 / (2.0 * a_s)) * (-yN + s);
            const double v = (1.0 / (2.0 * a_s)) * (-yN - s);
            const double n1 = u < 0 ? -pow(-u, 1.0 / 3.0)
                                    : pow(u, 1.0 / 3.0);
            const double n2 = v < 0 ? -pow(-v, 1.0 / 3.0)
                                    : pow(v, 1.0 / 3.0);
            roots[0] = xN + n1 + n2;
        } else {                   // degenerate: reference precedence
            case3 = true;          // quirk (yN/2*a) and NaN drop
            const double operand = (yN / 2.0) * a;
            if (operand >= 0.0) {
                const double delta = pow(operand, 1.0 / 3.0);
                roots[0] = xN + delta;
                roots[2] = xN - 2.0 * delta;
            }
        }

        const double lo = minhap - EPS, hi = maxhap + EPS;
        int n_possible = 0;
        double best_chi = INFINITY;
        double best_f11 = NAN;
        for (int r = 0; r < 3; ++r) {
            const double rv = roots[r];
            if (rv != rv || rv < lo || rv > hi) continue;
            ++n_possible;
            const double chi = twk_em_chi(t, n, rv, p, q);
            if (chi < best_chi) { best_chi = chi; best_f11 = rv; }
        }
        *f11_out = best_f11;
        *p_out = p;
        *q_out = q;
        *n_out = n;
        *valid_out = n_possible > 0;
        *multiple_out = (n_possible > 1) && !case3;
        *chi_out = (best_chi == INFINITY || best_chi != best_chi)
            ? 0.0 : best_chi;
    }
}

extern "C" int64_t twk_unphased_em(
        const int64_t* T, int64_t K,
        double* f11_out, double* p_out, double* q_out, double* n_out,
        uint8_t* valid_out, uint8_t* multiple_out, double* chi_out) {
    for (int64_t k = 0; k < K; ++k)
        twk_em_row(T + k * 9, f11_out + k, p_out + k, q_out + k,
                   n_out + k, valid_out + k, multiple_out + k,
                   chi_out + k);
    return K;
}

// ---------------------------------------------------------------------------
// Fused survivor -> TWO-record pipeline: the whole per-survivor host
// path (filter ladder, exact Fisher test, flag vector, record assembly
// for BOTH record orientations) in one multithread-capable batch call.
// Mirrors ops/ld_math.phased_math / unphased_math op-for-op; kept under
// fp-contract=off so FMA fusion cannot flip filter decisions against
// the numpy fallback at knife edges.
// (reference: lib/ld/ld_engine.cpp:1162-1310 PhasedMath,
//  :1312-1740 UnphasedMath/ChooseF11Calculate, record mirror
//  :1290-1298; flag bits include/core.h:770-783)

#pragma pack(push, 1)
struct TwkTwoRec {          // the 106-byte TWO wire record (io/two.py)
    uint16_t controller;
    uint32_t ridA, ridB, packA, packB;
    double cnt[4];          // REFREF, ALTREF, REFALT, ALTALT
    double D, Dprime, R, R2, P, ChiSqFisher, ChiSqModel;
};
#pragma pack(pop)
static_assert(sizeof(TwkTwoRec) == 106, "TWO record must be 106 bytes");

struct TwkLdParams {        // filters + flag thresholds, passed from
    double min_p;           // Python so io/constants.py stays the one
    double min_r2;          // source of truth
    double max_r2;
    double min_dprime;
    double max_dprime;
    double long_range;      // LONG_RANGE_THRESHOLD
    double invalid_hwe;     // INVALID_HWE_THRESHOLD
    double low_ac;          // LOW_AC_THRESHOLD
    double min_alleles;     // MINIMUM_ALLOWED_ALLELES
};

struct TwkPairMeta {
    const int64_t *pos_a, *pos_b, *rid_a, *rid_b;
    const int64_t *ac_a, *ac_b, *an_a, *an_b;
    const double *hwe_a, *hwe_b;
};

// mirrors ops/ld_math._common_flags; cnt_out is the OUTPUT-order count
// quadruple (REFREF, ALTREF, REFALT, ALTALT)
static uint16_t twk_common_flags(const TwkPairMeta& M, int64_t k,
                                 double r2, const double* cnt_out,
                                 bool used_phased,
                                 const TwkLdParams& P) {
    uint16_t f = 0;
    if (used_phased) f |= 1u << 0;                 // USED_PHASED_MATH
    const bool same = M.rid_a[k] == M.rid_b[k];
    if (same) f |= 1u << 1;                        // SAME_CONTIG
    const int64_t d = M.pos_a[k] > M.pos_b[k] ? M.pos_a[k] - M.pos_b[k]
                                              : M.pos_b[k] - M.pos_a[k];
    if (same && (double)d > P.long_range) f |= 1u << 2;   // LONG_RANGE
    if (cnt_out[0] < 1.0 || cnt_out[1] < 1.0 || cnt_out[2] < 1.0
            || cnt_out[3] < 1.0)
        f |= 1u << 3;                              // COMPLETE_LD
    if (r2 > 0.99) f |= 1u << 4;                   // PERFECT_LD
    if (M.an_a[k] > 0) f |= 1u << 8;               // MISSING_A
    if (M.an_b[k] > 0) f |= 1u << 9;               // MISSING_B
    if ((double)M.ac_a[k] < P.low_ac) f |= 1u << 10;   // LOW_AC_A
    if ((double)M.ac_b[k] < P.low_ac) f |= 1u << 11;   // LOW_AC_B
    if (M.hwe_a[k] < P.invalid_hwe) f |= 1u << 12;     // INVALID_HWE_A
    if (M.hwe_b[k] < P.invalid_hwe) f |= 1u << 13;     // INVALID_HWE_B
    return f;
}

static void twk_fill_rec(TwkTwoRec* fwd, TwkTwoRec* rev,
                         const TwkPairMeta& M, int64_t k, uint16_t fl,
                         const double* cnt_out, double D, double Dp,
                         double R2, double Pv, double chisq_f,
                         double chi_model) {
    fwd->controller = fl;
    fwd->ridA = (uint32_t)M.rid_a[k];
    fwd->ridB = (uint32_t)M.rid_b[k];
    fwd->packA = (uint32_t)M.pos_a[k] << 2;
    fwd->packB = (uint32_t)M.pos_b[k] << 2;
    memcpy(fwd->cnt, cnt_out, 4 * sizeof(double));
    fwd->D = D;
    fwd->Dprime = Dp;
    fwd->R = sqrt(R2 > 0.0 ? R2 : 0.0);
    fwd->R2 = R2;
    fwd->P = Pv;
    fwd->ChiSqFisher = chisq_f;
    fwd->ChiSqModel = chi_model;
    // the (B, A) mirror: swapped rid/pos tuples, identical statistics
    // (reference: ld_engine.cpp:1290-1298)
    *rev = *fwd;
    rev->ridA = fwd->ridB;
    rev->ridB = fwd->ridA;
    rev->packA = fwd->packB;
    rev->packB = fwd->packA;
}

// One phased 2x2 table through the filter ladder; c / ic are the
// (REFREF, REFALT, ALTREF, ALTALT) counts as double / int64.
// p_hint: a precomputed Fisher P (device bracket x exact f64 q,
// ops/fisher_dev.py) consumed instead of the exact scan; NaN means
// compute it here (uncertain tie-band lanes, repair-pass rows).
static bool twk_phased_row(const double* c, const int64_t* ic,
                           const TwkPairMeta& M, int64_t k,
                           const TwkLdParams& P, TwkTwoRec* fwd,
                           TwkTwoRec* rev, double p_hint = NAN) {
    const double rr = c[0], ra = c[1], ar = c[2], aa = c[3];
    const double t = rr + ra + ar + aa;
    if (!(t >= P.min_alleles)) return false;
    // rarer-corner guard (reference: ld_engine.cpp:1174-1186)
    const double guard = rr < aa ? ra + ar + rr : aa + ra + ar;
    if (!(guard >= 5.0)) return false;
    const double ts = t > 0.0 ? t : 1.0;
    const double pA = rr / ts, qA = ar / ts;
    const double pB = ra / ts, qB = aa / ts;
    const double D = pA * qB - qA * pB;
    if (D == 0.0) return false;
    const double g0 = (rr + ra) / ts;   // freq(ref) at A
    const double g1 = (ar + aa) / ts;
    const double h0 = (rr + ar) / ts;   // freq(ref) at B
    const double h1 = (ra + aa) / ts;
    const double denom = g0 * g1 * h0 * h1;
    const double R2 = denom > 0.0 ? D * D / denom : INFINITY;
    if (!(R2 >= P.min_r2 && R2 <= P.max_r2)) return false;
    const double dmax = D >= 0.0
        ? (g0 * h1 < h0 * g1 ? g0 * h1 : h0 * g1)
        : -(g0 * g1 < h0 * h1 ? g0 * g1 : h0 * h1);
    const double Dp = dmax != 0.0 ? D / dmax : 0.0;
    if (!(Dp >= P.min_dprime && Dp <= P.max_dprime)) return false;
    const double Pv = p_hint == p_hint ? p_hint
        : twk_fisher1(ic[0], ic[1], ic[2], ic[3]);
    if (!(Pv <= P.min_p)) return false;
    const double chisq_f = t * R2;
    // output cnt order is (REFREF, ALTREF, REFALT, ALTALT)
    const double cnt_out[4] = {rr, ar, ra, aa};
    const uint16_t fl = twk_common_flags(M, k, R2, cnt_out, true, P);
    twk_fill_rec(fwd, rev, M, k, fl, cnt_out, D, Dp, R2, Pv, chisq_f,
                 0.0);
    return true;
}

// One unphased 3x3 table through EM root choice + the filter ladder
// (mirrors ops/ld_math._choose_f11_records).
static bool twk_em_records_row(const int64_t* t, const TwkPairMeta& M,
                               int64_t k, const TwkLdParams& P,
                               TwkTwoRec* fwd, TwkTwoRec* rev) {
    double f11, p, q, n, chi;
    uint8_t valid, multiple;
    twk_em_row(t, &f11, &p, &q, &n, &valid, &multiple, &chi);
    if (!valid) return false;
    const double f12 = p - f11;
    const double f21 = q - f11;
    const double f22 = 1.0 - (f11 + f12 + f21);
    const double D = f11 * f22 - f12 * f21;
    const double denom = p * (1.0 - p) * q * (1.0 - q);
    const double R2 = denom > 0.0 ? D * D / denom : INFINITY;
    if (!(R2 >= P.min_r2 && R2 <= P.max_r2)) return false;
    const double two_n = 2.0 * n;
    const double c0 = f11 * two_n, c1 = f12 * two_n;
    const double c2 = f21 * two_n, c3 = f22 * two_n;
    // rarer-corner guard on ESTIMATED haplotype counts
    const double guard = c0 < c3 ? c1 + c2 + c0 : c3 + c1 + c2;
    if (!(guard >= 5.0)) return false;
    const double m_pos = p * (1.0 - q) < q * (1.0 - p)
        ? p * (1.0 - q) : q * (1.0 - p);
    const double m_neg = p * q < (1.0 - p) * (1.0 - q)
        ? p * q : (1.0 - p) * (1.0 - q);
    const double dmax = D >= 0.0 ? m_pos : -m_neg;
    const double Dp = dmax != 0.0 ? D / dmax : 0.0;
    if (!(Dp >= P.min_dprime && Dp <= P.max_dprime)) return false;
    // C round() semantics (half away from zero; counts are >= 0)
    // before the exact test, like the reference rounds its EM counts
    const double Pv = twk_fisher1(
        (int64_t)floor(c0 + 0.5), (int64_t)floor(c1 + 0.5),
        (int64_t)floor(c2 + 0.5), (int64_t)floor(c3 + 0.5));
    if (!(Pv <= P.min_p)) return false;
    const double chisq_f = (c0 + c1 + c2 + c3) * R2;
    // SIMD accessor order maps f12 (REFALT) to slot 2, f21 to slot 1
    const double cnt_out[4] = {c0, c2, c1, c3};
    uint16_t fl = twk_common_flags(M, k, R2, cnt_out, false, P);
    if (multiple) fl |= 1u << 5;                   // MULTIPLE_ROOTS
    twk_fill_rec(fwd, rev, M, k, fl, cnt_out, D, Dp, R2, Pv, chisq_f,
                 chi);
    return true;
}

// Mixed per-row dispatch of unphased_math: tables without double-hets
// fold to phased counts (reference: ld_engine.cpp:1334-1348).
static bool twk_unphased_row(const int64_t* t, const TwkPairMeta& M,
                             int64_t k, const TwkLdParams& P,
                             TwkTwoRec* fwd, TwkTwoRec* rev,
                             double p_hint = NAN) {
    int64_t n = 0;
    for (int i = 0; i < 9; ++i) n += t[i];
    // minimum-sample gate applies before the fold (ld_engine.cpp:1321)
    if (!((double)n >= P.min_alleles)) return false;
    if (t[4] == 0) {
        const int64_t rr = 2 * t[0] + t[1] + t[3];
        const int64_t ra = 2 * t[2] + t[1] + t[5];
        const int64_t ar = 2 * t[6] + t[3] + t[7];
        const int64_t aa = 2 * t[8] + t[7] + t[5];
        const double c[4] = {(double)rr, (double)ra,
                             (double)ar, (double)aa};
        const int64_t ic[4] = {rr, ra, ar, aa};
        // the fold's Fisher runs on the folded phased table, which is
        // exactly what the device bracket was computed from
        return twk_phased_row(c, ic, M, k, P, fwd, rev, p_hint);
    }
    return twk_em_records_row(t, M, k, P, fwd, rev);
}

struct TwkRecJob {
    int32_t table;            // 0 = phased counts[K,4], 1 = unphased [K,9]
    const int64_t* data;
    const TwkPairMeta* M;
    const TwkLdParams* P;
    TwkTwoRec* fwd;
    TwkTwoRec* rev;
    int64_t* idx;
    const double* p_pre;      // per-row Fisher P hints (NaN = compute)
};

static void twk_records_range(TwkRecJob J, int64_t lo, int64_t hi,
                              int64_t* n_out) {
    int64_t w = lo;   // per-range cursor; ranges compacted afterwards
    for (int64_t k = lo; k < hi; ++k) {
        bool kept;
        const double ph = J.p_pre ? J.p_pre[k] : NAN;
        if (J.table == 0) {
            const int64_t* ic = J.data + k * 4;
            const double c[4] = {(double)ic[0], (double)ic[1],
                                 (double)ic[2], (double)ic[3]};
            kept = twk_phased_row(c, ic, *J.M, k, *J.P,
                                  J.fwd + w, J.rev + w, ph);
        } else {
            kept = twk_unphased_row(J.data + k * 9, *J.M, k, *J.P,
                                    J.fwd + w, J.rev + w, ph);
        }
        if (kept) {
            J.idx[w] = k;
            ++w;
        }
    }
    *n_out = w - lo;
}

// data: [K, 4] phased counts (table=0) or [K, 9] genotype tables
// (table=1), int64 row-major. out_fwd/out_rev: K-record buffers (106
// bytes each); out_idx: K int64 kept-row indices. Returns the number
// of records written (prefix of each output). Rows process in order,
// so output order is input row order regardless of n_threads.
extern "C" int64_t twk_ld_records(
        int32_t table, const int64_t* data, int64_t K,
        const int64_t* pos_a, const int64_t* pos_b,
        const int64_t* rid_a, const int64_t* rid_b,
        const int64_t* ac_a, const int64_t* ac_b,
        const int64_t* an_a, const int64_t* an_b,
        const double* hwe_a, const double* hwe_b,
        const double* params, const double* p_pre,
        uint8_t* out_fwd, uint8_t* out_rev,
        int64_t* out_idx, int32_t n_threads) {
    TwkLdParams P;
    memcpy(&P, params, sizeof P);
    TwkPairMeta M{pos_a, pos_b, rid_a, rid_b, ac_a, ac_b, an_a, an_b,
                  hwe_a, hwe_b};
    TwkRecJob J{table, data, &M, &P, (TwkTwoRec*)out_fwd,
                (TwkTwoRec*)out_rev, out_idx, p_pre};
    if (n_threads < 1) n_threads = 1;
    if (K < 8192) n_threads = 1;      // spawn cost dominates below this
    if (n_threads == 1) {
        int64_t n = 0;
        twk_records_range(J, 0, K, &n);
        return n;
    }
    std::vector<std::thread> th;
    std::vector<int64_t> counts((size_t)n_threads, 0);
    std::vector<int64_t> los((size_t)n_threads, 0);
    const int64_t step = (K + n_threads - 1) / n_threads;
    for (int32_t i = 0; i < n_threads; ++i) {
        const int64_t lo = (int64_t)i * step;
        const int64_t hi = lo + step < K ? lo + step : K;
        los[(size_t)i] = lo;
        if (lo >= hi) { counts[(size_t)i] = 0; continue; }
        th.emplace_back(twk_records_range, J, lo, hi,
                        &counts[(size_t)i]);
    }
    for (auto& t : th) t.join();
    // compact per-range regions into one order-preserving prefix
    int64_t w = counts[0];
    for (int32_t i = 1; i < n_threads; ++i) {
        const int64_t lo = los[(size_t)i];
        const int64_t c = counts[(size_t)i];
        if (c && lo != w) {
            memmove(J.fwd + w, J.fwd + lo, (size_t)c * sizeof(TwkTwoRec));
            memmove(J.rev + w, J.rev + lo, (size_t)c * sizeof(TwkTwoRec));
            memmove(J.idx + w, J.idx + lo, (size_t)c * sizeof(int64_t));
        }
        w += c;
    }
    return w;
}

// ---------------------------------------------------------------------------
// Native CPU tile LD engine: the small-workload execution path. Where
// the device engine sweeps MXU tiles (compute/sweeps.py), this walks a
// [B x B] block pair with uint64 AND+popcount contingency counts and
// feeds each candidate pair straight through the same filter ladder /
// record assembly as twk_ld_records above -- the CPU-regime analogue
// of the reference's per-pair SSE kernels (reference:
// lib/ld/ld_engine.cpp:84-1160, PhasedVectorized/UnphasedVectorized),
// with candidate rules identical to sweeps.tile_mask.

static inline int64_t twk_pc2(const uint32_t* a, const uint32_t* b,
                              int64_t W) {
    // planes are words_for()-padded to multiples of 4 uint32 words and
    // numpy buffers are >= 8-byte aligned, so read as uint64 pairs
    int64_t n = 0;
    const uint64_t* a8 = (const uint64_t*)a;
    const uint64_t* b8 = (const uint64_t*)b;
    for (int64_t w = 0; w < W / 2; ++w)
        n += __builtin_popcountll(a8[w] & b8[w]);
    return n;
}

static inline int64_t twk_pc2_an(const uint32_t* a, const uint32_t* b,
                                 int64_t W) {   // popcount(a & ~b)
    int64_t n = 0;
    const uint64_t* a8 = (const uint64_t*)a;
    const uint64_t* b8 = (const uint64_t*)b;
    for (int64_t w = 0; w < W / 2; ++w)
        n += __builtin_popcountll(a8[w] & ~b8[w]);
    return n;
}

static inline int64_t twk_pc2_nn(const uint32_t* a, const uint32_t* b,
                                 int64_t W) {   // popcount(~a & ~b)
    // miss planes carry 1s on every padding bit (bitpack pad_value=1),
    // so ~a is zero beyond 2N and the complement popcount is exact
    int64_t n = 0;
    const uint64_t* a8 = (const uint64_t*)a;
    const uint64_t* b8 = (const uint64_t*)b;
    for (int64_t w = 0; w < W / 2; ++w)
        n += __builtin_popcountll(~(a8[w] | b8[w]));
    return n;
}

// One [r0, r1) x [0, B) row chunk of a block-pair tile.
// table 0 = phased (p1 = alt, p2 = miss planes), 1 = unphased
// (p1 = het, p2 = hom, p3 = valid). cls: 0 = all pairs, 1 = clean
// (an == 0 both), 2 = missing (mixed-mode complement). out_fwd/out_rev
// must hold one record per candidate pair of the chunk (worst case
// (r1 - r0) * B). Returns records written; *n_cand_out = candidates.
int64_t twk_ld_tile(
        int32_t table, int32_t has_missing, int32_t cls, int32_t diag,
        int64_t window, int64_t n_samples, int64_t B, int64_t W,
        int64_t r0, int64_t r1,
        const uint32_t* p1_i, const uint32_t* p2_i, const uint32_t* p3_i,
        const uint32_t* p1_j, const uint32_t* p2_j, const uint32_t* p3_j,
        const int64_t* pos_i, const int64_t* rid_i, const int64_t* ac_i,
        const int64_t* an_i, const int64_t* nhet_i, const int64_t* nhom_i,
        const double* hwe_i, const uint8_t* val_i,
        const int64_t* pos_j, const int64_t* rid_j, const int64_t* ac_j,
        const int64_t* an_j, const int64_t* nhet_j, const int64_t* nhom_j,
        const double* hwe_j, const uint8_t* val_j,
        const double* params,
        uint8_t* out_fwd, uint8_t* out_rev, int64_t* n_cand_out) {
    TwkLdParams P;
    memcpy(&P, params, sizeof P);
    TwkTwoRec* fwd = (TwkTwoRec*)out_fwd;
    TwkTwoRec* rev = (TwkTwoRec*)out_rev;
    // single-pair metadata views (k = 0) into the shared row code
    int64_t mpa, mpb, mra, mrb, mca, mcb, mna, mnb;
    double mha, mhb;
    TwkPairMeta M{&mpa, &mpb, &mra, &mrb, &mca, &mcb, &mna, &mnb,
                  &mha, &mhb};
    int64_t w = 0, ncand = 0;
    for (int64_t i = r0; i < r1; ++i) {
        if (!val_i[i]) continue;
        const uint32_t* a1 = p1_i + i * W;
        const uint32_t* a2 = p2_i ? p2_i + i * W : nullptr;
        const uint32_t* a3 = p3_i ? p3_i + i * W : nullptr;
        const int64_t j0 = diag ? i + 1 : 0;
        for (int64_t j = j0; j < B; ++j) {
            if (!val_j[j]) continue;
            if (ac_i[i] + ac_j[j] <= 2) continue;   // reference ac-skip
            if (window > 0) {
                if (rid_i[i] != rid_j[j]) continue;
                const int64_t d = pos_i[i] > pos_j[j]
                    ? pos_i[i] - pos_j[j] : pos_j[j] - pos_i[i];
                if (d > window) continue;
            }
            if (cls == 1) {
                if (an_i[i] != 0 || an_j[j] != 0) continue;
            } else if (cls == 2) {
                if (an_i[i] == 0 && an_j[j] == 0) continue;
            }
            ++ncand;
            mpa = pos_i[i]; mpb = pos_j[j];
            mra = rid_i[i]; mrb = rid_j[j];
            mca = ac_i[i];  mcb = ac_j[j];
            mna = an_i[i];  mnb = an_j[j];
            mha = hwe_i[i]; mhb = hwe_j[j];
            bool kept;
            if (table == 0) {
                const uint32_t* b1 = p1_j + j * W;
                const int64_t aa = twk_pc2(a1, b1, W);
                int64_t ar, ra, rr;
                if (has_missing) {
                    const uint32_t* b2 = p2_j + j * W;
                    // (altalt, alt.val, val.alt, val.val) exactly as
                    // engine._phased_counts_from_parts
                    const int64_t av = twk_pc2_an(a1, b2, W);
                    const int64_t va = twk_pc2_an(b1, a2, W);
                    const int64_t vv = twk_pc2_nn(a2, b2, W);
                    ar = av - aa;
                    ra = va - aa;
                    rr = vv - aa - ar - ra;
                } else {
                    ar = ac_i[i] - aa;
                    ra = ac_j[j] - aa;
                    rr = 2 * n_samples - (ac_i[i] + ac_j[j]) + aa;
                }
                // (REFREF, REFALT, ALTREF, ALTALT)
                const int64_t ic[4] = {rr, ra, ar, aa};
                const double c[4] = {(double)rr, (double)ra,
                                     (double)ar, (double)aa};
                kept = twk_phased_row(c, ic, M, 0, P, fwd + w, rev + w);
            } else {
                const uint32_t* b1 = p1_j + j * W;
                const uint32_t* b2 = p2_j + j * W;
                const int64_t T11 = twk_pc2(a1, b1, W);
                const int64_t T12 = twk_pc2(a1, b2, W);
                const int64_t T21 = twk_pc2(a2, b1, W);
                const int64_t T22 = twk_pc2(a2, b2, W);
                int64_t hv, vh, ov, vo, vv;
                if (has_missing) {
                    const uint32_t* b3 = p3_j + j * W;
                    hv = twk_pc2(a1, b3, W);
                    vh = twk_pc2(a3, b1, W);
                    ov = twk_pc2(a2, b3, W);
                    vo = twk_pc2(a3, b2, W);
                    vv = twk_pc2(a3, b3, W);
                } else {
                    hv = nhet_i[i]; vh = nhet_j[j];
                    ov = nhom_i[i]; vo = nhom_j[j];
                    vv = n_samples;
                }
                const int64_t T10 = hv - T11 - T12;
                const int64_t T20 = ov - T21 - T22;
                const int64_t T01 = vh - T11 - T21;
                const int64_t T02 = vo - T12 - T22;
                const int64_t T00 = vv - (T01 + T02 + T10 + T11 + T12
                                          + T20 + T21 + T22);
                const int64_t t9[9] = {T00, T01, T02, T10, T11, T12,
                                       T20, T21, T22};
                kept = twk_unphased_row(t9, M, 0, P, fwd + w, rev + w);
            }
            if (kept) ++w;
        }
    }
    *n_cand_out = ncand;
    return w;
}
#pragma GCC pop_options

// ---------------------------------------------------------------------------
// Streaming gzip/BGZF inflater. BGZF (the BCF/VCF.gz container,
// reference: htslib BGZF used by lib/vcf_reader.h) is a concatenation
// of <=64 KB gzip members; CPython's gzip module re-frames every
// member in Python, which costs more than the inflate itself at
// population scale. This keeps one z_stream alive across calls and
// hops member boundaries with inflateReset2 entirely in C.

struct TwkInflate {
    z_stream zs;
};

void* twk_inflate_new() {
    TwkInflate* h = new TwkInflate();
    memset(&h->zs, 0, sizeof(z_stream));
    // 15+32: zlib OR gzip header auto-detection
    if (inflateInit2(&h->zs, 15 + 32) != Z_OK) {
        delete h;
        return nullptr;
    }
    return h;
}

void twk_inflate_free(void* hp) {
    TwkInflate* h = (TwkInflate*)hp;
    inflateEnd(&h->zs);
    delete h;
}

// Inflate as much of src as fits in dst. Returns 0 (ok) or <0
// (corrupt stream); consumed/produced report progress. Member
// boundaries (BGZF concatenation) are crossed transparently.
int32_t twk_inflate_feed(void* hp, const uint8_t* src, int64_t n_src,
                         uint8_t* dst, int64_t dst_cap,
                         int64_t* consumed, int64_t* produced) {
    TwkInflate* h = (TwkInflate*)hp;
    z_stream* zs = &h->zs;
    zs->next_in = (Bytef*)src;
    zs->avail_in = (uInt)n_src;
    zs->next_out = dst;
    zs->avail_out = (uInt)dst_cap;
    while (zs->avail_out > 0 && zs->avail_in > 0) {
        int r = inflate(zs, Z_NO_FLUSH);
        if (r == Z_STREAM_END) {
            if (inflateReset2(zs, 15 + 32) != Z_OK) return -2;
            continue;
        }
        if (r == Z_BUF_ERROR) break;   // progress needs more in/out
        if (r != Z_OK) return -1;
    }
    *consumed = n_src - (int64_t)zs->avail_in;
    *produced = dst_cap - (int64_t)zs->avail_out;
    return 0;
}

}  // extern "C"
