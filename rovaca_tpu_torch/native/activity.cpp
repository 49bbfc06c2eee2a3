// Native batch activity accumulator — the per-base evidence histogram.
//
// Replicates rovaca_tpu.pipeline.activity.accumulate_read exactly (which in
// turn reimplements the reference's per-base activity classification,
// reference: src/haplotypecaller/ActiveRegion/HcActiveBase.cpp:96-188) for a
// whole batch of reads in one call: CIGAR walk classifying each aligned base
// as variant/reference evidence, adaptor-overlap masking on short inserts,
// edge rules at clip/indel-adjacent positions, deletion pseudo-quals, and
// the high-quality soft-clip statistics used for smear extension.
//
// The Python implementation remains the oracle; tests/test_activity_native.py
// asserts histogram-level identity over randomized reads.

#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kRefModelDeletionQual = 30;  // HcActiveBase.cpp:1-12
constexpr int kMinBaseQual = 10;
constexpr int kHqSoftclipQualThreshold = 28;
constexpr int kMaxQualBin = 64;

enum Op : uint8_t { M = 0, I = 1, D = 2, N = 3, S = 4, H = 5, P = 6,
                    EQ = 7, X = 8, NONE = 255 };

inline bool consumes_ref(uint8_t op) {
    return op == M || op == D || op == N || op == EQ || op == X;
}
inline bool consumes_query(uint8_t op) {
    return op == M || op == I || op == S || op == EQ || op == X;
}

struct Read {
    int64_t pos;
    int64_t mate_pos;
    int32_t tlen;
    int32_t flag;
    const uint8_t* ops;
    const int32_t* lens;
    int32_t n_cigar;
    const uint8_t* bases;
    const uint8_t* quals;
    int32_t seq_len;
};

int64_t ref_span(const Read& r) {
    int64_t n = 0;
    for (int32_t i = 0; i < r.n_cigar; i++)
        if (consumes_ref(r.ops[i])) n += r.lens[i];
    return n;
}

// adaptor_boundary (activity.py:104-117; HcActiveBase.cpp:48-68).
// Returns -2 for "none" (a real boundary can be 0).
int64_t adaptor_boundary(const Read& r) {
    const bool paired = r.flag & 0x1;
    const bool mate_unmapped = r.flag & 0x8;
    const bool unmapped = r.flag & 0x4;
    const bool rev = r.flag & 0x10;
    const bool mate_rev = r.flag & 0x20;
    if (r.tlen == 0 || !paired || mate_unmapped || unmapped ||
        rev == mate_rev)
        return -2;
    if (rev) {
        if (r.pos + ref_span(r) <= r.mate_pos) return -2;
        return r.mate_pos;
    }
    if (r.pos > r.mate_pos + r.tlen) return -2;
    int64_t t = r.tlen;
    return r.pos + 1 + (t < 0 ? -t : t);
}

// high_quality_soft_clips (activity.py:91-101; HcActiveBase.cpp:14-34)
int64_t hq_soft_clips(const Read& r) {
    int64_t n = 0;
    int64_t qpos = 0;
    for (int32_t i = 0; i < r.n_cigar; i++) {
        const uint8_t op = r.ops[i];
        const int32_t len = r.lens[i];
        if (op == S)
            for (int32_t j = 0; j < len; j++)
                if (r.quals[qpos + j] > kHqSoftclipQualThreshold) n++;
        if (consumes_query(op)) qpos += len;
    }
    return n;
}

}  // namespace

// Accumulates all reads into hist (2, L, 64) int32 laid out C-contiguously,
// hq_sum (L) f64, hq_n (L) i64 for the window [win_start, win_start + L).
// ref covers absolute positions [ref_off, ref_off + ref_len).
extern "C" void rovaca_activity_accumulate(
    int64_t n_reads, const int64_t* pos, const int64_t* mate_pos,
    const int32_t* tlen, const int32_t* flag, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const uint8_t* ref, int64_t ref_off,
    int64_t ref_len, int64_t win_start, int64_t L, int32_t* hist,
    double* hq_sum, int64_t* hq_n) {
    int32_t* hist_var = hist;                 // [0][pos][qual]
    int32_t* hist_ref = hist + L * kMaxQualBin;

    for (int64_t ri = 0; ri < n_reads; ri++) {
        Read r;
        r.pos = pos[ri];
        r.mate_pos = mate_pos[ri];
        r.tlen = tlen[ri];
        r.flag = flag[ri];
        r.ops = cig_ops + cig_off[ri];
        r.lens = cig_lens + cig_off[ri];
        r.n_cigar = cig_n[ri];
        r.bases = bases + seq_off[ri];
        r.quals = quals + seq_off[ri];
        r.seq_len = seq_len[ri];

        const int64_t bound = adaptor_boundary(r);
        const bool mask_adaptor = bound != -2 && r.tlen <= 100;
        const bool rev = r.flag & 0x10;
        int64_t hq = -1;  // lazy hq_soft_clips

        int64_t p = r.pos;
        int64_t qpos = 0;
        for (int32_t ci = 0; ci < r.n_cigar; ci++) {
            const uint8_t op = r.ops[ci];
            const int64_t len = r.lens[ci];
            if (consumes_ref(op)) {
                const uint8_t prev_op = ci > 0 ? r.ops[ci - 1] : NONE;
                const uint8_t next_op =
                    ci < r.n_cigar - 1 ? r.ops[ci + 1] : NONE;
                const bool hq_first = prev_op == S;
                const bool hq_last = len > 1 && next_op == S;
                for (int64_t j = 0; j < len; j++) {
                    const int64_t ap = p + j;          // absolute position
                    const int64_t off = ap - win_start;
                    if (off < 0 || off >= L) continue;
                    if (mask_adaptor) {
                        const int64_t p1 = ap + 1;
                        if (rev ? !(p1 > bound) : !(p1 < bound)) continue;
                    }
                    if (op == D) {
                        hist_var[off * kMaxQualBin +
                                 kRefModelDeletionQual] += 1;
                        continue;
                    }
                    // positions outside the ref view are masked out
                    // (activity.py:174-190 clamp semantics)
                    const int64_t ridx = ap - ref_off;
                    if (ridx < 0 || ridx >= ref_len) continue;
                    if (qpos + j >= r.seq_len) continue;  // malformed cigar
                    const uint8_t q = r.quals[qpos + j];
                    const int bq = q < kMaxQualBin ? q : kMaxQualBin - 1;
                    bool variant = r.bases[qpos + j] != ref[ridx];
                    if (j == 0 &&
                        (hq_first || prev_op == I || prev_op == D ||
                         (len == 1 && (next_op == I || next_op == D))))
                        variant = true;
                    if (j == len - 1 && len > 1 &&
                        (hq_last || next_op == I || next_op == D))
                        variant = true;
                    (variant ? hist_var : hist_ref)[off * kMaxQualBin + bq]
                        += 1;
                    // hq soft-clip stats at clip-adjacent aligned edges
                    if (((j == 0 && hq_first) ||
                         (j == len - 1 && hq_last)) &&
                        q > kMinBaseQual) {
                        if (hq < 0) hq = hq_soft_clips(r);
                        hq_sum[off] += static_cast<double>(hq);
                        hq_n[off] += 1;
                    }
                }
            }
            if (consumes_ref(op)) p += len;
            if (consumes_query(op)) qpos += len;
        }
    }
}

// ---------------------------------------------------------------------------
// Batched per-position genotype-likelihood accumulation from the pileup
// histogram, in the REFERENCE's exact bucket order (FS_REF buckets first,
// qual ascending; reference_confidence_model.cpp:114-186, HcActiveBase.cpp:
// 190-230): gl[p][g] = sum over non-zero (state, qual) buckets of
// count * cache[state][qual][g], minus read_count * log10(ploidy).
// Sparse skip of zero-count buckets makes this ~50x cheaper than the dense
// einsum it replaces; cache rows at-or-below the qual threshold are zeroed
// by the caller (identical partial sums, reference skips them via the
// threshold+1 loop start).
// hist layout: (2, L, 64) int32 C-contiguous, state 0 = non-ref evidence,
// state 1 = ref (our PositionObs layout).
// ---------------------------------------------------------------------------

extern "C" void rovaca_pileup_gls(
    const int32_t* hist, int64_t L, const double* cache, int64_t G,
    int32_t qual_threshold, double log10_ploidy, double* gl,
    int64_t* counts) {
    const int64_t HQ = 64;
    for (int64_t p = 0; p < L; ++p) {
        double* g = gl + p * G;
        for (int64_t k = 0; k < G; ++k) g[k] = 0.0;
        int64_t n = 0;
        // reference iterates FS_REF (our state 1) first, then FS_NON_REF
        for (int s = 1; s >= 0; --s) {
            const int32_t* row = hist + ((int64_t)s * L + p) * HQ;
            const double* crow = cache + (int64_t)s * HQ * G;
            for (int64_t q = 0; q < HQ; ++q) {
                const int32_t c = row[q];
                if (c == 0) continue;
                const double* cv = crow + q * G;
                const double dc = (double)c;
                for (int64_t k = 0; k < G; ++k) g[k] += dc * cv[k];
                if (q > qual_threshold) n += c;
            }
        }
        const double denom = (double)n * log10_ploidy;
        for (int64_t k = 0; k < G; ++k) g[k] -= denom;
        counts[p] = n;
    }
}

// Candidate variant of rovaca_pileup_gls: positions with no variant-state
// (s=0) count above qual_threshold provably yield activity 0 downstream,
// so only rows with such evidence are emitted (their per-row arithmetic
// is the exact sequence of rovaca_pileup_gls — bit-identical results).
// Returns the number of candidate rows written to idx/gl/counts.
extern "C" int64_t rovaca_pileup_gls_cand(
    const int32_t* hist, int64_t L, const double* cache, int64_t G,
    int32_t qual_threshold, double log10_ploidy, int64_t* idx,
    double* gl, int64_t* counts) {
    const int64_t HQ = 64;
    int64_t nc = 0;
    for (int64_t p = 0; p < L; ++p) {
        const int32_t* row0 = hist + p * HQ;   // state 0 = variant
        bool cand = false;
        for (int64_t q = qual_threshold + 1; q < HQ; ++q)
            if (row0[q]) { cand = true; break; }
        if (!cand) continue;
        double* g = gl + nc * G;
        for (int64_t k = 0; k < G; ++k) g[k] = 0.0;
        int64_t n = 0;
        for (int s = 1; s >= 0; --s) {
            const int32_t* row = hist + ((int64_t)s * L + p) * HQ;
            const double* crow = cache + (int64_t)s * HQ * G;
            for (int64_t q = 0; q < HQ; ++q) {
                const int32_t c = row[q];
                if (c == 0) continue;
                const double* cv = crow + q * G;
                const double dc = (double)c;
                for (int64_t k = 0; k < G; ++k) g[k] += dc * cv[k];
                if (q > qual_threshold) n += c;
            }
        }
        const double denom = (double)n * log10_ploidy;
        for (int64_t k = 0; k < G; ++k) g[k] -= denom;
        counts[nc] = n;
        idx[nc] = p;
        nc++;
    }
    return nc;
}
