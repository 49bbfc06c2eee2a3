// Native GVCF position observations — C++ port of
// rovaca_tpu/pipeline/ref_confidence.build_position_obs (the oracle):
// per-read pileup layout, adaptor exclusion, ref/non-ref qual histograms,
// and the GATK-exact indel-informativeness bitset
// (reference: src/haplotypecaller/genotype/reference_confidence_model.cpp:
// 25-27,190-260, assembly_based_caller_utils.cpp:171-265).
// tests/test_posobs_native.py asserts array-level identity vs Python.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBaseQualThreshold = 6;       // assembly_based_caller_utils.h:20
constexpr int kRefModelDeletionQual = 30;
constexpr int kMaxIndelSize = 10;
constexpr uint8_t kGapBase = 45;            // '-'
constexpr int64_t kNoBoundary = INT64_MIN;

enum Op : uint8_t { M = 0, I = 1, D = 2, N = 3, S = 4, H = 5, P = 6,
                    EQ = 7, X = 8 };

inline bool consumes_query(uint8_t op) {
    return op == M || op == I || op == S || op == EQ || op == X;
}
inline bool consumes_ref(uint8_t op) {
    return op == M || op == D || op == N || op == EQ || op == X;
}

uint8_t base_mask(uint8_t b) {
    switch (b) {
        case 'A': return 1;
        case 'C': return 2;
        case 'G': return 4;
        case 'T': return 8;
        case 'N': return 15;
        default: return 0;
    }
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

    bool is_reverse() const { return flag & 0x10; }
    bool is_paired() const { return flag & 0x1; }
    bool is_unmapped() const { return flag & 0x4; }
    bool mate_unmapped() const { return flag & 0x8; }
    bool mate_reverse() const { return flag & 0x20; }
    int64_t ref_len() const {
        int64_t n = 0;
        for (int32_t i = 0; i < n_cigar; i++)
            if (consumes_ref(ops[i])) n += lens[i];
        return n;
    }
};

// _adaptor_exclusion boundary (ref_confidence.py:275-297); kNoBoundary
// means no masking applies.
int64_t exclusion_boundary(const Read& r, bool* exclude_leq) {
    int64_t isize = r.tlen;
    if (isize > 100) return kNoBoundary;
    if (isize == 0 || !r.is_paired() || r.is_unmapped() ||
        r.mate_unmapped() || r.is_reverse() == r.mate_reverse())
        return kNoBoundary;
    if (r.is_reverse()) {
        if (!(r.pos + r.ref_len() - 1 > r.mate_pos)) return kNoBoundary;
        *exclude_leq = true;                 // pos <= mate_pos - 1 excluded
        return r.mate_pos - 1;
    }
    if (!(r.pos <= r.mate_pos + isize)) return kNoBoundary;
    *exclude_leq = false;                    // pos >= pos + |isize| excluded
    return r.pos + (isize < 0 ? -isize : isize);
}

// gapped one-to-one arrays (ref_confidence.one_to_one): bases/quals with
// deletions as GAP; I and S query bases dropped (S lengths still count
// toward the gapped length, leaving a zero tail)
void one_to_one(const Read& r, std::vector<uint8_t>& gb,
                std::vector<uint8_t>& gq) {
    bool saw_indel = false;
    for (int32_t i = 0; i < r.n_cigar; i++)
        if (r.ops[i] == I || r.ops[i] == D) saw_indel = true;
    if (!saw_indel) {
        gb.assign(r.bases, r.bases + r.seq_len);
        gq.assign(r.quals, r.quals + r.seq_len);
        return;
    }
    int64_t glen = 0;
    for (int32_t i = 0; i < r.n_cigar; i++)
        if (consumes_ref(r.ops[i]) || r.ops[i] == S) glen += r.lens[i];
    gb.assign(glen, 0);
    gq.assign(glen, 0);
    int64_t lit = 0, pad = 0;
    for (int32_t i = 0; i < r.n_cigar; i++) {
        uint8_t op = r.ops[i];
        int32_t n = r.lens[i];
        if (consumes_query(op)) {
            if (consumes_ref(op)) {
                std::memcpy(gb.data() + pad, r.bases + lit, n);
                std::memcpy(gq.data() + pad, r.quals + lit, n);
                pad += n;
            }
            lit += n;
        } else if (consumes_ref(op)) {
            std::memset(gb.data() + pad, kGapBase, n);
            pad += n;  // quals stay 0
        }
    }
}

// informative_set (ref_confidence.py:142-216): GATK-exact bitset over
// gapped offsets, returned sized raw_len.
void informative_set(const Read& r, int64_t read_start,
                     const uint8_t* ref, int64_t ref_len,
                     int64_t ref_start, std::vector<uint8_t>& out) {
    const int64_t raw_len = r.seq_len;
    const int K = kMaxIndelSize;
    out.assign(raw_len, 0);
    if (raw_len - read_start < K || ref_len - ref_start < K) return;
    const int64_t secondary = raw_len - K;
    std::vector<uint8_t> gb, gq;
    one_to_one(r, gb, gq);
    const int64_t glen = (int64_t)gb.size();
    if (glen - read_start <= K) return;

    int64_t last_rel;
    bool ref_shorter;
    if (glen < ref_len - ref_start + read_start + 1) {
        last_rel = glen - K;
        ref_shorter = false;
    } else {
        last_rel = ref_len - ref_start + read_start - K + 1;
        ref_shorter = true;
    }

    const int64_t n = std::min(glen - read_start, ref_len - ref_start);
    // suffix sums of mismatch quals for an alignment of gb[r_lo..] vs
    // ref[f_lo..] over m positions
    auto suffix_mism = [&](int64_t r_lo, int64_t f_lo, int64_t m,
                           std::vector<int64_t>& s) {
        s.assign(m + 1, 0);
        for (int64_t j = m - 1; j >= 0; j--) {
            uint8_t b = gb[r_lo + j];
            uint8_t rm = base_mask(b);
            uint8_t fm = base_mask(ref[f_lo + j]);
            int64_t q = ((rm & fm) == 0 && b != kGapBase)
                            ? (int64_t)gq[r_lo + j]
                            : 0;
            s[j] = s[j + 1] + q;
        }
    };
    std::vector<int64_t> baseline, shifted;
    suffix_mism(read_start, ref_start, n, baseline);

    std::vector<uint8_t> marked(glen, 0);
    auto site_ok = [&](int64_t j) {  // j relative to read_start
        int64_t abs_off = read_start + j;
        return gb[abs_off] != kGapBase && abs_off < last_rel &&
               abs_off <= secondary;
    };
    for (int size = 1; size <= K; size++) {
        int64_t nb = std::min(glen - read_start,
                              ref_len - ref_start - size);
        if (nb > 0) {
            suffix_mism(read_start, ref_start + size, nb, shifted);
            for (int64_t j = 0; j < nb; j++)
                if (baseline[j] >= shifted[j] && site_ok(j))
                    marked[read_start + j] = 1;
        }
        nb = std::min(glen - read_start - size, ref_len - ref_start);
        if (nb > 0) {
            suffix_mism(read_start + size, ref_start, nb, shifted);
            for (int64_t j = 0; j < nb; j++)
                if (baseline[j] >= shifted[j] && site_ok(j))
                    marked[read_start + j] = 1;
        }
    }

    if (last_rel <= secondary) {
        for (int64_t i = 0; i < std::min(last_rel, glen); i++)
            marked[i] = !marked[i];
        if (ref_shorter && last_rel >= 1) marked[last_rel - 1] = 0;
    } else {
        int64_t hi = std::min(secondary + 1, glen);
        for (int64_t i = 0; i < hi; i++) marked[i] = !marked[i];
    }
    int64_t m = std::min(glen, raw_len);
    for (int64_t i = 0; i < m; i++) out[i] = marked[i];
}

}  // namespace

// Accumulate all reads' pileup observations over flank [start, end):
// hist (2, L, 64) int32 (status 0 = non-ref, 1 = ref-match), depth (L)
// int32, indel_informative (L) int32. padded_ref covers absolute
// positions [padded_start, padded_start + padded_len); depth is (2, L).
static void build_position_obs_impl(
    int64_t n_reads, const uint8_t* keep, const int64_t* pos,
    const int64_t* mate_pos,
    const int32_t* tlen, const int32_t* flag, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const uint8_t* padded_ref, int64_t padded_len,
    int64_t padded_start, int64_t start, int64_t end, int32_t* hist,
    int32_t* depth, int32_t* indel_informative) {
    const int64_t L = end - start;
    int32_t* hist_nonref = hist;              // [0][off][qual]
    int32_t* hist_ref = hist + L * 64;
    int32_t* depth_nonref = depth;            // [0][off]
    int32_t* depth_ref = depth + L;

    std::vector<uint8_t> info;
    for (int64_t ri = 0; ri < n_reads; ri++) {
        if (keep && !keep[ri]) continue;
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

        bool exclude_leq = false;
        int64_t bound = exclusion_boundary(r, &exclude_leq);

        // pileup walk (ref_confidence._pileup_layout) with inline
        // histogram + informativeness seeding
        bool have_info = false;
        int64_t p = r.pos, q = 0, g = 0;
        for (int32_t ci = 0; ci < r.n_cigar; ci++) {
            uint8_t op = r.ops[ci];
            int64_t len = r.lens[ci];
            bool in_q = consumes_query(op);
            bool in_r = consumes_ref(op);
            if (in_r) {
                bool is_del = !in_q;
                // skip flags for the LAST base of a non-del element
                bool last_skips = false;
                if (!is_del) {
                    for (int32_t cj = ci + 1; cj < r.n_cigar; cj++) {
                        if (r.lens[cj] && consumes_ref(r.ops[cj])) {
                            if (r.ops[cj] == D || r.ops[cj] == N)
                                last_skips = true;
                            break;
                        }
                    }
                    if (ci + 1 < r.n_cigar && r.ops[ci + 1] == I &&
                        r.lens[ci + 1])
                        last_skips = true;
                }
                for (int64_t j = 0; j < len; j++) {
                    int64_t ap = p + j;
                    if (ap < start || ap >= end) continue;
                    if (bound != kNoBoundary &&
                        (exclude_leq ? ap <= bound : ap >= bound))
                        continue;
                    int64_t off = ap - start;
                    if (is_del) {
                        hist_nonref[off * 64 + kRefModelDeletionQual] += 1;
                        depth_nonref[off] += 1;
                    } else {
                        uint8_t bq = r.quals[q + j];
                        if (bq > kBaseQualThreshold) {
                            uint8_t b = r.bases[q + j];
                            uint8_t refb = padded_ref[ap - padded_start];
                            int qa = bq < 64 ? bq : 63;
                            bool match = b == refb;
                            (match ? hist_ref
                                   : hist_nonref)[off * 64 + qa] += 1;
                            (match ? depth_ref : depth_nonref)[off] += 1;
                        }
                        bool skip = is_del ||
                                    (j == len - 1 && last_skips);
                        if (!skip) {
                            if (!have_info) {
                                informative_set(r, g + j, padded_ref,
                                                padded_len,
                                                ap - padded_start, info);
                                have_info = true;
                            }
                            int64_t go = g + j;
                            if (go < (int64_t)info.size() && info[go])
                                indel_informative[off] += 1;
                        }
                    }
                }
                p += len;
                g += len;
                if (in_q) q += len;
            } else if (in_q) {
                if (op == S) g += len;
                q += len;
            }
        }
    }
}

// Original dense entry: every row participates.
extern "C" void rovaca_build_position_obs(
    int64_t n_reads, const int64_t* pos, const int64_t* mate_pos,
    const int32_t* tlen, const int32_t* flag, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const uint8_t* padded_ref, int64_t padded_len,
    int64_t padded_start, int64_t start, int64_t end, int32_t* hist,
    int32_t* depth, int32_t* indel_informative) {
    build_position_obs_impl(n_reads, nullptr, pos, mate_pos, tlen, flag,
                            cig_off, cig_n, cig_ops, cig_lens, seq_off,
                            seq_len, bases, quals, padded_ref, padded_len,
                            padded_start, start, end, hist, depth,
                            indel_informative);
}

// Masked entry: rows with keep[ri]==0 are skipped, so callers can hand
// the finalize output slabs over verbatim (offsets absolute into the
// shared cigar/sequence slabs) instead of flatten-gathering the kept
// subset in Python. Histogram/depth/informative adds are integer and
// per-read independent, so skipping is bit-identical to gathering.
extern "C" void rovaca_build_position_obs_masked(
    int64_t n_reads, const uint8_t* keep, const int64_t* pos,
    const int64_t* mate_pos,
    const int32_t* tlen, const int32_t* flag, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const uint8_t* padded_ref, int64_t padded_len,
    int64_t padded_start, int64_t start, int64_t end, int32_t* hist,
    int32_t* depth, int32_t* indel_informative) {
    build_position_obs_impl(n_reads, keep, pos, mate_pos, tlen, flag,
                            cig_off, cig_n, cig_ops, cig_lens, seq_off,
                            seq_len, bases, quals, padded_ref, padded_len,
                            padded_start, start, end, hist, depth,
                            indel_informative);
}

// Filtered entry: computes the usable-read filter internally
// (filter_non_passing_reads2, adapter_utils.cpp:240-251 — unclipped
// length, mapping quality, mate-contig check) and accumulates the
// surviving rows, replacing PackedFinalized.usable_mask + the keep
// array. min_len is MIN_READ_LENGTH_AFTER_TRIMMING.
extern "C" void rovaca_build_position_obs_filtered(
    int64_t n_reads, const int32_t* mq, const int32_t* ref_id,
    const int32_t* mate_ref_id, int32_t mq_threshold, int32_t min_len,
    const int64_t* pos, const int64_t* mate_pos,
    const int32_t* tlen, const int32_t* flag, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const uint8_t* padded_ref, int64_t padded_len,
    int64_t padded_start, int64_t start, int64_t end, int32_t* hist,
    int32_t* depth, int32_t* indel_informative) {
    std::vector<uint8_t> keep(n_reads);
    for (int64_t ri = 0; ri < n_reads; ri++) {
        int64_t sc = 0;
        const uint8_t* ops = cig_ops + cig_off[ri];
        const int32_t* lens = cig_lens + cig_off[ri];
        for (int32_t ci = 0; ci < cig_n[ri]; ci++)
            if (ops[ci] == S) sc += lens[ci];
        int64_t unclipped = (int64_t)seq_len[ri] - sc;
        int32_t f = flag[ri];
        bool paired = f & 0x1, unmapped = f & 0x4, mate_unmapped = f & 0x8;
        bool mate_ok = !paired || mate_unmapped ||
                       (!unmapped && ref_id[ri] == mate_ref_id[ri]);
        keep[ri] = unclipped >= min_len && mq[ri] >= mq_threshold &&
                   mate_ok;
    }
    build_position_obs_impl(n_reads, keep.data(), pos, mate_pos, tlen,
                            flag, cig_off, cig_n, cig_ops, cig_lens,
                            seq_off, seq_len, bases, quals, padded_ref,
                            padded_len, padded_start, start, end, hist,
                            depth, indel_informative);
}
