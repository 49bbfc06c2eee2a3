// GATK-exact Smith-Waterman, native implementation.
//
// Same algorithm as rovaca_tpu/assembly/sw.py (see the reference citation
// there: hc_assemble_gatk_sw.c / GATK SWPairwiseAlignment): affine gaps via
// incrementally-maintained best-gap arrays, diag > right > down tie-breaking,
// four overhang strategies, backtrack to cigar + alignment offset.
//
// Exposed as a C ABI for ctypes. Thread-safe (no globals; caller-provided or
// heap scratch).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMatrixMinCutoff = -100000000;  // -1e8
constexpr int64_t kLowInit = -(int64_t(1) << 30);

enum Overhang { SOFTCLIP = 0, INDEL = 1, LEADING_INDEL = 2, IGNORE = 3 };
enum Op : uint8_t { OP_M = 0, OP_I = 1, OP_D = 2, OP_S = 4 };

struct Seg {
    uint8_t op;
    int32_t len;
};

}  // namespace

extern "C" int rovaca_sw_align(
    const uint8_t* ref, int ref_len, const uint8_t* alt, int alt_len,
    int w_match, int w_mismatch, int w_open, int w_extend, int overhang,
    uint8_t* out_ops, int32_t* out_lens, int max_cigar, int32_t* out_offset);

// Batched entry: n alignments, flattened sequence buffers with offsets,
// per-alignment output slots of max_cigar elements. Parallelized across
// alignments with OpenMP (bypasses the Python GIL for realignment batches).
extern "C" void rovaca_sw_align_batch(
    int n, const uint8_t* ref_buf, const int64_t* ref_off,
    const int32_t* ref_len, const uint8_t* alt_buf, const int64_t* alt_off,
    const int32_t* alt_len, int w_match, int w_mismatch, int w_open,
    int w_extend, int overhang, uint8_t* out_ops, int32_t* out_lens,
    int max_cigar, int32_t* out_counts, int32_t* out_offsets) {
#pragma omp parallel for schedule(dynamic, 4)
    for (int k = 0; k < n; k++) {
        out_counts[k] = rovaca_sw_align(
            ref_buf + ref_off[k], ref_len[k], alt_buf + alt_off[k],
            alt_len[k], w_match, w_mismatch, w_open, w_extend, overhang,
            out_ops + (size_t)k * max_cigar, out_lens + (size_t)k * max_cigar,
            max_cigar, out_offsets + k);
    }
}

extern "C" int rovaca_sw_align(
    const uint8_t* ref, int ref_len, const uint8_t* alt, int alt_len,
    int w_match, int w_mismatch, int w_open, int w_extend, int overhang,
    uint8_t* out_ops, int32_t* out_lens, int max_cigar, int32_t* out_offset) {
    if (!ref || !alt || ref_len <= 0 || alt_len <= 0) return -1;
    const int n = ref_len, m = alt_len;
    const int ylen = m + 1;

    std::vector<int64_t> sw(size_t(n + 1) * ylen, 0);
    std::vector<int32_t> btrack(size_t(n + 1) * ylen, 0);
    std::vector<int64_t> best_gap_v(m + 1, kLowInit);
    std::vector<int64_t> gap_size_v(m + 1, 0);
    std::vector<int64_t> best_gap_h(n + 1, kLowInit);
    std::vector<int64_t> gap_size_h(n + 1, 0);

    if (overhang == INDEL || overhang == LEADING_INDEL) {
        int64_t v = w_open;
        sw[1] = v;
        for (int j = 2; j <= m; j++) {
            v += w_extend;
            sw[j] = v;
        }
        v = w_open;
        sw[size_t(1) * ylen] = v;
        for (int i = 2; i <= n; i++) {
            v += w_extend;
            sw[size_t(i) * ylen] = v;
        }
    }

    for (int i = 1; i <= n; i++) {
        const uint8_t a = ref[i - 1];
        const int64_t* lastRow = &sw[size_t(i - 1) * ylen];
        int64_t* curRow = &sw[size_t(i) * ylen];
        int32_t* curBt = &btrack[size_t(i) * ylen];
        int64_t bgh = best_gap_h[i];
        int64_t gsh = gap_size_h[i];
        for (int j = 1; j <= m; j++) {
            const uint8_t b = alt[j - 1];
            const int64_t step_diag =
                lastRow[j - 1] + (a == b ? w_match : w_mismatch);

            int64_t prev_gap = lastRow[j] + w_open;
            best_gap_v[j] += w_extend;
            if (prev_gap > best_gap_v[j]) {
                best_gap_v[j] = prev_gap;
                gap_size_v[j] = 1;
            } else {
                gap_size_v[j]++;
            }
            const int64_t step_down = best_gap_v[j];
            const int64_t kd = gap_size_v[j];

            prev_gap = curRow[j - 1] + w_open;
            bgh += w_extend;
            if (prev_gap > bgh) {
                bgh = prev_gap;
                gsh = 1;
            } else {
                gsh++;
            }
            const int64_t step_right = bgh;
            const int64_t ki = gsh;

            if (step_diag < step_down || step_diag < step_right) {
                if (step_right >= step_down) {
                    curRow[j] = step_right < kMatrixMinCutoff ? kMatrixMinCutoff
                                                              : step_right;
                    curBt[j] = int32_t(-ki);
                } else {
                    curRow[j] = step_down < kMatrixMinCutoff ? kMatrixMinCutoff
                                                             : step_down;
                    curBt[j] = int32_t(kd);
                }
            } else {
                curRow[j] =
                    step_diag < kMatrixMinCutoff ? kMatrixMinCutoff : step_diag;
                curBt[j] = 0;
            }
        }
        best_gap_h[i] = bgh;
        gap_size_h[i] = gsh;
    }

    // backtrack
    int p1 = 0, p2 = 0;
    int64_t segment_length = 0;
    if (overhang == INDEL) {
        p1 = n;
        p2 = m;
    } else {
        p2 = m;
        int64_t maxscore = INT64_MIN;
        for (int i = 1; i <= n; i++) {
            if (sw[size_t(i) * ylen + m] >= maxscore) {
                p1 = i;
                maxscore = sw[size_t(i) * ylen + m];
            }
        }
        if (overhang != LEADING_INDEL) {
            const int64_t* bottom = &sw[size_t(n) * ylen];
            for (int j = 1; j <= m; j++) {
                const int64_t cur = bottom[j];
                if (cur > maxscore ||
                    (cur == maxscore &&
                     std::abs(n - j) < std::abs(p1 - p2))) {
                    p1 = n;
                    p2 = j;
                    maxscore = cur;
                    segment_length = m - j;
                }
            }
        }
    }

    std::vector<Seg> segs;  // reverse order
    segs.reserve(32);
    if (segment_length > 0 && overhang == SOFTCLIP) {
        segs.push_back({OP_S, int32_t(segment_length)});
        segment_length = 0;
    }

    uint8_t state = OP_M;
    do {
        const int32_t btr = btrack[size_t(p1) * ylen + p2];
        uint8_t new_state;
        int step = 1;
        if (btr > 0) {
            new_state = OP_D;
            step = btr;
        } else if (btr < 0) {
            new_state = OP_I;
            step = -btr;
        } else {
            new_state = OP_M;
        }
        switch (new_state) {
            case OP_M:
                p1--;
                p2--;
                break;
            case OP_I:
                p2 -= step;
                break;
            default:
                p1 -= step;
                break;
        }
        if (new_state == state) {
            segment_length += step;
        } else {
            if (segment_length > 0)
                segs.push_back({state, int32_t(segment_length)});
            segment_length = step;
            state = new_state;
        }
    } while (p1 > 0 && p2 > 0);

    int32_t offset;
    if (overhang == SOFTCLIP) {
        segs.push_back({state, int32_t(segment_length)});
        if (p2 > 0) segs.push_back({OP_S, int32_t(p2)});
        offset = p1;
    } else if (overhang == IGNORE) {
        segs.push_back({state, int32_t(segment_length + p2)});
        offset = p1 - p2;
    } else {
        segs.push_back({state, int32_t(segment_length)});
        if (p1 > 0)
            segs.push_back({OP_D, int32_t(p1)});
        else if (p2 > 0)
            segs.push_back({OP_I, int32_t(p2)});
        offset = 0;
    }

    const int count = int(segs.size());
    if (count > max_cigar) return -1;
    for (int k = 0; k < count; k++) {
        out_ops[k] = segs[count - 1 - k].op;
        out_lens[k] = segs[count - 1 - k].len;
    }
    *out_offset = offset;
    return count;
}
