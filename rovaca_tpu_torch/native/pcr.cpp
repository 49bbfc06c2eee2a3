// Native batch PCR/STR gap-penalty model.
//
// Caps per-base gap-open qualities by tandem-repeat context, exactly
// matching rovaca_tpu/ops/pairhmm/prep.py:apply_pcr_error_model /
// find_tandem_repeat_units (reference: src/haplotypecaller/pairhmm/
// pairhmm_internal.cpp:65-159, findTandemRepeatUnits + PCR cap tables).
//
// Batch layout: all reads' bases concatenated into one buffer with per-read
// offsets/lengths; gap quals in a parallel buffer mutated in place.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr int kMaxStrUnitLength = 8;
constexpr int kMaxRepeatLength = 20;

// Count consecutive occurrences of unit[0:ulen] at the end (leading=false,
// scanning backward from tlen) or start (leading=true) of test[0:tlen].
inline int find_number_of_repetitions(const uint8_t* unit, int ulen,
                                      const uint8_t* test, int tlen,
                                      bool leading) {
    if (tlen == 0 || ulen == 0) return 0;
    int n = 0;
    if (leading) {
        int start = 0;
        while (start + ulen <= tlen
               && std::memcmp(test + start, unit, ulen) == 0) {
            ++n;
            start += ulen;
        }
    } else {
        int start = tlen - ulen;
        while (start >= 0 && std::memcmp(test + start, unit, ulen) == 0) {
            ++n;
            start -= ulen;
        }
    }
    return n;
}

// Total tandem-repeat run length around `offset`, capped at
// kMaxRepeatLength (prep.py:find_tandem_repeat_units).
inline int find_tandem_repeat_units(const uint8_t* bases, int n, int offset) {
    int max_bw = 0;
    for (int str_len = 1; str_len <= kMaxStrUnitLength; ++str_len) {
        if (offset + 1 - str_len < 0) break;
        const uint8_t* unit = bases + (offset - str_len + 1);
        max_bw = find_number_of_repetitions(unit, str_len, bases, offset + 1,
                                            /*leading=*/false);
        if (max_bw > 1) break;
    }

    int max_rl = max_bw;
    if (offset < n - 1) {
        // recount unit = best_FW_repeat_unit: stays at its default
        // (offset+1, length 1) unless a forward repeat (count > 1) was
        // found, while max_fw keeps the count of the LAST TRIED unit —
        // exactly pairhmm_internal.cpp:87-111
        const uint8_t* fw_unit = bases + offset + 1;
        int fw_len = 1;
        int max_fw = 0;
        for (int str_len = 1; str_len <= kMaxStrUnitLength; ++str_len) {
            if (offset + str_len + 1 > n) break;
            max_fw = find_number_of_repetitions(bases + offset + 1, str_len,
                                                bases + offset + 1,
                                                n - offset - 1,
                                                /*leading=*/true);
            if (max_fw > 1) {
                fw_len = str_len;
                break;
            }
        }
        max_bw = find_number_of_repetitions(fw_unit, fw_len, bases,
                                            offset + 1, /*leading=*/false);
        max_rl = max_bw + max_fw;
    }

    return std::min(max_rl, kMaxRepeatLength);
}

}  // namespace

extern "C" {

// For each read r: for i in [1, len): gap[i-1] = min(gap[i-1],
// cache[find_tandem_repeat_units(bases, i-1)]). `cache` has
// kMaxRepeatLength+1 entries. Gap quals are modified in place.
void rovaca_pcr_apply_batch(int n_reads, const uint8_t* bases,
                            const int64_t* offsets, const int32_t* lengths,
                            uint8_t* gap_quals, const uint8_t* cache) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int r = 0; r < n_reads; ++r) {
        const uint8_t* b = bases + offsets[r];
        uint8_t* g = gap_quals + offsets[r];
        const int n = lengths[r];
        for (int i = 1; i < n; ++i) {
            const int rep = find_tandem_repeat_units(b, n, i - 1);
            g[i - 1] = std::min(g[i - 1], cache[rep]);
        }
    }
}

}  // extern "C"
