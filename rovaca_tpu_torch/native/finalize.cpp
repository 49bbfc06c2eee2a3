// Native region-read finalization — C++ port of
// assembler.finalize_region_reads + adjust_overlapping_pair_quals and the
// clipping ops they use (rovaca_tpu/reads/clipping.py, the oracle; the
// originals mirror the reference's hc_assemble_reads.c:71-102 /
// hc_assemble_utils.c finalization chain).
//
// Per read: revert (well-paired) or hard-clip soft clips, hard-clip
// low-qual tails (<=9), clip mate-adaptor overruns, hard-clip to the padded
// region span; drop emptied reads; sort by (ref_id, pos, is_reverse, name,
// flag); then cap/zero quals on overlapping mate bases.
// tests/test_finalize_native.py asserts record-level identity vs Python.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <string_view>
#include <vector>

namespace rovaca_fin {

constexpr int kMinTailQuality = 9;     // hc_assemble.h:8
constexpr int kPcrSnvErrorQual = 20;   // hc_assemble_utils.c:17
constexpr int64_t kIns = INT64_MIN / 2;      // insertion sentinel
constexpr int64_t kNeg = INT64_MIN / 2 - 1;  // "no previous M" sentinel

enum Op : uint8_t { M = 0, I = 1, D = 2, N = 3, S = 4, H = 5, P = 6,
                    EQ = 7, X = 8 };

inline bool consumes_query(uint8_t op) {
    return op == M || op == I || op == S || op == EQ || op == X;
}
inline bool consumes_ref(uint8_t op) {
    return op == M || op == D || op == N || op == EQ || op == X;
}

struct CigEl {
    uint8_t op;
    int32_t len;
};

struct FRead {
    int32_t idx = -1;          // original input index
    int64_t pos = 0;
    std::vector<CigEl> cig;
    std::string bases;
    std::string quals;
    int32_t hard_left = 0, hard_right = 0;
    // mirrored input fields
    int32_t flag = 0, ref_id = 0;
    int64_t mate_pos = -1;
    int32_t tlen = 0;
    std::string_view name;

    bool empty() const { return bases.empty() || cig.empty(); }
    bool is_reverse() const { return flag & 0x10; }
    bool is_paired() const { return flag & 0x1; }
    bool is_unmapped() const { return flag & 0x4; }
    bool mate_unmapped() const { return flag & 0x8; }
    bool mate_reverse() const { return flag & 0x20; }

    int64_t ref_len() const {
        int64_t n = 0;
        for (auto& e : cig)
            if (consumes_ref(e.op)) n += e.len;
        return n;
    }
    int64_t end() const { return pos + ref_len(); }
    int32_t left_soft_clip() const {
        for (auto& e : cig) {
            if (e.op == H) continue;
            return e.op == S ? e.len : 0;
        }
        return 0;
    }
    int32_t right_soft_clip() const {
        for (auto it = cig.rbegin(); it != cig.rend(); ++it) {
            if (it->op == H) continue;
            return it->op == S ? it->len : 0;
        }
        return 0;
    }
    int64_t unclipped_start() const {
        int64_t s = pos;
        for (auto& e : cig) {
            if (e.op == S || e.op == H)
                s -= e.len;
            else
                break;
        }
        return s;
    }
};

void normalize(std::vector<CigEl>& cig) {
    std::vector<CigEl> out;
    for (auto& e : cig) {
        if (e.len == 0) continue;
        if (!out.empty() && out.back().op == e.op)
            out.back().len += e.len;
        else
            out.push_back(e);
    }
    cig.swap(out);
}

// per-query-base events: (ref position, is_softclip); kIns for insertions
// (clipping.py _explode)
void explode(const FRead& r, std::vector<int64_t>& refs,
             std::vector<uint8_t>& scs) {
    refs.clear();
    scs.clear();
    int64_t pos = r.pos;
    bool first = true;
    for (auto& e : r.cig) {
        if (e.op == H) continue;
        if (e.op == M || e.op == EQ || e.op == X) {
            for (int32_t i = 0; i < e.len; i++) {
                refs.push_back(pos + i);
                scs.push_back(0);
            }
            pos += e.len;
            first = false;
        } else if (e.op == I) {
            for (int32_t i = 0; i < e.len; i++) {
                refs.push_back(kIns);
                scs.push_back(0);
            }
            first = false;
        } else if (e.op == S) {
            if (first) {
                for (int32_t i = 0; i < e.len; i++) {
                    refs.push_back(pos - e.len + i);
                    scs.push_back(1);
                }
            } else {
                for (int32_t i = 0; i < e.len; i++) {
                    refs.push_back(pos + i);
                    scs.push_back(1);
                }
                pos += e.len;
            }
            first = false;
        } else if (e.op == D || e.op == N) {
            pos += e.len;
        }
    }
}

// clipping.py _rebuild over kept event indices
void rebuild(FRead& r, const std::vector<int64_t>& refs,
             const std::vector<uint8_t>& scs,
             const std::vector<int64_t>& keep) {
    if (keep.empty()) {
        r.bases.clear();
        r.quals.clear();
        r.cig.clear();
        return;
    }
    int64_t n_all = (int64_t)refs.size();
    r.hard_left += (int32_t)keep.front();
    r.hard_right += (int32_t)(n_all - 1 - keep.back());
    std::string nb, nq;
    nb.reserve(keep.size());
    nq.reserve(keep.size());
    for (int64_t k : keep) {
        nb.push_back(r.bases[k]);
        nq.push_back(r.quals[k]);
    }
    std::vector<CigEl> elems;
    int64_t prev_m = kNeg;
    int64_t new_pos = r.pos;
    bool have_pos = false;
    uint8_t cur_op = 255;
    int32_t run = 0;
    for (int64_t k : keep) {
        int64_t ref = refs[k];
        uint8_t opc = scs[k] ? S : (ref == kIns ? I : M);
        int64_t gap = 0;
        if (opc == M) {
            if (prev_m != kNeg && ref - prev_m - 1 > 0) gap = ref - prev_m - 1;
            if (ref > prev_m) prev_m = ref;
            if (!have_pos) {
                new_pos = ref;
                have_pos = true;
            }
        }
        if (opc != cur_op || gap > 0) {
            if (run) elems.push_back({cur_op, run});
            if (gap > 0) elems.push_back({D, (int32_t)gap});
            cur_op = opc;
            run = 0;
        }
        run++;
    }
    if (run) elems.push_back({cur_op, run});
    normalize(elems);
    r.cig.swap(elems);
    r.bases.swap(nb);
    r.quals.swap(nq);
    r.pos = new_pos;
}

void revert_soft_clips(FRead& r) {
    int32_t left = r.left_soft_clip(), right = r.right_soft_clip();
    if (left == 0 && right == 0) return;
    std::vector<CigEl> elems;
    for (auto& e : r.cig) {
        if (e.op == H) continue;
        elems.push_back({e.op == S ? (uint8_t)M : e.op, e.len});
    }
    normalize(elems);
    int64_t pos = r.pos - left;
    r.cig.swap(elems);
    r.pos = pos;
    if (pos < 0) {
        // clamp: drop bases hanging off the contig start; insertions in
        // the negative span survive (clipping.py:163-169)
        std::vector<int64_t> refs;
        std::vector<uint8_t> scs;
        explode(r, refs, scs);
        std::vector<int64_t> keep;
        for (int64_t i = 0; i < (int64_t)refs.size(); i++)
            if (refs[i] == kIns || refs[i] >= 0) keep.push_back(i);
        rebuild(r, refs, scs, keep);
    }
}

void hard_clip_soft_clips(FRead& r) {
    int32_t left = r.left_soft_clip(), right = r.right_soft_clip();
    if (left == 0 && right == 0) return;
    int64_t n = (int64_t)r.bases.size();
    r.bases = r.bases.substr(left, n - right - left);
    r.quals = r.quals.substr(left, n - right - left);
    std::vector<CigEl> elems;
    for (auto& e : r.cig)
        if (e.op != S && e.op != H) elems.push_back(e);
    normalize(elems);
    r.cig.swap(elems);
    r.hard_left += left;
    r.hard_right += right;
}

void clip_low_qual_ends(FRead& r) {
    int64_t n = (int64_t)r.bases.size();
    if (n == 0) return;
    int64_t clip_start = -1, clip_end = -1;
    for (int64_t i = 0; i < n; i++)
        if ((uint8_t)r.quals[i] > kMinTailQuality) {
            clip_start = i;
            break;
        }
    if (clip_start < 0) {
        r.bases.clear();
        r.quals.clear();
        r.cig.clear();
        return;
    }
    for (int64_t i = n - 1; i >= 0; i--)
        if ((uint8_t)r.quals[i] > kMinTailQuality) {
            clip_end = i;
            break;
        }
    if (clip_start == 0 && clip_end == n - 1) return;
    if (clip_end <= clip_start) {
        r.bases.clear();
        r.quals.clear();
        r.cig.clear();
        return;
    }
    std::vector<int64_t> refs;
    std::vector<uint8_t> scs;
    explode(r, refs, scs);
    std::vector<int64_t> keep;
    for (int64_t i = clip_start; i <= clip_end; i++) keep.push_back(i);
    rebuild(r, refs, scs, keep);
}

void hard_clip_to_region(FRead& r, int64_t region_start,
                         int64_t region_end) {
    std::vector<int64_t> refs;
    std::vector<uint8_t> scs;
    explode(r, refs, scs);
    int64_t n = (int64_t)refs.size();
    std::vector<int64_t> keep;
    int64_t last_real_ref = kNeg;
    for (int64_t i = 0; i < n; i++) {
        bool is_ins = refs[i] == kIns;
        int64_t anchor;
        if (is_ins)
            anchor = last_real_ref != kNeg ? last_real_ref : r.pos - 1;
        else {
            anchor = refs[i];
            last_real_ref = refs[i];
        }
        int64_t lo = is_ins ? region_start - 1 : region_start;
        if (anchor >= lo && anchor <= region_end) keep.push_back(i);
    }
    if ((int64_t)keep.size() == n) return;
    rebuild(r, refs, scs, keep);
}

// hc_apply_utils_has_well_defined_fragment_size (hc_assemble_utils.c:67-87):
// the apply side compares against MPOS = mpos + 1 (1-based mate start), so
// both strand branches carry a +1 vs the activity-profile variant.
bool has_well_defined_fragment(const FRead& r) {
    if (r.tlen == 0 || !r.is_paired()) return false;
    if (r.is_unmapped() || r.mate_unmapped()) return false;
    if (r.is_reverse() == r.mate_reverse()) return false;
    if (r.is_reverse()) return r.end() > r.mate_pos + 1;  // bam_endpos > MPOS
    return r.pos <= r.mate_pos + r.tlen + 1;              // pos <= MPOS+isize
}

// hc_apply_utils_hard_clip_adaptor_sequence (hc_assemble_utils.c:93-107).
// The reference computes boundary + in-span gate in its 1-based pos_start
// space (verified against a per-read finalize trace of the binary); in
// 0-based terms: reverse boundary = mate start, gated to (pos, end]; clip
// keeps ref >= mate start.  Forward boundary = pos + |isize|, gated to
// boundary < end; clip keeps ref <= boundary - 1.
void hard_clip_adaptor_sequence(FRead& r) {
    if (!has_well_defined_fragment(r)) return;
    if (r.is_reverse()) {
        int64_t bound = r.mate_pos;
        if (bound <= r.pos || bound > r.end()) return;
        hard_clip_to_region(r, bound, int64_t(1) << 60);
    } else {
        int64_t t = r.tlen;
        int64_t bound = r.pos + (t < 0 ? -t : t);
        if (bound >= r.end()) return;
        hard_clip_to_region(r, -(int64_t(1) << 60), bound - 1);
    }
}

// (read_index, op) covering ref_coord; -1 when not covered
// (record.py index_at_ref_coord)
bool index_at_ref_coord(const FRead& r, int64_t ref_coord, int64_t* out_idx,
                        uint8_t* out_op) {
    int64_t soft_start = r.pos - r.left_soft_clip();
    if (ref_coord < soft_start) return false;
    int64_t rpos = 0, ref = soft_start;
    for (auto& e : r.cig) {
        bool cq = consumes_query(e.op);
        bool cr = consumes_ref(e.op) || e.op == S;
        int64_t first_r = rpos, first_ref = ref;
        if (cq) rpos += e.len;
        if (cr) ref += e.len;
        if (first_ref <= ref_coord && ref_coord < ref) {
            *out_idx = cq ? first_r + (ref_coord - first_ref) : first_r;
            *out_op = e.op;
            return true;
        }
    }
    return false;
}

void adjust_pair(FRead& a, FRead& b) {
    FRead* first = &a;
    FRead* second = &b;
    // strict <: equal soft starts make the SECOND argument the "first"
    if (!(a.unclipped_start() < b.unclipped_start())) {
        first = &b;
        second = &a;
    }
    int64_t first_end = first->end() - 1;
    int64_t second_end = second->end() - 1;
    if (first_end < second->pos || first->ref_id != second->ref_id) return;
    int64_t off1, off2, fe, se;
    uint8_t op1, opx;
    if (!index_at_ref_coord(*first, second->pos, &off1, &op1)) return;
    if (op1 == S || op1 == H) return;
    if (!index_at_ref_coord(*first, first_end, &fe, &opx)) return;
    if (!index_at_ref_coord(*second, second_end, &se, &opx)) return;
    if (!index_at_ref_coord(*second, second->pos, &off2, &opx)) return;
    int64_t nn = std::min(fe - off1, se - off2) + 1;
    for (int64_t i = 0; i < nn; i++) {
        if (first->bases[off1 + i] == second->bases[off2 + i]) {
            if ((uint8_t)first->quals[off1 + i] > kPcrSnvErrorQual)
                first->quals[off1 + i] = kPcrSnvErrorQual;
            if ((uint8_t)second->quals[off2 + i] > kPcrSnvErrorQual)
                second->quals[off2 + i] = kPcrSnvErrorQual;
        } else {
            first->quals[off1 + i] = 0;
            second->quals[off2 + i] = 0;
        }
    }
}

// Full finalize pipeline over decoded input arrays -> sorted FRead vector
inline std::vector<FRead> finalize_impl(
    int64_t n_reads, const uint8_t* names, const int64_t* name_off,
    const int32_t* flag, const int32_t* ref_id, const int64_t* pos,
    const int32_t* tlen, const int64_t* mate_pos, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const int32_t* hard_left,
    const int32_t* hard_right, int64_t span_start, int64_t span_end) {
    std::vector<FRead> fin;
    fin.reserve(n_reads);
    for (int64_t i = 0; i < n_reads; i++) {
        FRead r;
        r.idx = (int32_t)i;
        r.pos = pos[i];
        r.flag = flag[i];
        r.ref_id = ref_id[i];
        r.tlen = tlen[i];
        r.mate_pos = mate_pos[i];
        r.hard_left = hard_left[i];
        r.hard_right = hard_right[i];
        r.name = std::string_view((const char*)names + name_off[i],
                                  name_off[i + 1] - name_off[i]);
        r.cig.reserve(cig_n[i]);
        for (int32_t c = 0; c < cig_n[i]; c++)
            r.cig.push_back(
                {cig_ops[cig_off[i] + c], cig_lens[cig_off[i] + c]});
        r.bases.assign((const char*)bases + seq_off[i], seq_len[i]);
        r.quals.assign((const char*)quals + seq_off[i], seq_len[i]);

        if (has_well_defined_fragment(r))
            revert_soft_clips(r);
        else
            hard_clip_soft_clips(r);
        if (r.empty()) continue;
        clip_low_qual_ends(r);
        if (r.empty()) continue;
        if (!r.is_unmapped()) {
            hard_clip_adaptor_sequence(r);
            if (r.empty()) continue;
        }
        hard_clip_to_region(r, span_start, span_end);
        if (r.empty()) continue;
        fin.push_back(std::move(r));
    }
    std::stable_sort(fin.begin(), fin.end(),
                     [](const FRead& a, const FRead& b) {
                         if (a.ref_id != b.ref_id) return a.ref_id < b.ref_id;
                         if (a.pos != b.pos) return a.pos < b.pos;
                         bool ar = a.is_reverse(), br = b.is_reverse();
                         if (ar != br) return br;  // False < True
                         int c = a.name.compare(b.name);
                         if (c != 0) return c < 0;
                         return a.flag < b.flag;
                     });

    // adjust_overlapping_pair_quals (assembler.py:122-178) on sorted order
    std::vector<std::pair<std::string_view, FRead*>> by_name;
    for (FRead& r : fin) {
        if (!r.is_paired() || r.mate_unmapped() || r.mate_pos < 0 ||
            r.mate_pos + 1 > r.end())
            continue;
        FRead* other = nullptr;
        for (size_t i = 0; i < by_name.size(); i++)
            if (by_name[i].first == r.name) {
                other = by_name[i].second;
                by_name.erase(by_name.begin() + i);
                break;
            }
        if (!other) {
            by_name.emplace_back(r.name, &r);
            continue;
        }
        adjust_pair(*other, r);
    }
    return fin;
}

// Serialize a finalized FRead vector into the flat output arrays.
// Returns n_out or -1 on capacity overflow.
inline int64_t serialize_fin(
    const std::vector<FRead>& fin, int32_t* out_idx, int64_t* out_pos,
    int32_t* out_hard_left, int32_t* out_hard_right, int64_t* out_cig_off,
    int32_t* out_cig_n, uint8_t* out_cig_ops, int32_t* out_cig_lens,
    int64_t out_cig_cap, int64_t* out_seq_off, int32_t* out_seq_len,
    uint8_t* out_bases, uint8_t* out_quals, int64_t out_seq_cap,
    int64_t max_out) {
    if ((int64_t)fin.size() > max_out) return -1;
    int64_t cpos = 0, spos = 0;
    for (size_t i = 0; i < fin.size(); i++) {
        const FRead& r = fin[i];
        out_idx[i] = r.idx;
        out_pos[i] = r.pos;
        out_hard_left[i] = r.hard_left;
        out_hard_right[i] = r.hard_right;
        if (cpos + (int64_t)r.cig.size() > out_cig_cap) return -1;
        out_cig_off[i] = cpos;
        out_cig_n[i] = (int32_t)r.cig.size();
        for (auto& e : r.cig) {
            out_cig_ops[cpos] = e.op;
            out_cig_lens[cpos] = e.len;
            cpos++;
        }
        if (spos + (int64_t)r.bases.size() > out_seq_cap) return -1;
        out_seq_off[i] = spos;
        out_seq_len[i] = (int32_t)r.bases.size();
        std::memcpy(out_bases + spos, r.bases.data(), r.bases.size());
        std::memcpy(out_quals + spos, r.quals.data(), r.quals.size());
        spos += (int64_t)r.bases.size();
    }
    return (int64_t)fin.size();
}

}  // namespace rovaca_fin

// Finalize a region's reads. Outputs survivors in sorted order with
// overlap-adjusted quals. Returns n_out, or -1 on capacity overflow.
extern "C" int64_t rovaca_finalize_region(
    int64_t n_reads, const uint8_t* names, const int64_t* name_off,
    const int32_t* flag, const int32_t* ref_id, const int64_t* pos,
    const int32_t* tlen, const int64_t* mate_pos, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const int32_t* hard_left,
    const int32_t* hard_right, int64_t span_start, int64_t span_end,
    int32_t* out_idx, int64_t* out_pos, int32_t* out_hard_left,
    int32_t* out_hard_right, int64_t* out_cig_off, int32_t* out_cig_n,
    uint8_t* out_cig_ops, int32_t* out_cig_lens, int64_t out_cig_cap,
    int64_t* out_seq_off, int32_t* out_seq_len, uint8_t* out_bases,
    uint8_t* out_quals, int64_t out_seq_cap, int64_t max_out) {
    std::vector<rovaca_fin::FRead> fin = rovaca_fin::finalize_impl(
        n_reads, names, name_off, flag, ref_id, pos, tlen, mate_pos,
        cig_off, cig_n, cig_ops, cig_lens, seq_off, seq_len, bases, quals,
        hard_left, hard_right, span_start, span_end);
    return rovaca_fin::serialize_fin(
        fin, out_idx, out_pos, out_hard_left, out_hard_right, out_cig_off,
        out_cig_n, out_cig_ops, out_cig_lens, out_cig_cap, out_seq_off,
        out_seq_len, out_bases, out_quals, out_seq_cap, max_out);
}
