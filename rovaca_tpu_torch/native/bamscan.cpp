// BAM record scanner — native fast path for the BAM reader.
//
// Takes a buffer of decompressed BAM alignment records and extracts the
// fixed-size fields of every complete record in one pass, so Python only
// slices payloads (name/cigar/seq/qual/tags) lazily per record.
// (Counterpart of the hot part of the reference's htslib-backed BamLoader,
// reference: src/IOStream/bam_loader.cpp:118-142.)

#include <cstdint>
#include <cstring>

namespace {
inline int32_t rd_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
inline uint16_t rd_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}
}  // namespace

// Scans complete records in buf[0..len). Returns the number of records
// written (<= cap) and sets *consumed to the byte count of fully-scanned
// records (callers keep the tail for the next chunk).
extern "C" int64_t rovaca_bam_scan(
    const uint8_t* buf, int64_t len, int64_t cap, int64_t* rec_off,
    int32_t* rec_len, int32_t* tid, int32_t* pos, int32_t* mapq,
    int32_t* flag, int32_t* n_cigar, int32_t* l_seq, int32_t* l_read_name,
    int32_t* next_tid, int32_t* next_pos, int32_t* tlen, int64_t* consumed) {
    int64_t off = 0;
    int64_t n = 0;
    while (n < cap && off + 4 <= len) {
        const int32_t block_size = rd_i32(buf + off);
        if (block_size < 32 || off + 4 + block_size > len) break;
        const uint8_t* r = buf + off + 4;
        rec_off[n] = off + 4;
        rec_len[n] = block_size;
        tid[n] = rd_i32(r + 0);
        pos[n] = rd_i32(r + 4);
        l_read_name[n] = r[8];
        mapq[n] = r[9];
        n_cigar[n] = rd_u16(r + 12);
        flag[n] = rd_u16(r + 14);
        l_seq[n] = rd_i32(r + 16);
        next_tid[n] = rd_i32(r + 20);
        next_pos[n] = rd_i32(r + 24);
        tlen[n] = rd_i32(r + 28);
        off += 4 + block_size;
        n++;
    }
    *consumed = off;
    return n;
}

// ---------------------------------------------------------------------------
// Columnar extract: unpack scanned records straight into flat column slabs
// (cigar ops/lens, nibble-decoded bases, quals, names, raw tags) plus the
// reference-consumed length per read. Role of the reference's lazy bam1_t
// field decode (src/haplotypecaller/genotype/read_record.h) — done once,
// batched, with no per-read Python objects.
// ---------------------------------------------------------------------------

static const char kSeqNt16[17] = "=ACMGRSVTWYHKDBN";

extern "C" void rovaca_bam_extract(
    const uint8_t* buf, int64_t n, const int64_t* rec_off,
    const int32_t* rec_len, const int32_t* n_cigar, const int32_t* l_seq,
    const int32_t* l_read_name, const int64_t* cig_off,
    const int64_t* seq_off, const int64_t* name_off, const int64_t* tags_off,
    uint8_t* cig_ops, int32_t* cig_lens, uint8_t* bases, uint8_t* quals,
    uint8_t* names, uint8_t* tags, int64_t* ref_len) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* body = buf + rec_off[i];
        int64_t p = 32;
        const int32_t lname = l_read_name[i];
        std::memcpy(names + name_off[i], body + p, (size_t)(lname - 1));
        p += lname;
        const int32_t nc = n_cigar[i];
        int64_t rl = 0;
        uint8_t* co = cig_ops + cig_off[i];
        int32_t* cl = cig_lens + cig_off[i];
        for (int32_t k = 0; k < nc; ++k) {
            uint32_t c;
            std::memcpy(&c, body + p + 4 * (int64_t)k, 4);
            const uint8_t op = (uint8_t)(c & 0xF);
            const int32_t len = (int32_t)(c >> 4);
            co[k] = op;
            cl[k] = len;
            // M=0, D=2, N=3, EQ=7, X=8 consume reference
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rl += len;
        }
        p += 4 * (int64_t)nc;
        const int32_t ls = l_seq[i];
        const uint8_t* sp = body + p;
        uint8_t* bo = bases + seq_off[i];
        for (int32_t j = 0; j + 1 < ls; j += 2) {
            const uint8_t b = sp[j >> 1];
            bo[j] = (uint8_t)kSeqNt16[b >> 4];
            bo[j + 1] = (uint8_t)kSeqNt16[b & 0xF];
        }
        if (ls & 1) bo[ls - 1] = (uint8_t)kSeqNt16[sp[(ls - 1) >> 1] >> 4];
        p += (ls + 1) / 2;
        std::memcpy(quals + seq_off[i], body + p, (size_t)ls);
        p += ls;
        const int64_t taglen = (int64_t)rec_len[i] - p;
        if (taglen > 0) std::memcpy(tags + tags_off[i], body + p,
                                    (size_t)taglen);
        ref_len[i] = rl;
    }
}

// ---------------------------------------------------------------------------
// Positional downsampler over a coordinate-sorted position column.
// Bit-exact port of the Java-LCG reservoir (reference:
// src/common/downsampler_hc.h:10-13,94-210 — multiplier 0x5DEECE66D,
// addend 0xB, raw-seeded state): reads sharing an alignment start form a
// group; groups larger than `target` reservoir-sample with java.util.Random
// semantics; output order within a group is reservoir SLOT order. When
// at_eof, only the FIRST kept read of the final group survives (the
// reference iterator's end-of-stream tail loss, reads_stream.h:238).
// Returns the number of kept rows written to out_idx.
// ---------------------------------------------------------------------------

namespace {
struct JavaLcg {
    uint64_t state;
    int32_t next_bits(int bits) {
        state = (state * 0x5DEECE66DULL + 0xBULL) & ((1ULL << 48) - 1);
        return (int32_t)(state >> (48 - bits));
    }
    int32_t next_int(int32_t bound) {
        int32_t r = next_bits(31);
        const int32_t m = bound - 1;
        if ((bound & m) == 0) return (int32_t)(((int64_t)bound * r) >> 31);
        int32_t u = r;
        r = u % bound;
        while ((int32_t)(u - r + m) < 0) {
            u = next_bits(31);
            r = u % bound;
        }
        return r;
    }
};
}  // namespace

extern "C" int64_t rovaca_downsample_positions(
    const int64_t* pos, int64_t n, int64_t target, uint64_t* state_io,
    int32_t at_eof, int64_t* out_idx) {
    JavaLcg rng{*state_io};
    int64_t n_out = 0;
    int64_t i = 0;
    int64_t last_group_start = -1;  // offset in out_idx of the final group
    while (i < n) {
        int64_t j = i;
        while (j < n && pos[j] == pos[i]) ++j;
        const int64_t k = j - i;
        last_group_start = n_out;
        if (k <= target) {
            for (int64_t t = i; t < j; ++t) out_idx[n_out++] = t;
        } else {
            // reservoir of row indices, slot order preserved on output
            for (int64_t t = 0; t < target; ++t) out_idx[n_out + t] = i + t;
            for (int64_t t = target; t < k; ++t) {
                const int32_t slot = rng.next_int((int32_t)(t + 1));
                if (slot < target) out_idx[n_out + slot] = i + t;
            }
            n_out += target;
        }
        i = j;
    }
    if (at_eof && last_group_start >= 0) {
        // keep only the first kept read of the stream's final group
        n_out = last_group_start + 1;
    }
    *state_io = rng.state;
    return n_out;
}
