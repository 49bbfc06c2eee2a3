"""ctypes binding for the fused finalize + assemble region-prep entry."""

import ctypes
import functools

import numpy as np

from . import build, finalize_native

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("assemble")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_prepare_region.restype = ctypes.c_int64
    lib.rovaca_prepare_region.argtypes = [
        ctypes.c_int64, _u8p, _i64p, _i32p, _i32p, _i64p, _i32p, _i64p,
        _i64p, _i32p, _u8p, _i32p, _i64p, _i32p, _u8p, _u8p, _i32p, _i32p,
        ctypes.c_int64, ctypes.c_int64,
        _u8p, ctypes.c_int64, _i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        _i32p, _i64p, _i32p, _i32p, _i64p, _i32p, _u8p, _i32p,
        ctypes.c_int64, _i64p, _i32p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64, _i64p,
        _u8p, ctypes.c_int64, _i64p, _f64p, _i32p, ctypes.c_int64]
    return lib


def available():
    return _lib() is not None


def prepare_region(reads, span_start, span_end, ref_window, kmer_sizes,
                   kmer_step, max_iterations, max_haps=4096, packed=None,
                   src_cols=None, lazy_records=False):
    """Fused finalize + overlap-adjust + kmer-ladder assembly.

    `packed` optionally supplies the pack_reads tuple (ReadColumns.pack).
    Returns (finalized_read_records, {seq: (score, kmer)}) or None on
    unavailability/capacity (caller falls back to the split path).

    With lazy_records=True the first element is a memoized zero-arg
    callable instead: most VCF-mode active regions trim away before ever
    touching their finalized reads, so ReadRecord materialization (the
    dominant Python cost of this path) is deferred until a consumer asks."""
    lib = _lib()
    if lib is None:
        return None
    if packed is None:
        packed = finalize_native.pack_reads(reads)
    n = len(packed[2])
    if n == 0:
        return ((lambda: []) if lazy_records else []), {}
    (names, name_off, flag, ref_id, pos, tlen, mate_pos, cig_off, cig_n,
     cig_ops, cig_lens, seq_off, seq_len, bases, quals, hard_l, hard_r,
     total) = packed
    o = finalize_native.alloc_outputs(n, int(cig_ops.size), total)

    ref_arr = np.frombuffer(ref_window, dtype=np.uint8)
    ks = np.asarray(kmer_sizes, dtype=np.int32)
    hap_cap = max(1 << 20, 2 * max_haps * max(len(ref_window), 1))
    hap_buf = np.empty(hap_cap, dtype=np.uint8)
    hap_off = np.empty(max_haps + 1, dtype=np.int64)
    hap_scores = np.empty(max_haps, dtype=np.float64)
    hap_kmers = np.empty(max_haps, dtype=np.int32)
    n_reads_out = np.zeros(1, dtype=np.int64)

    n_haps = lib.rovaca_prepare_region(
        n, names.ctypes.data_as(_u8p), name_off.ctypes.data_as(_i64p),
        flag.ctypes.data_as(_i32p), ref_id.ctypes.data_as(_i32p),
        pos.ctypes.data_as(_i64p), tlen.ctypes.data_as(_i32p),
        mate_pos.ctypes.data_as(_i64p), cig_off.ctypes.data_as(_i64p),
        cig_n.ctypes.data_as(_i32p), cig_ops.ctypes.data_as(_u8p),
        cig_lens.ctypes.data_as(_i32p), seq_off.ctypes.data_as(_i64p),
        seq_len.ctypes.data_as(_i32p), bases.ctypes.data_as(_u8p),
        quals.ctypes.data_as(_u8p), hard_l.ctypes.data_as(_i32p),
        hard_r.ctypes.data_as(_i32p), span_start, span_end,
        ref_arr.ctypes.data_as(_u8p), ref_arr.size,
        ks.ctypes.data_as(_i32p), len(ks), kmer_step, max_iterations,
        o["o_idx"].ctypes.data_as(_i32p), o["o_pos"].ctypes.data_as(_i64p),
        o["o_hl"].ctypes.data_as(_i32p), o["o_hr"].ctypes.data_as(_i32p),
        o["o_coff"].ctypes.data_as(_i64p), o["o_cn"].ctypes.data_as(_i32p),
        o["o_cops"].ctypes.data_as(_u8p),
        o["o_clens"].ctypes.data_as(_i32p), o["cig_cap"],
        o["o_soff"].ctypes.data_as(_i64p),
        o["o_slen"].ctypes.data_as(_i32p),
        o["o_bases"].ctypes.data_as(_u8p),
        o["o_quals"].ctypes.data_as(_u8p), o["seq_cap"], n,
        n_reads_out.ctypes.data_as(_i64p),
        hap_buf.ctypes.data_as(_u8p), hap_cap,
        hap_off.ctypes.data_as(_i64p), hap_scores.ctypes.data_as(_f64p),
        hap_kmers.ctypes.data_as(_i32p), max_haps)
    if n_haps < 0:
        return None
    if lazy_records:
        n_out = int(n_reads_out[0])
        memo = []

        def fin():
            if not memo:
                memo.append(finalize_native.build_records(
                    reads, n_out, o, src_cols=src_cols))
            return memo[0]

        def _packed_finalized():
            # GVCF fallback consumer: the finalize output slabs flow into
            # the position-obs accumulator as a PackedFinalized, skipping
            # ReadRecord materialization entirely (same arrays the
            # inactive-region fast path uses)
            if src_cols is not None:
                cols, idx = src_cols
                mq = np.ascontiguousarray(cols.mq[idx])
                mate_rid = np.ascontiguousarray(cols.mate_rid[idx])
            else:
                mq = np.fromiter((r.mapping_quality for r in reads),
                                 np.int32, n)
                mate_rid = np.fromiter((r.mate_ref_id for r in reads),
                                       np.int32, n)
            src = dict(flag=flag, ref_id=ref_id, tlen=tlen,
                       mate_pos=mate_pos, mq=mq, mate_ref_id=mate_rid)
            return finalize_native.PackedFinalized(o, n_out, src)

        fin.packed = _packed_finalized
    else:
        fin = finalize_native.build_records(reads, int(n_reads_out[0]), o,
                                            src_cols=src_cols)
    results = {}
    # copy only the filled prefix (hap_cap is >=1MB; n_haps is ~dozens)
    buf = hap_buf[:int(hap_off[n_haps]) if n_haps else 0].tobytes()
    for i in range(n_haps):
        seq = buf[hap_off[i]:hap_off[i + 1]]
        results[seq] = (float(hap_scores[i]), int(hap_kmers[i]))
    return fin, results
