"""ctypes binding for the native batch activity accumulator."""

import ctypes
import functools

import numpy as np

from . import build

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("activity")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_activity_accumulate.restype = None
    lib.rovaca_activity_accumulate.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i32p, _i32p, _i64p, _i32p, _u8p,
        _i32p, _i64p, _i32p, _u8p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p, _f64p, _i64p]
    return lib


def available():
    return _lib() is not None


def accumulate(win, reads, ref_arr, ref_off):
    """Accumulate every read into win.{hist,hq_sum,hq_n} natively.

    Bit-identical to the Python accumulate_read loop (the oracle —
    tests/test_activity_native.py). ref_arr covers absolute positions
    [ref_off, ref_off + len(ref_arr)).
    """
    lib = _lib()
    n = len(reads)
    if n == 0:
        return
    pos = np.fromiter((r.pos for r in reads), np.int64, n)
    mate_pos = np.fromiter((r.mate_pos for r in reads), np.int64, n)
    tlen = np.fromiter((r.tlen for r in reads), np.int32, n)
    flag = np.fromiter((r.flag for r in reads), np.int32, n)

    ops_l, lens_l, cig_n = [], [], np.empty(n, dtype=np.int32)
    for i, r in enumerate(reads):
        el = r.cigar.elements
        cig_n[i] = len(el)
        for op, ln in el:
            ops_l.append(int(op))
            lens_l.append(ln)
    cig_off = np.zeros(n, dtype=np.int64)
    np.cumsum(cig_n[:-1], out=cig_off[1:])
    cig_ops = np.array(ops_l, dtype=np.uint8)
    cig_lens = np.array(lens_l, dtype=np.int32)

    seq_len = np.fromiter((len(r.bases) for r in reads), np.int32, n)
    seq_off = np.zeros(n, dtype=np.int64)
    np.cumsum(seq_len[:-1], out=seq_off[1:])
    bases = np.frombuffer(b"".join(r.bases for r in reads), dtype=np.uint8)
    total = int(seq_len.sum())
    quals = np.empty(total, dtype=np.uint8)
    for i, r in enumerate(reads):
        quals[seq_off[i]:seq_off[i] + seq_len[i]] = r.quals

    assert win.hist.flags.c_contiguous and win.hist.dtype == np.int32
    ref_c = np.ascontiguousarray(ref_arr, dtype=np.uint8)
    lib.rovaca_activity_accumulate(
        n, pos.ctypes.data_as(_i64p), mate_pos.ctypes.data_as(_i64p),
        tlen.ctypes.data_as(_i32p), flag.ctypes.data_as(_i32p),
        cig_off.ctypes.data_as(_i64p), cig_n.ctypes.data_as(_i32p),
        cig_ops.ctypes.data_as(_u8p), cig_lens.ctypes.data_as(_i32p),
        seq_off.ctypes.data_as(_i64p), seq_len.ctypes.data_as(_i32p),
        bases.ctypes.data_as(_u8p), quals.ctypes.data_as(_u8p),
        ref_c.ctypes.data_as(_u8p), ref_off, ref_c.size,
        win.start, win.end - win.start,
        win.hist.ctypes.data_as(_i32p),
        win.hq_sum.ctypes.data_as(_f64p),
        win.hq_n.ctypes.data_as(_i64p))


def accumulate_cols(win, cols, ref_arr, ref_off):
    """Columnar fast path: accumulate BamColumns rows straight from the
    ingestion slabs (io/bamcols.py) — no per-read marshaling at all.
    Offsets in cols are absolute into the shared slabs, which is exactly
    the ABI rovaca_activity_accumulate consumes."""
    lib = _lib()
    n = cols.n
    if n == 0:
        return
    pos = np.ascontiguousarray(cols.pos, dtype=np.int64)
    mate_pos = np.ascontiguousarray(cols.mate_pos, dtype=np.int64)
    tlen = np.ascontiguousarray(cols.tlen, dtype=np.int32)
    flag = np.ascontiguousarray(cols.flag, dtype=np.int32)
    cig_off = np.ascontiguousarray(cols.cig_off, dtype=np.int64)
    cig_n = np.ascontiguousarray(cols.cig_n, dtype=np.int32)
    seq_off = np.ascontiguousarray(cols.seq_off, dtype=np.int64)
    seq_len = np.ascontiguousarray(cols.seq_ln, dtype=np.int32)

    assert win.hist.flags.c_contiguous and win.hist.dtype == np.int32
    ref_c = np.ascontiguousarray(ref_arr, dtype=np.uint8)
    lib.rovaca_activity_accumulate(
        n, pos.ctypes.data_as(_i64p), mate_pos.ctypes.data_as(_i64p),
        tlen.ctypes.data_as(_i32p), flag.ctypes.data_as(_i32p),
        cig_off.ctypes.data_as(_i64p), cig_n.ctypes.data_as(_i32p),
        cols.cig_ops.ctypes.data_as(_u8p),
        cols.cig_lens.ctypes.data_as(_i32p),
        seq_off.ctypes.data_as(_i64p), seq_len.ctypes.data_as(_i32p),
        cols.bases.ctypes.data_as(_u8p), cols.quals.ctypes.data_as(_u8p),
        ref_c.ctypes.data_as(_u8p), ref_off, ref_c.size,
        win.start, win.end - win.start,
        win.hist.ctypes.data_as(_i32p),
        win.hq_sum.ctypes.data_as(_f64p),
        win.hq_n.ctypes.data_as(_i64p))


def pileup_gls(hist, cache, qual_threshold, ploidy):
    """(gl (L,G) float64, counts (L,) int64) from the (2, L, 64) histogram
    via the sparse native bucket accumulation (reference order); None when
    the native lib is unavailable."""
    import math
    import os
    lib = _lib()
    if lib is None or os.environ.get("ROVACA_NO_NATIVE_ACTIVITY"):
        return None
    if not lib_has_pileup_gls(lib):
        return None
    L = hist.shape[1]
    G = cache.shape[2]
    hist = np.ascontiguousarray(hist, dtype=np.int32)
    cache = np.ascontiguousarray(cache, dtype=np.float64)
    gl = np.empty((L, G), dtype=np.float64)
    counts = np.empty(L, dtype=np.int64)
    lib.rovaca_pileup_gls(
        hist.ctypes.data_as(_i32p), L, cache.ctypes.data_as(_f64p), G,
        qual_threshold, math.log10(ploidy),
        gl.ctypes.data_as(_f64p), counts.ctypes.data_as(_i64p))
    return gl, counts


@functools.lru_cache(maxsize=1)
def lib_has_pileup_gls(lib):
    try:
        fn = lib.rovaca_pileup_gls
    except AttributeError:
        return False
    fn.restype = None
    fn.argtypes = [_i32p, ctypes.c_int64, _f64p, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_double, _f64p, _i64p]
    return True


def pileup_gls_cand(hist, cache, qual_threshold, ploidy):
    """Candidate rows only: (idx (nc,) int64, gl (nc,G) float64,
    counts (nc,) int64) for positions whose variant-state histogram has
    any count above qual_threshold — the only positions that can produce
    nonzero activity. Per-row arithmetic is the exact rovaca_pileup_gls
    sequence. None when the native lib is unavailable."""
    import math
    import os
    lib = _lib()
    if lib is None or os.environ.get("ROVACA_NO_NATIVE_ACTIVITY"):
        return None
    if not _lib_has_pileup_gls_cand(lib):
        return None
    L = hist.shape[1]
    G = cache.shape[2]
    hist = np.ascontiguousarray(hist, dtype=np.int32)
    cache = np.ascontiguousarray(cache, dtype=np.float64)
    idx = np.empty(L, dtype=np.int64)
    gl = np.empty((L, G), dtype=np.float64)
    counts = np.empty(L, dtype=np.int64)
    nc = lib.rovaca_pileup_gls_cand(
        hist.ctypes.data_as(_i32p), L, cache.ctypes.data_as(_f64p), G,
        qual_threshold, math.log10(ploidy), idx.ctypes.data_as(_i64p),
        gl.ctypes.data_as(_f64p), counts.ctypes.data_as(_i64p))
    return idx[:nc], gl[:nc], counts[:nc]


@functools.lru_cache(maxsize=1)
def _lib_has_pileup_gls_cand(lib):
    try:
        fn = lib.rovaca_pileup_gls_cand
    except AttributeError:
        return False
    fn.restype = ctypes.c_int64
    fn.argtypes = [_i32p, ctypes.c_int64, _f64p, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_double, _i64p, _f64p, _i64p]
    return True
