"""ctypes binding for the native Smith-Waterman."""

import ctypes
import functools

import numpy as np

from . import build

MAX_CIGAR = 1024


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("sw", extra_flags=("-fopenmp",))
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_sw_align.restype = ctypes.c_int
    lib.rovaca_sw_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.rovaca_sw_align_batch.restype = None
    lib.rovaca_sw_align_batch.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def available():
    return _lib() is not None


def align_batch(pairs, params, overhang, max_cigar=256):
    """pairs: [(ref_bytes, alt_bytes)]. Returns [(ops, lens, offset)]."""
    lib = _lib()
    n = len(pairs)
    if n == 0:
        return []
    ref_buf = b"".join(p[0] for p in pairs)
    alt_buf = b"".join(p[1] for p in pairs)
    ref_off = np.zeros(n, dtype=np.int64)
    alt_off = np.zeros(n, dtype=np.int64)
    ref_len = np.array([len(p[0]) for p in pairs], dtype=np.int32)
    alt_len = np.array([len(p[1]) for p in pairs], dtype=np.int32)
    np.cumsum(ref_len[:-1], out=ref_off[1:])
    np.cumsum(alt_len[:-1], out=alt_off[1:])
    out_ops = np.zeros(n * max_cigar, dtype=np.uint8)
    out_lens = np.zeros(n * max_cigar, dtype=np.int32)
    out_counts = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n, dtype=np.int32)

    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    as_p = np.ctypeslib.as_ctypes
    lib.rovaca_sw_align_batch(
        n,
        ctypes.cast(ctypes.c_char_p(ref_buf), c_u8),
        ref_off.ctypes.data_as(c_i64), ref_len.ctypes.data_as(c_i32),
        ctypes.cast(ctypes.c_char_p(alt_buf), c_u8),
        alt_off.ctypes.data_as(c_i64), alt_len.ctypes.data_as(c_i32),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        overhang, out_ops.ctypes.data_as(c_u8),
        out_lens.ctypes.data_as(c_i32), max_cigar,
        out_counts.ctypes.data_as(c_i32), out_offsets.ctypes.data_as(c_i32))
    del as_p
    out = []
    for k in range(n):
        c = out_counts[k]
        if c < 0:
            out.append(None)
        else:
            base = k * max_cigar
            out.append((out_ops[base:base + c].copy(),
                        out_lens[base:base + c].copy(),
                        int(out_offsets[k])))
    return out


def align(ref, alt, params, overhang):
    lib = _lib()
    ops = (ctypes.c_uint8 * MAX_CIGAR)()
    lens = (ctypes.c_int32 * MAX_CIGAR)()
    offset = ctypes.c_int32()
    count = lib.rovaca_sw_align(
        ref, len(ref), alt, len(alt), params.match, params.mismatch,
        params.gap_open, params.gap_extend, overhang, ops, lens, MAX_CIGAR,
        ctypes.byref(offset))
    if count < 0:
        raise RuntimeError("native sw_align failed")
    return (np.ctypeslib.as_array(ops)[:count].copy(),
            np.ctypeslib.as_array(lens)[:count].copy(),
            int(offset.value))
