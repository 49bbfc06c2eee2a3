"""ctypes binding for the native local assembler."""

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
    path = build.shared_lib("assemble")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_assemble_region.restype = ctypes.c_int64
    lib.rovaca_assemble_region.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, _u8p, _u8p, _i64p, _i32p,
        _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
        ctypes.c_int64, _i64p, _f64p, _i32p, ctypes.c_int64]
    return lib


def available():
    return _lib() is not None


def assemble_region_paths(reads, ref_window, kmer_sizes, kmer_step,
                          max_iterations, max_out=4096):
    """Native counterpart of assembler.assemble_region's path search.

    Returns {seq_bytes: (score, kmer_size)} in the same contents as the
    Python kmer-ladder + first-wins merge, or None if the native library
    is unavailable or capacity was exceeded (caller falls back)."""
    lib = _lib()
    if lib is None:
        return None
    n = len(reads)
    seq_len = np.fromiter((len(r.bases) for r in reads), np.int32, n) \
        if n else np.zeros(0, np.int32)
    seq_off = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(seq_len[:-1], out=seq_off[1:])
    total = int(seq_len.sum())
    bases = np.frombuffer(b"".join(r.bases for r in reads), dtype=np.uint8) \
        if n else np.zeros(0, np.uint8)
    quals = np.empty(total, dtype=np.uint8)
    for i, r in enumerate(reads):
        quals[seq_off[i]:seq_off[i] + seq_len[i]] = r.quals

    ks = np.asarray(kmer_sizes, dtype=np.int32)
    ref_arr = np.frombuffer(ref_window, dtype=np.uint8)
    out_cap = max(1 << 20, 2 * max_out * max(len(ref_window), 1))
    out_buf = np.empty(out_cap, dtype=np.uint8)
    out_off = np.empty(max_out + 1, dtype=np.int64)
    out_scores = np.empty(max_out, dtype=np.float64)
    out_kmers = np.empty(max_out, dtype=np.int32)

    n_out = lib.rovaca_assemble_region(
        ref_arr.ctypes.data_as(_u8p), ref_arr.size, n,
        bases.ctypes.data_as(_u8p), quals.ctypes.data_as(_u8p),
        seq_off.ctypes.data_as(_i64p), seq_len.ctypes.data_as(_i32p),
        ks.ctypes.data_as(_i32p), len(ks), kmer_step, max_iterations,
        out_buf.ctypes.data_as(_u8p), out_cap,
        out_off.ctypes.data_as(_i64p), out_scores.ctypes.data_as(_f64p),
        out_kmers.ctypes.data_as(_i32p), max_out)
    if n_out < 0:
        return None
    results = {}
    buf = out_buf.tobytes()
    for i in range(n_out):
        seq = buf[out_off[i]:out_off[i + 1]]
        results[seq] = (float(out_scores[i]), int(out_kmers[i]))
    return results
