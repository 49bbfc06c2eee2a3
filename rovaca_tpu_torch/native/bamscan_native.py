"""ctypes binding for the native BAM record scanner."""

import ctypes
import functools

import numpy as np

from . import build


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("bamscan")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.rovaca_bam_scan.restype = ctypes.c_int64
    lib.rovaca_bam_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        p64, p32, p32, p32, p32, p32, p32, p32, p32, p32, p32, p32, p64]
    return lib


def available():
    return _lib() is not None


def scan(buf, cap=1 << 16):
    """Scan complete records from `buf` (bytes). Returns (fields dict of
    arrays sized n, consumed bytes)."""
    lib = _lib()
    names = ("rec_off", "rec_len", "tid", "pos", "mapq", "flag", "n_cigar",
             "l_seq", "l_read_name", "next_tid", "next_pos", "tlen")
    arrays = {"rec_off": np.zeros(cap, dtype=np.int64)}
    for k in names[1:]:
        arrays[k] = np.zeros(cap, dtype=np.int32)
    consumed = ctypes.c_int64()
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.rovaca_bam_scan(
        buf, len(buf), cap,
        arrays["rec_off"].ctypes.data_as(p64),
        arrays["rec_len"].ctypes.data_as(p32),
        arrays["tid"].ctypes.data_as(p32),
        arrays["pos"].ctypes.data_as(p32),
        arrays["mapq"].ctypes.data_as(p32),
        arrays["flag"].ctypes.data_as(p32),
        arrays["n_cigar"].ctypes.data_as(p32),
        arrays["l_seq"].ctypes.data_as(p32),
        arrays["l_read_name"].ctypes.data_as(p32),
        arrays["next_tid"].ctypes.data_as(p32),
        arrays["next_pos"].ctypes.data_as(p32),
        arrays["tlen"].ctypes.data_as(p32),
        ctypes.byref(consumed))
    return {k: v[:n] for k, v in arrays.items()}, int(consumed.value)
