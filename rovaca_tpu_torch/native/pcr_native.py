"""ctypes binding for the native batch PCR/STR gap-penalty model."""

import ctypes
import functools

import numpy as np

from . import build


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("pcr", extra_flags=("-fopenmp",))
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_pcr_apply_batch.restype = None
    lib.rovaca_pcr_apply_batch.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def available():
    return _lib() is not None


def apply_batch(bases_buf, offsets, lengths, gap_quals, cache):
    """Cap gap-open quals by STR context for a batch of reads, in place.

    bases_buf: uint8 array, all reads' bases concatenated
    offsets:   int64 per-read start offsets into bases_buf/gap_quals
    lengths:   int32 per-read lengths
    gap_quals: uint8 array parallel to bases_buf, MUTATED in place
    cache:     uint8 PCR cap table (MAX_REPEAT_LENGTH+1 entries)
    """
    lib = _lib()
    n = int(len(offsets))
    if n == 0:
        return
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.rovaca_pcr_apply_batch(
        n,
        np.ascontiguousarray(bases_buf, dtype=np.uint8)
        .ctypes.data_as(c_u8),
        np.ascontiguousarray(offsets, dtype=np.int64)
        .ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(lengths, dtype=np.int32)
        .ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gap_quals.ctypes.data_as(c_u8),
        np.ascontiguousarray(cache, dtype=np.uint8).ctypes.data_as(c_u8))
