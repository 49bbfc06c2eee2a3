"""ctypes binding for the native GVCF position-observation accumulator."""

import ctypes
import functools

import numpy as np

from . import build

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("posobs")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_build_position_obs.restype = None
    lib.rovaca_build_position_obs.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i32p, _i32p, _i64p, _i32p, _u8p,
        _i32p, _i64p, _i32p, _u8p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p, _i32p,
        _i32p]
    lib.rovaca_build_position_obs_masked.restype = None
    lib.rovaca_build_position_obs_masked.argtypes = [
        ctypes.c_int64, _u8p, _i64p, _i64p, _i32p, _i32p, _i64p, _i32p,
        _u8p, _i32p, _i64p, _i32p, _u8p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p, _i32p,
        _i32p]
    lib.rovaca_build_position_obs_filtered.restype = None
    lib.rovaca_build_position_obs_filtered.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _i32p, ctypes.c_int32,
        ctypes.c_int32, _i64p, _i64p, _i32p, _i32p, _i64p, _i32p,
        _u8p, _i32p, _i64p, _i32p, _u8p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p, _i32p,
        _i32p]
    return lib


def available():
    return _lib() is not None


def build_position_obs_filtered(obs, pk, mq_threshold, padded_ref,
                                padded_start, start, end):
    """Accumulate from a PackedFinalized with the usable-read filter
    (finalize_native.PackedFinalized.usable_mask semantics) computed
    inside the native call — no keep array, no numpy mask machinery.
    Bit-identical to build_position_obs_packed(usable_mask(...))."""
    from .. import constants as C
    lib = _lib()
    o, src = pk.o, pk.src
    n = pk.n
    if n == 0:
        return
    idx = o["o_idx"][:n]
    pos = np.ascontiguousarray(o["o_pos"][:n], dtype=np.int64)
    mate_pos = np.ascontiguousarray(src["mate_pos"][idx], dtype=np.int64)
    tlen = np.ascontiguousarray(src["tlen"][idx], dtype=np.int32)
    flag = np.ascontiguousarray(src["flag"][idx], dtype=np.int32)
    mq = np.ascontiguousarray(src["mq"][idx], dtype=np.int32)
    rid = np.ascontiguousarray(src["ref_id"][idx], dtype=np.int32)
    mrid = np.ascontiguousarray(src["mate_ref_id"][idx], dtype=np.int32)
    cig_off = np.ascontiguousarray(o["o_coff"][:n], dtype=np.int64)
    cig_n = np.ascontiguousarray(o["o_cn"][:n], dtype=np.int32)
    seq_off = np.ascontiguousarray(o["o_soff"][:n], dtype=np.int64)
    seq_len = np.ascontiguousarray(o["o_slen"][:n], dtype=np.int32)

    ref_c = np.ascontiguousarray(padded_ref, dtype=np.uint8)
    lib.rovaca_build_position_obs_filtered(
        n, mq.ctypes.data_as(_i32p), rid.ctypes.data_as(_i32p),
        mrid.ctypes.data_as(_i32p), int(mq_threshold),
        int(C.MIN_READ_LENGTH_AFTER_TRIMMING),
        pos.ctypes.data_as(_i64p), mate_pos.ctypes.data_as(_i64p),
        tlen.ctypes.data_as(_i32p), flag.ctypes.data_as(_i32p),
        cig_off.ctypes.data_as(_i64p), cig_n.ctypes.data_as(_i32p),
        o["o_cops"].ctypes.data_as(_u8p),
        o["o_clens"].ctypes.data_as(_i32p),
        seq_off.ctypes.data_as(_i64p), seq_len.ctypes.data_as(_i32p),
        o["o_bases"].ctypes.data_as(_u8p),
        o["o_quals"].ctypes.data_as(_u8p),
        ref_c.ctypes.data_as(_u8p), ref_c.size, padded_start, start, end,
        obs.hist.ctypes.data_as(_i32p), obs.depth.ctypes.data_as(_i32p),
        obs.indel_informative.ctypes.data_as(_i32p))


def build_position_obs_packed(obs, pk, keep, padded_ref, padded_start,
                              start, end):
    """Accumulate from a PackedFinalized (finalize_native) without
    materializing ReadRecords: the finalize output slabs are passed
    verbatim (offsets are absolute into the shared cigar/sequence slabs)
    with a keep mask — the masked native entry skips filtered rows, so
    no flatten gathers happen on the Python side. Array-identical to the
    record path (integer adds are per-read independent)."""
    lib = _lib()
    o, src = pk.o, pk.src
    n = pk.n
    if n == 0 or not np.any(keep):
        return
    keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
    idx = o["o_idx"][:n]
    pos = np.ascontiguousarray(o["o_pos"][:n], dtype=np.int64)
    mate_pos = np.ascontiguousarray(src["mate_pos"][idx], dtype=np.int64)
    tlen = np.ascontiguousarray(src["tlen"][idx], dtype=np.int32)
    flag = np.ascontiguousarray(src["flag"][idx], dtype=np.int32)
    cig_off = np.ascontiguousarray(o["o_coff"][:n], dtype=np.int64)
    cig_n = np.ascontiguousarray(o["o_cn"][:n], dtype=np.int32)
    seq_off = np.ascontiguousarray(o["o_soff"][:n], dtype=np.int64)
    seq_len = np.ascontiguousarray(o["o_slen"][:n], dtype=np.int32)

    ref_c = np.ascontiguousarray(padded_ref, dtype=np.uint8)
    lib.rovaca_build_position_obs_masked(
        n, keep_u8.ctypes.data_as(_u8p),
        pos.ctypes.data_as(_i64p), mate_pos.ctypes.data_as(_i64p),
        tlen.ctypes.data_as(_i32p), flag.ctypes.data_as(_i32p),
        cig_off.ctypes.data_as(_i64p), cig_n.ctypes.data_as(_i32p),
        o["o_cops"].ctypes.data_as(_u8p),
        o["o_clens"].ctypes.data_as(_i32p),
        seq_off.ctypes.data_as(_i64p), seq_len.ctypes.data_as(_i32p),
        o["o_bases"].ctypes.data_as(_u8p),
        o["o_quals"].ctypes.data_as(_u8p),
        ref_c.ctypes.data_as(_u8p), ref_c.size, padded_start, start, end,
        obs.hist.ctypes.data_as(_i32p), obs.depth.ctypes.data_as(_i32p),
        obs.indel_informative.ctypes.data_as(_i32p))


def build_position_obs(obs, reads, padded_ref, padded_start, start, end):
    """Accumulate into obs.{hist,depth,indel_informative} natively.

    Array-identical to the Python build_position_obs (the oracle —
    tests/test_posobs_native.py)."""
    lib = _lib()
    n = len(reads)
    if n == 0:
        return
    pos = np.fromiter((r.pos for r in reads), np.int64, n)
    mate_pos = np.fromiter((r.mate_pos for r in reads), np.int64, n)
    tlen = np.fromiter((r.tlen for r in reads), np.int32, n)
    flag = np.fromiter((r.flag for r in reads), np.int32, n)

    cig_n = np.empty(n, dtype=np.int32)
    ops_l, lens_l = [], []
    for i, r in enumerate(reads):
        el = r.cigar.elements
        cig_n[i] = len(el)
        ops_l += [e[0] for e in el]     # IntEnum -> int handled by np.array
        lens_l += [e[1] for e in el]
    cig_off = np.zeros(n, dtype=np.int64)
    np.cumsum(cig_n[:-1], out=cig_off[1:])
    cig_ops = np.array(ops_l, dtype=np.uint8)
    cig_lens = np.array(lens_l, dtype=np.int32)

    seq_len = np.fromiter((len(r.bases) for r in reads), np.int32, n)
    seq_off = np.zeros(n, dtype=np.int64)
    np.cumsum(seq_len[:-1], out=seq_off[1:])
    total = int(seq_len.sum())
    bases = np.frombuffer(b"".join(r.bases for r in reads), dtype=np.uint8)
    quals = np.empty(total, dtype=np.uint8)
    for i, r in enumerate(reads):
        quals[seq_off[i]:seq_off[i] + seq_len[i]] = r.quals

    ref_c = np.ascontiguousarray(padded_ref, dtype=np.uint8)
    assert obs.hist.flags.c_contiguous and obs.hist.dtype == np.int32
    assert obs.depth.flags.c_contiguous
    lib.rovaca_build_position_obs(
        n, pos.ctypes.data_as(_i64p), mate_pos.ctypes.data_as(_i64p),
        tlen.ctypes.data_as(_i32p), flag.ctypes.data_as(_i32p),
        cig_off.ctypes.data_as(_i64p), cig_n.ctypes.data_as(_i32p),
        cig_ops.ctypes.data_as(_u8p), cig_lens.ctypes.data_as(_i32p),
        seq_off.ctypes.data_as(_i64p), seq_len.ctypes.data_as(_i32p),
        bases.ctypes.data_as(_u8p), quals.ctypes.data_as(_u8p),
        ref_c.ctypes.data_as(_u8p), ref_c.size, padded_start, start, end,
        obs.hist.ctypes.data_as(_i32p), obs.depth.ctypes.data_as(_i32p),
        obs.indel_informative.ctypes.data_as(_i32p))
