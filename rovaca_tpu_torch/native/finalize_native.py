"""ctypes binding for the native region-read finalizer."""

import ctypes
import functools

import numpy as np

from . import build

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("finalize")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_finalize_region.restype = ctypes.c_int64
    lib.rovaca_finalize_region.argtypes = [
        ctypes.c_int64, _u8p, _i64p, _i32p, _i32p, _i64p, _i32p, _i64p,
        _i64p, _i32p, _u8p, _i32p, _i64p, _i32p, _u8p, _u8p, _i32p, _i32p,
        ctypes.c_int64, ctypes.c_int64,
        _i32p, _i64p, _i32p, _i32p, _i64p, _i32p, _u8p, _i32p,
        ctypes.c_int64, _i64p, _i32p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64]
    return lib


def available():
    return _lib() is not None


def pack_reads(reads):
    """Flat input arrays for the native finalize/prepare entries."""
    n = len(reads)
    name_bytes = [r.name.encode() if isinstance(r.name, str) else r.name
                  for r in reads]
    name_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in name_bytes], out=name_off[1:])
    names = np.frombuffer(b"".join(name_bytes), dtype=np.uint8)

    flag = np.fromiter((r.flag for r in reads), np.int32, n)
    ref_id = np.fromiter((r.ref_id for r in reads), np.int32, n)
    pos = np.fromiter((r.pos for r in reads), np.int64, n)
    tlen = np.fromiter((r.tlen for r in reads), np.int32, n)
    mate_pos = np.fromiter((r.mate_pos for r in reads), np.int64, n)
    hard_l = np.fromiter((r.hard_left for r in reads), np.int32, n)
    hard_r = np.fromiter((r.hard_right for r in reads), np.int32, n)

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
    return (names, name_off, flag, ref_id, pos, tlen, mate_pos, cig_off,
            cig_n, cig_ops, cig_lens, seq_off, seq_len, bases, quals,
            hard_l, hard_r, total)


def alloc_outputs(n, cig_size, total):
    cig_cap = cig_size + 4 * n + 16
    seq_cap = total + 16
    return dict(
        cig_cap=cig_cap, seq_cap=seq_cap,
        o_idx=np.empty(n, dtype=np.int32),
        o_pos=np.empty(n, dtype=np.int64),
        o_hl=np.empty(n, dtype=np.int32),
        o_hr=np.empty(n, dtype=np.int32),
        o_coff=np.empty(n, dtype=np.int64),
        o_cn=np.empty(n, dtype=np.int32),
        o_cops=np.empty(cig_cap, dtype=np.uint8),
        o_clens=np.empty(cig_cap, dtype=np.int32),
        o_soff=np.empty(n, dtype=np.int64),
        o_slen=np.empty(n, dtype=np.int32),
        o_bases=np.empty(seq_cap, dtype=np.uint8),
        o_quals=np.empty(seq_cap, dtype=np.uint8))


def _clone_tags(tags):
    """Copy of a read's tags without forcing a lazy parse: an unforced
    LazyTags clones from its raw payload; anything else copies eagerly."""
    from ..io.bam import LazyTags
    raw = getattr(tags, "_raw", None)
    if raw is not None:
        return LazyTags(raw)
    return dict(tags.items()) if hasattr(tags, "items") else dict(tags)


def build_records(reads, n_out, o, src_cols=None):
    """ReadRecords from the native finalized-read output arrays.

    Source scalars (name/flag/mq/tags/...) come from the `reads` list,
    or — columnar fast path — straight from BamColumns slab gathers when
    src_cols=(cols, row_indices) is given (no intermediate source
    ReadRecord materialization at all)."""
    from ..io.bam import LazyTags
    from ..reads.cigar import Cigar, CigarOp
    from ..reads.record import ReadRecord
    ops_tab = tuple(CigarOp)           # index lookup beats EnumMeta.__call__
    base_buf = o["o_bases"].tobytes()
    o_idx, o_pos = o["o_idx"].tolist(), o["o_pos"].tolist()
    o_coff, o_cn = o["o_coff"].tolist(), o["o_cn"].tolist()
    o_cops, o_clens = o["o_cops"].tolist(), o["o_clens"].tolist()
    o_soff, o_slen = o["o_soff"].tolist(), o["o_slen"].tolist()
    o_hl, o_hr, o_quals = o["o_hl"].tolist(), o["o_hr"].tolist(), o["o_quals"]

    if src_cols is not None:
        cols, idx = src_cols
        rows = np.asarray(idx, dtype=np.int64)[
            np.asarray(o["o_idx"][:n_out], dtype=np.int64)]
        nl = cols.name_ln[rows].astype(np.int64)
        names_b = cols.names[cols.name_off[rows].repeat(nl)
                             + _ranges(nl)].tobytes()
        n_off = np.zeros(n_out + 1, dtype=np.int64)
        np.cumsum(nl, out=n_off[1:])
        n_off = n_off.tolist()
        tl = cols.tags_ln[rows].astype(np.int64)
        tags_b = cols.tags[cols.tags_off[rows].repeat(tl)
                           + _ranges(tl)].tobytes()
        t_off = np.zeros(n_out + 1, dtype=np.int64)
        np.cumsum(tl, out=t_off[1:])
        t_off = t_off.tolist()
        flags = cols.flag[rows].tolist()
        rids = cols.ref_id[rows].tolist()
        mqs = cols.mq[rows].tolist()
        mrids = cols.mate_rid[rows].tolist()
        mposs = cols.mate_pos[rows].tolist()
        tlens = cols.tlen[rows].tolist()
        contig = cols.contig

        out = []
        for i in range(n_out):
            co, cn = o_coff[i], o_cn[i]
            cigar = Cigar.from_raw(
                [(ops_tab[o_cops[co + j]], o_clens[co + j])
                 for j in range(cn)])
            so, sl = o_soff[i], o_slen[i]
            rec = ReadRecord(
                name=names_b[n_off[i]:n_off[i + 1]].decode(),
                flag=flags[i], ref_id=rids[i],
                pos=int(o_pos[i]), mapping_quality=mqs[i],
                cigar=cigar, bases=base_buf[so:so + sl],
                quals=o_quals[so:so + sl].copy(),
                mate_ref_id=mrids[i], mate_pos=mposs[i],
                tlen=tlens[i], tags=LazyTags(tags_b[t_off[i]:t_off[i + 1]]),
                contig=contig,
                hard_left=int(o_hl[i]), hard_right=int(o_hr[i]))
            rec._quals_private = True
            out.append(rec)
        return out

    out = []
    for i in range(n_out):
        src = reads[o_idx[i]]
        co, cn = o_coff[i], o_cn[i]
        cigar = Cigar.from_raw([(ops_tab[o_cops[co + j]], o_clens[co + j])
                                for j in range(cn)])
        so, sl = o_soff[i], o_slen[i]
        rec = ReadRecord(
            name=src.name, flag=src.flag, ref_id=src.ref_id,
            pos=int(o_pos[i]), mapping_quality=src.mapping_quality,
            cigar=cigar, bases=base_buf[so:so + sl],
            quals=o_quals[so:so + sl].copy(),
            mate_ref_id=src.mate_ref_id, mate_pos=src.mate_pos,
            tlen=src.tlen, tags=_clone_tags(src.tags), contig=src.contig,
            hard_left=int(o_hl[i]), hard_right=int(o_hr[i]))
        rec._quals_private = True
        out.append(rec)
    return out


class PackedFinalized:
    """Finalized region reads as flat arrays — no ReadRecord
    materialization. `o` is the alloc_outputs dict filled by the native
    finalizer (n_out rows); `src` carries per-SOURCE-read scalars
    (indexed through o['o_idx']) that finalize never changes."""

    __slots__ = ("o", "n", "src")

    def __init__(self, o, n, src):
        self.o, self.n, self.src = o, n, src

    def usable_mask(self, mapping_quality_threshold):
        """filter_non_passing_reads2 (adapter_utils.cpp:240-251) over the
        packed rows: unclipped length, mapping quality, mate contig."""
        from .. import constants as C
        o, src = self.o, self.src
        idx = o["o_idx"][:self.n]
        flag = src["flag"][idx]
        mq = src["mq"][idx]
        slen = o["o_slen"][:self.n].astype(np.int64)
        # soft-clipped bases per finalized read (vectorized reduceat)
        cn = o["o_cn"][:self.n].astype(np.int64)
        coff = o["o_coff"][:self.n]
        total = int(cn.sum())
        if total:
            gi = coff.repeat(cn) + _ranges(cn)
            s_len = np.where(o["o_cops"][gi] == 4,       # CigarOp.S
                             o["o_clens"][gi], 0)
            bounds = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(cn, out=bounds[1:])
            sc = np.add.reduceat(
                np.concatenate((s_len, [0])), bounds[:-1])
            sc[cn == 0] = 0
        else:
            sc = np.zeros(self.n, dtype=np.int64)
        unclipped = slen - sc
        paired = (flag & 1) != 0
        unmapped = (flag & 4) != 0
        mate_unmapped = (flag & 8) != 0
        mate_ok = (~paired) | mate_unmapped | (
            (~unmapped) & (src["ref_id"][idx] == src["mate_ref_id"][idx]))
        return ((unclipped >= C.MIN_READ_LENGTH_AFTER_TRIMMING)
                & (mq >= mapping_quality_threshold) & mate_ok)


def _ranges(lens):
    """concatenate([arange(l) for l in lens]) without the Python loop."""
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    bounds = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=bounds[1:])
    return out - bounds[:-1].repeat(lens)


def _call_finalize(lib, reads, span_start, span_end, packed=None):
    if packed is None:
        packed = pack_reads(reads)
    n = len(packed[2])  # flag column rows (reads may be None with packed)
    (names, name_off, flag, ref_id, pos, tlen, mate_pos, cig_off, cig_n,
     cig_ops, cig_lens, seq_off, seq_len, bases, quals, hard_l, hard_r,
     total) = packed
    o = alloc_outputs(n, int(cig_ops.size), total)
    n_out = lib.rovaca_finalize_region(
        n, names.ctypes.data_as(_u8p), name_off.ctypes.data_as(_i64p),
        flag.ctypes.data_as(_i32p), ref_id.ctypes.data_as(_i32p),
        pos.ctypes.data_as(_i64p), tlen.ctypes.data_as(_i32p),
        mate_pos.ctypes.data_as(_i64p), cig_off.ctypes.data_as(_i64p),
        cig_n.ctypes.data_as(_i32p), cig_ops.ctypes.data_as(_u8p),
        cig_lens.ctypes.data_as(_i32p), seq_off.ctypes.data_as(_i64p),
        seq_len.ctypes.data_as(_i32p), bases.ctypes.data_as(_u8p),
        quals.ctypes.data_as(_u8p), hard_l.ctypes.data_as(_i32p),
        hard_r.ctypes.data_as(_i32p), span_start, span_end,
        o["o_idx"].ctypes.data_as(_i32p),
        o["o_pos"].ctypes.data_as(_i64p),
        o["o_hl"].ctypes.data_as(_i32p), o["o_hr"].ctypes.data_as(_i32p),
        o["o_coff"].ctypes.data_as(_i64p), o["o_cn"].ctypes.data_as(_i32p),
        o["o_cops"].ctypes.data_as(_u8p),
        o["o_clens"].ctypes.data_as(_i32p), o["cig_cap"],
        o["o_soff"].ctypes.data_as(_i64p),
        o["o_slen"].ctypes.data_as(_i32p),
        o["o_bases"].ctypes.data_as(_u8p),
        o["o_quals"].ctypes.data_as(_u8p), o["seq_cap"], n)
    return o, n_out, (flag, ref_id, tlen, mate_pos)


def finalize_region_packed(reads, span_start, span_end, cols_idx=None):
    """Native finalize to PackedFinalized arrays (GVCF inactive-region
    fast path: the position-obs accumulator consumes these directly).
    cols_idx=(ReadColumns, row indices) supplies a pre-gathered pack.
    Returns None when unavailable/capacity exceeded or no reads."""
    lib = _lib()
    if lib is None:
        return None
    packed = mq = mate_rid = None
    if cols_idx is not None:
        cols, idx = cols_idx
        if len(idx) == 0:
            return None
        packed = cols.pack(idx)
        mq = np.ascontiguousarray(cols.mq[idx])
        mate_rid = np.ascontiguousarray(cols.mate_rid[idx])
    elif not reads:
        return None
    o, n_out, (flag, ref_id, tlen, mate_pos) = _call_finalize(
        lib, reads, span_start, span_end, packed=packed)
    if n_out < 0:
        return None
    if mq is None:
        n = len(reads)
        mq = np.fromiter((r.mapping_quality for r in reads), np.int32, n)
        mate_rid = np.fromiter((r.mate_ref_id for r in reads), np.int32, n)
    src = dict(flag=flag, ref_id=ref_id, tlen=tlen, mate_pos=mate_pos,
               mq=mq, mate_ref_id=mate_rid)
    return PackedFinalized(o, int(n_out), src)


def finalize_region(reads, span_start, span_end):
    """Native finalize_region_reads + adjust_overlapping_pair_quals.

    Returns a list of new ReadRecords (sorted, quals overlap-adjusted), or
    None when the native library is unavailable/capacity exceeded."""
    lib = _lib()
    if lib is None:
        return None
    if not reads:
        return []
    o, n_out, _src = _call_finalize(lib, reads, span_start, span_end)
    if n_out < 0:
        return None
    return build_records(reads, n_out, o)


# ---------------------------------------------------------------------------
# contig-wide columnar read cache: pack_reads via numpy gathers
# ---------------------------------------------------------------------------

class ReadColumns:
    """One pass over a contig's reads into flat columns; per-region
    pack_reads tuples then come from numpy gathers instead of per-read
    Python attribute access (pipeline/caller.py builds one per contig and
    hands each region its row indices)."""

    def __init__(self, reads):
        n = len(reads)
        self.reads = reads
        flag = np.empty(n, dtype=np.int32)
        ref_id = np.empty(n, dtype=np.int32)
        pos = np.empty(n, dtype=np.int64)
        tlen = np.empty(n, dtype=np.int32)
        mate_pos = np.empty(n, dtype=np.int64)
        hard_l = np.empty(n, dtype=np.int32)
        hard_r = np.empty(n, dtype=np.int32)
        mq = np.empty(n, dtype=np.int32)
        mate_rid = np.empty(n, dtype=np.int32)
        name_ln = np.empty(n, dtype=np.int64)
        cig_n = np.empty(n, dtype=np.int64)
        seq_ln = np.empty(n, dtype=np.int64)
        names_l, ops_l, lens_l, bases_l = [], [], [], []
        quals_l = []
        for i, r in enumerate(reads):
            flag[i] = r.flag
            ref_id[i] = r.ref_id
            pos[i] = r.pos
            tlen[i] = r.tlen
            mate_pos[i] = r.mate_pos
            hard_l[i] = r.hard_left
            hard_r[i] = r.hard_right
            mq[i] = r.mapping_quality
            mate_rid[i] = r.mate_ref_id
            nb = r.name.encode() if isinstance(r.name, str) else r.name
            names_l.append(nb)
            name_ln[i] = len(nb)
            el = r.cigar.elements
            cig_n[i] = len(el)
            ops_l += [e[0] for e in el]
            lens_l += [e[1] for e in el]
            b = r.bases
            bases_l.append(b if isinstance(b, bytes) else bytes(b))
            seq_ln[i] = len(b)
            quals_l.append(r.quals)
        self.flag, self.ref_id, self.pos, self.tlen = flag, ref_id, pos, tlen
        self.mate_pos, self.hard_l, self.hard_r = mate_pos, hard_l, hard_r
        self.mq, self.mate_rid = mq, mate_rid
        self.name_ln, self.cig_n, self.seq_ln = name_ln, cig_n, seq_ln
        self.names = np.frombuffer(b"".join(names_l), dtype=np.uint8)
        self.name_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(name_ln, out=self.name_off[1:])
        self.cig_ops = np.array(ops_l, dtype=np.uint8)
        self.cig_lens = np.array(lens_l, dtype=np.int32)
        self.cig_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cig_n, out=self.cig_off[1:])
        self.bases = np.frombuffer(b"".join(bases_l), dtype=np.uint8)
        self.seq_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(seq_ln, out=self.seq_off[1:])
        total = int(self.seq_off[-1])
        self.quals = np.empty(total, dtype=np.uint8)
        for i, q in enumerate(quals_l):
            self.quals[self.seq_off[i]:self.seq_off[i + 1]] = q

    def pack(self, idx):
        """pack_reads tuple for rows `idx` (any int array, region order)."""
        idx = np.asarray(idx, dtype=np.int64)
        n = idx.size

        nl = self.name_ln[idx]
        names = self.names[self.name_off[idx].repeat(nl) + _ranges(nl)]
        name_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(nl, out=name_off[1:])

        cn = self.cig_n[idx]
        gi = self.cig_off[idx].repeat(cn) + _ranges(cn)
        cig_ops = np.ascontiguousarray(self.cig_ops[gi])
        cig_lens = np.ascontiguousarray(self.cig_lens[gi])
        cig_off = np.zeros(n, dtype=np.int64)
        np.cumsum(cn[:-1], out=cig_off[1:])

        sl = self.seq_ln[idx]
        si = self.seq_off[idx].repeat(sl) + _ranges(sl)
        bases = np.ascontiguousarray(self.bases[si])
        quals = np.ascontiguousarray(self.quals[si])
        seq_off = np.zeros(n, dtype=np.int64)
        np.cumsum(sl[:-1], out=seq_off[1:])
        total = int(sl.sum())

        return (names, name_off,
                np.ascontiguousarray(self.flag[idx]),
                np.ascontiguousarray(self.ref_id[idx]),
                np.ascontiguousarray(self.pos[idx]),
                np.ascontiguousarray(self.tlen[idx]),
                np.ascontiguousarray(self.mate_pos[idx]),
                cig_off, cn.astype(np.int32), cig_ops, cig_lens,
                seq_off, sl.astype(np.int32), bases, quals,
                np.ascontiguousarray(self.hard_l[idx]),
                np.ascontiguousarray(self.hard_r[idx]), total)
