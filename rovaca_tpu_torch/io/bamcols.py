"""Columnar BAM ingestion: decompressed records -> flat column slabs.

The round-4 profile put ~60% of end-to-end wall in per-read Python
`ReadRecord` construction (io/bam.py) plus activity marshaling. This module
is the TPU-native answer to the reference's pooled zero-copy `bam1_t` +
lazy-decode design (reference: src/IOStream/bam1_pool.h:13-60,
src/haplotypecaller/genotype/read_record.h): one native pass scans and
unpacks every record of a chunk into columnar arrays (positions, flags,
cigar run slabs, nibble-decoded base/qual slabs, name/tag byte slabs), the
filter/downsampler/activity stages run on those arrays, and `ReadRecord`
objects are materialized ONLY for reads that reach an active region.

Layout matches the native finalize/assemble ABI (`native/finalize_native
.pack_reads`), so region prep consumes gathered slab views directly.
"""

import ctypes
import functools

import numpy as np

from .. import constants as C
from ..native import bamscan_native, build
from . import bgzf

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)

CHUNK_BYTES = 4 << 20

# HCReadFilter constants (reads_filter_hc.h:15-58)
_FILTER_FLAGS = 0x4 | 0x100 | 0x400 | 0x200  # UNMAP|SECONDARY|DUP|QCFAIL


@functools.lru_cache(maxsize=1)
def _lib():
    path = build.shared_lib("bamscan")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rovaca_bam_extract.restype = None
    lib.rovaca_bam_extract.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _i64p, _i32p, _i32p, _i32p, _i32p,
        _i64p, _i64p, _i64p, _i64p, _u8p, _i32p, _u8p, _u8p, _u8p, _u8p,
        _i64p]
    lib.rovaca_downsample_positions.restype = ctypes.c_int64
    lib.rovaca_downsample_positions.argtypes = [
        _i64p, ctypes.c_int64, ctypes.c_int64, _u64p, ctypes.c_int32, _i64p]
    return lib


def available():
    return _lib() is not None and bamscan_native.available()


def _ranges(lens):
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    bounds = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=bounds[1:])
    return out - bounds[:-1].repeat(lens)


class BamColumns:
    """A batch of reads as flat columns + shared slabs.

    Per-read arrays (length n): flag, ref_id, pos, end, mq, tlen, mate_pos,
    mate_rid, name_off/name_ln, cig_off/cig_n, seq_off/seq_ln,
    tags_off/tags_ln, hard_l, hard_r. Offsets are ABSOLUTE into the shared
    slabs (names, cig_ops, cig_lens, bases, quals, tags), so `select` is a
    cheap per-read-array gather with no slab copies.
    """

    __slots__ = ("n", "contig", "header", "flag", "ref_id", "pos", "end",
                 "mq", "tlen", "mate_pos", "mate_rid", "name_off", "name_ln",
                 "cig_off", "cig_n", "seq_off", "seq_ln", "tags_off",
                 "tags_ln", "hard_l", "hard_r", "names", "cig_ops",
                 "cig_lens", "bases", "quals", "tags")

    def __len__(self):
        return self.n

    # -- pipeline stages ---------------------------------------------------

    def hc_filter_mask(self, min_mq=C.READ_FILTER_MIN_MAPPING_QUALITY,
                       max_mq=C.READ_FILTER_UNAVAILABLE_MAPPING_QUALITY):
        """Vectorized HCReadFilter (reads_filter_hc.h:15-58): flag bits,
        MQ in [min, max), nonzero reference length."""
        return ((self.flag & _FILTER_FLAGS) == 0) \
            & (self.mq >= min_mq) & (self.mq < max_mq) \
            & (self.end > self.pos)

    def select(self, idx):
        """New BamColumns with per-read rows `idx`; slabs shared."""
        out = BamColumns()
        out.n = int(len(idx))
        out.contig = self.contig
        out.header = self.header
        for f in ("flag", "ref_id", "pos", "end", "mq", "tlen", "mate_pos",
                  "mate_rid", "name_off", "name_ln", "cig_off", "cig_n",
                  "seq_off", "seq_ln", "tags_off", "tags_ln", "hard_l",
                  "hard_r"):
            setattr(out, f, getattr(self, f)[idx])
        for f in ("names", "cig_ops", "cig_lens", "bases", "quals", "tags"):
            setattr(out, f, getattr(self, f))
        return out

    def slice(self, i0, i1):
        return self.select(np.arange(i0, i1))

    def pack(self, idx):
        """pack_reads tuple (native finalize/assemble ABI) for rows idx."""
        idx = np.asarray(idx, dtype=np.int64)
        n = idx.size

        nl = self.name_ln[idx].astype(np.int64)
        names = self.names[self.name_off[idx].repeat(nl) + _ranges(nl)]
        name_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(nl, out=name_off[1:])

        cn = self.cig_n[idx].astype(np.int64)
        gi = self.cig_off[idx].repeat(cn) + _ranges(cn)
        cig_ops = np.ascontiguousarray(self.cig_ops[gi])
        cig_lens = np.ascontiguousarray(self.cig_lens[gi])
        cig_off = np.zeros(n, dtype=np.int64)
        np.cumsum(cn[:-1], out=cig_off[1:])

        sl = self.seq_ln[idx].astype(np.int64)
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

    def materialize(self, idx):
        """ReadRecord objects for rows idx (active-region reads only).

        One vectorized gather per ragged payload into compact per-call
        buffers, then cheap python-level slicing per read — never converts
        a whole slab (contig slabs are tens of MB; this runs per region)
        and never touches numpy scalars in the per-read loop."""
        from ..reads.cigar import Cigar, CigarOp
        from ..reads.record import ReadRecord
        from .bam import LazyTags
        idx = np.asarray(idx, dtype=np.int64)
        n = idx.size
        if n == 0:
            return []
        ops_tab = tuple(CigarOp)

        def gather(off_col, len_col, data):
            ln = len_col[idx].astype(np.int64)
            buf = data[off_col[idx].repeat(ln) + _ranges(ln)]
            off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(ln, out=off[1:])
            return buf, off.tolist()

        names_buf, n_off = gather(self.name_off, self.name_ln, self.names)
        names_b = names_buf.tobytes()
        sl = self.seq_ln[idx].astype(np.int64)
        gi = self.seq_off[idx].repeat(sl) + _ranges(sl)
        bases_b = self.bases[gi].tobytes()
        quals_buf = np.ascontiguousarray(self.quals[gi])
        s_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sl, out=s_off[1:])
        s_off = s_off.tolist()
        tags_buf, t_off = gather(self.tags_off, self.tags_ln, self.tags)
        tags_b = tags_buf.tobytes()
        cn = self.cig_n[idx].astype(np.int64)
        ci = self.cig_off[idx].repeat(cn) + _ranges(cn)
        cops = list(map(ops_tab.__getitem__, self.cig_ops[ci].tolist()))
        clens = self.cig_lens[ci].tolist()
        c_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cn, out=c_off[1:])
        c_off = c_off.tolist()

        flags = self.flag[idx].tolist()
        rids = self.ref_id[idx].tolist()
        poss = self.pos[idx].tolist()
        mqs = self.mq[idx].tolist()
        mrids = self.mate_rid[idx].tolist()
        mposs = self.mate_pos[idx].tolist()
        tlens = self.tlen[idx].tolist()

        out = []
        contig = self.contig
        for i in range(n):
            cigar = Cigar.from_raw(
                list(zip(cops[c_off[i]:c_off[i + 1]],
                         clens[c_off[i]:c_off[i + 1]])))
            out.append(ReadRecord(
                name=names_b[n_off[i]:n_off[i + 1]].decode(),
                flag=flags[i], ref_id=rids[i], pos=poss[i],
                mapping_quality=mqs[i], cigar=cigar,
                bases=bases_b[s_off[i]:s_off[i + 1]],
                quals=quals_buf[s_off[i]:s_off[i + 1]],
                mate_ref_id=mrids[i], mate_pos=mposs[i], tlen=tlens[i],
                tags=LazyTags(tags_b[t_off[i]:t_off[i + 1]]),
                contig=contig))
        return out

    def region_pool_bytes(self):
        """Per-read BamDataPool cost for RegionBatchSim (bam_data_pool.hpp:
        37-71): 80 + round8(qname_block + 4*n_cigar + (l+1)//2 + l + aux)."""
        qname_block = (self.name_ln.astype(np.int64) + 1 + 3) // 4 * 4
        l = self.seq_ln.astype(np.int64)
        l_data = (qname_block + 4 * self.cig_n.astype(np.int64)
                  + (l + 1) // 2 + l + self.tags_ln.astype(np.int64))
        return 80 + ((l_data + 7) & ~7)


def _extract_chunk(buf, fields, consumed, header):
    """Native slab extraction for one scanned chunk -> BamColumns (all
    reads, unfiltered, possibly spanning multiple contigs)."""
    lib = _lib()
    n = fields["rec_off"].shape[0]
    cols = BamColumns()
    cols.n = n
    cols.header = header
    cols.contig = None
    cols.flag = fields["flag"]
    cols.ref_id = fields["tid"]
    cols.pos = fields["pos"].astype(np.int64)
    cols.mq = fields["mapq"]
    cols.tlen = fields["tlen"]
    cols.mate_pos = fields["next_pos"].astype(np.int64)
    cols.mate_rid = fields["next_tid"]
    cols.hard_l = np.zeros(n, dtype=np.int32)
    cols.hard_r = np.zeros(n, dtype=np.int32)

    n_cigar = fields["n_cigar"]
    l_seq = fields["l_seq"]
    l_read_name = fields["l_read_name"]
    rec_len = fields["rec_len"]
    cols.cig_n = n_cigar
    cols.seq_ln = l_seq
    cols.name_ln = l_read_name - 1
    body_fixed = (32 + l_read_name.astype(np.int64)
                  + 4 * n_cigar.astype(np.int64)
                  + (l_seq.astype(np.int64) + 1) // 2
                  + l_seq.astype(np.int64))
    cols.tags_ln = (rec_len.astype(np.int64) - body_fixed).astype(np.int64)

    def offs(lens):
        o = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=o[1:], dtype=np.int64)
        return o

    cig_off = offs(n_cigar)
    seq_off = offs(l_seq)
    name_off = offs(cols.name_ln)
    tags_off = offs(cols.tags_ln)
    cols.cig_off, cols.seq_off = cig_off[:-1], seq_off[:-1]
    cols.name_off, cols.tags_off = name_off[:-1], tags_off[:-1]

    cols.cig_ops = np.empty(int(cig_off[-1]), dtype=np.uint8)
    cols.cig_lens = np.empty(int(cig_off[-1]), dtype=np.int32)
    cols.bases = np.empty(int(seq_off[-1]), dtype=np.uint8)
    cols.quals = np.empty(int(seq_off[-1]), dtype=np.uint8)
    cols.names = np.empty(int(name_off[-1]), dtype=np.uint8)
    cols.tags = np.empty(int(tags_off[-1]), dtype=np.uint8)
    ref_len = np.empty(n, dtype=np.int64)

    lib.rovaca_bam_extract(
        buf, n,
        fields["rec_off"].ctypes.data_as(_i64p),
        rec_len.ctypes.data_as(_i32p),
        n_cigar.ctypes.data_as(_i32p), l_seq.ctypes.data_as(_i32p),
        l_read_name.ctypes.data_as(_i32p),
        cols.cig_off.ctypes.data_as(_i64p),
        cols.seq_off.ctypes.data_as(_i64p),
        cols.name_off.ctypes.data_as(_i64p),
        cols.tags_off.ctypes.data_as(_i64p),
        cols.cig_ops.ctypes.data_as(_u8p),
        cols.cig_lens.ctypes.data_as(_i32p),
        cols.bases.ctypes.data_as(_u8p), cols.quals.ctypes.data_as(_u8p),
        cols.names.ctypes.data_as(_u8p), cols.tags.ctypes.data_as(_u8p),
        ref_len.ctypes.data_as(_i64p))
    cols.end = cols.pos + ref_len
    return cols


def _concat_columns(parts, header, contig):
    """Merge per-chunk BamColumns (already row-filtered to one contig) into
    one contig-level batch with dense slabs."""
    if len(parts) == 1:
        out = parts[0]
        out.contig = contig
        return out
    out = BamColumns()
    out.header = header
    out.contig = contig
    out.n = sum(p.n for p in parts)
    for f in ("flag", "ref_id", "mq", "tlen", "mate_rid", "hard_l", "hard_r",
              "cig_n", "seq_ln", "name_ln", "tags_ln", "pos", "end",
              "mate_pos"):
        setattr(out, f, np.concatenate([getattr(p, f) for p in parts]))
    # rebase offsets while concatenating slabs
    for slab, off, ln in (("names", "name_off", "name_ln"),
                          ("cig_ops", "cig_off", "cig_n"),
                          ("bases", "seq_off", "seq_ln"),
                          ("tags", "tags_off", "tags_ln")):
        base = 0
        offs = []
        datas = []
        for p in parts:
            offs.append(getattr(p, off) + base)
            datas.append(getattr(p, slab))
            base += int(datas[-1].size)
        setattr(out, slab, np.concatenate(datas))
        setattr(out, off, np.concatenate(offs))
        if slab == "cig_ops":
            out.cig_lens = np.concatenate([p.cig_lens for p in parts])
        if slab == "bases":
            out.quals = np.concatenate([p.quals for p in parts])
    return out


def stream_contig_columns(path, header=None):
    """Yield (contig, BamColumns) per contig from a coordinate-sorted BAM,
    reading via BGZF chunks + the native scan/extract pass. All reads kept
    (no filtering); columns are materialization-capable."""
    from .bam import BamReader  # header parse reuse
    rd = BamReader(path)
    header = header or rd.header
    fh = rd._fh
    residual = rd._residual or b""
    parts = []            # chunk columns for the current contig
    cur_tid = None

    def flush(tid):
        if not parts:
            return None
        name = header.ref_names[tid] if 0 <= tid < len(header.ref_names) \
            else None
        return name, _concat_columns(parts, header, name)

    while True:
        chunk = fh.read(CHUNK_BYTES)
        if not chunk:
            if residual:
                raise ValueError(f"{path}: truncated BAM record")
            break
        buf = residual + chunk
        # cap must cover every possible record in the buffer (min record
        # size is ~36B) or the scan stalls the stream on dense chunks
        fields, consumed = bamscan_native.scan(buf, cap=len(buf) // 36 + 8)
        residual = buf[consumed:]
        if fields["rec_off"].shape[0] == 0:
            continue
        cols = _extract_chunk(buf, fields, consumed, header)
        # split by contig boundaries within the chunk
        tids = cols.ref_id
        bounds = np.nonzero(np.diff(tids))[0] + 1
        starts = np.concatenate(([0], bounds, [cols.n]))
        for k in range(len(starts) - 1):
            i0, i1 = int(starts[k]), int(starts[k + 1])
            tid = int(tids[i0])
            if cur_tid is not None and tid != cur_tid:
                done = flush(cur_tid)
                parts.clear()
                if done is not None:
                    yield done
            cur_tid = tid
            parts.append(cols.slice(i0, i1) if (i0, i1) != (0, cols.n)
                         else cols)
    if cur_tid is not None:
        done = flush(cur_tid)
        if done is not None:
            yield done
    fh.close()


class ColumnarDownsampler:
    """Positional reservoir downsampler over column batches; Java-LCG
    bit-equal to reads/downsampler.py (state persists across contigs)."""

    def __init__(self, target=C.DOWNSAMPLE_DEFAULT_TARGET):
        self.target = target
        self.state = ctypes.c_uint64(C.DOWNSAMPLER_SEED & C.JAVA_LCG_MASK)

    def keep_indices(self, pos, at_eof):
        """Row indices kept (in reservoir slot order) for one contig's
        position-sorted array."""
        lib = _lib()
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        out = np.empty(pos.size, dtype=np.int64)
        n = lib.rovaca_downsample_positions(
            pos.ctypes.data_as(_i64p), pos.size, self.target,
            ctypes.byref(self.state), 1 if at_eof else 0,
            out.ctypes.data_as(_i64p))
        return out[:n]
