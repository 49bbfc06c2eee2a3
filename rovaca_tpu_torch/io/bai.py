"""BAI index: read, query, and build (samtools-index equivalent).

Serves the role of htslib's bam index layer used by the reference for
targeted iteration (reference: src/IOStream/bam_loader.cpp:63-91,
sam_itr_regarray/sam_itr_querys): given intervals, seek straight to the
overlapping records instead of scanning the whole file.

Format: SAM spec section 5.2 — per reference a set of R-tree bins (6
levels, 512 Mbp span) each holding (virtual-offset begin, end) chunks,
plus a 16 kbp-window linear index of smallest virtual offsets. A virtual
offset packs (compressed block offset << 16 | offset within decompressed
block).
"""

import os
import struct
import zlib

MAGIC = b"BAI\x01"
PSEUDO_BIN = 37450
LINEAR_SHIFT = 14  # 16 kbp windows
MAX_BIN_SPAN = 1 << 29


def reg2bin(beg, end):
    """Smallest bin containing [beg, end) (SAM spec 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg, end):
    """All bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


class BaiIndex:
    """Parsed .bai: per-ref {bin: [(vbeg, vend)]} + linear ioffsets."""

    def __init__(self, bins_per_ref, linear_per_ref, n_no_coor=0):
        self.bins = bins_per_ref
        self.linear = linear_per_ref
        self.n_no_coor = n_no_coor

    @classmethod
    def load(cls, path):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != MAGIC:
            raise ValueError(f"{path}: not a BAI index")
        (n_ref,) = struct.unpack_from("<i", data, 4)
        off = 8
        bins_per_ref, linear_per_ref = [], []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    vbeg, vend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((vbeg, vend))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            bins_per_ref.append(bins)
            linear_per_ref.append(linear)
        n_no_coor = 0
        if off + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, off)
        return cls(bins_per_ref, linear_per_ref, n_no_coor)

    def query(self, ref_id, beg, end):
        """Merged, sorted (vbeg, vend) chunk list overlapping [beg, end)."""
        if not (0 <= ref_id < len(self.bins)) or beg >= end:
            return []
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        win = beg >> LINEAR_SHIFT
        min_off = linear[win] if win < len(linear) else 0
        chunks = []
        for b in reg2bins(beg, min(end, MAX_BIN_SPAN)):
            for vbeg, vend in bins.get(b, ()):
                if vend > min_off:
                    chunks.append((max(vbeg, min_off), vend))
        chunks.sort()
        merged = []
        for vbeg, vend in chunks:
            # merge chunks that touch or share a compressed block
            if merged and vbeg >> 16 <= merged[-1][1] >> 16:
                merged[-1][1] = max(merged[-1][1], vend)
            else:
                merged.append([vbeg, vend])
        return [tuple(c) for c in merged]

    def save(self, path):
        out = bytearray(MAGIC)
        out += struct.pack("<i", len(self.bins))
        for bins, linear in zip(self.bins, self.linear):
            out += struct.pack("<i", len(bins))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for vbeg, vend in chunks:
                    out += struct.pack("<QQ", vbeg, vend)
            out += struct.pack("<i", len(linear))
            out += struct.pack(f"<{len(linear)}Q", *linear)
        out += struct.pack("<Q", self.n_no_coor)
        # write-then-rename so a crash or disk-full mid-write never leaves a
        # truncated index that later runs would trust (os.path.exists guards)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                fh.write(out)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


# --- raw BGZF block walking -------------------------------------------------

def _read_block(fh):
    """One BGZF block at the current file offset ->
    (payload, compressed_size); (None, 0) at EOF."""
    header = fh.read(18)
    if len(header) < 18:
        return None, 0
    if header[:2] != b"\x1f\x8b":
        raise ValueError("bad BGZF block magic")
    # BC subfield carries total block size - 1; standard bgzf emits XLEN=6
    xlen = struct.unpack_from("<H", header, 10)[0]
    extra = header[12:12 + 6] + (fh.read(xlen - 6) if xlen > 6 else b"")
    bsize = None
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from(
            "<H", extra, off + 2)[0]
        if si1 == 0x42 and si2 == 0x43:
            bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
            break
        off += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing BC size field")
    comp = fh.read(bsize - 12 - xlen - 8)
    fh.read(8)  # crc + isize
    payload = zlib.decompress(comp, -15)
    return payload, bsize


def _record_spans(bam_path):
    """Yield (vbeg, vend, ref_id, pos, ref_end) per alignment record by
    walking the BGZF blocks, tracking virtual offsets."""
    with open(bam_path, "rb") as fh:
        coffset = 0
        buf = bytearray()
        # (start index in `buf` coordinate space, block coffset)
        blocks = []
        trimmed = 0  # bytes trimmed off the front of buf so far

        def voffset(abs_pos):
            lo = 0
            for start, coff in reversed(blocks):
                if start <= abs_pos:
                    return (coff << 16) | (abs_pos - start)
                lo = start
            raise AssertionError(f"no block covers {abs_pos} (first {lo})")

        def fill(need_abs):
            nonlocal coffset
            while trimmed + len(buf) < need_abs:
                payload, csize = _read_block(fh)
                if payload is None:
                    return False
                blocks.append((trimmed + len(buf), coffset))
                buf.extend(payload)
                coffset += csize
            return True

        # skip BAM header: magic, text, refs
        if not fill(12):
            raise ValueError(f"{bam_path}: truncated")
        if bytes(buf[:4]) != b"BAM\x01":
            raise ValueError(f"{bam_path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        pos_abs = 8 + l_text
        fill(pos_abs + 4)
        (n_ref,) = struct.unpack_from("<i", buf, pos_abs - trimmed)
        pos_abs += 4
        for _ in range(n_ref):
            fill(pos_abs + 4)
            (l_name,) = struct.unpack_from("<i", buf, pos_abs - trimmed)
            pos_abs += 4 + l_name + 4
        while True:
            if not fill(pos_abs + 4):
                return
            (rec_len,) = struct.unpack_from("<i", buf, pos_abs - trimmed)
            if not fill(pos_abs + 4 + rec_len):
                raise ValueError(f"{bam_path}: truncated record")
            base = pos_abs - trimmed + 4
            ref_id, pos = struct.unpack_from("<ii", buf, base)
            (l_read_name,) = struct.unpack_from("<B", buf, base + 8)
            (n_cigar,) = struct.unpack_from("<H", buf, base + 12)
            span = 0
            coff = base + 32 + l_read_name
            for k in range(n_cigar):
                (c,) = struct.unpack_from("<I", buf, coff + 4 * k)
                if (c & 0xF) in (0, 2, 3, 7, 8):  # M/D/N/=/X
                    span += c >> 4
            vbeg = voffset(pos_abs)
            vend = voffset(pos_abs + 4 + rec_len)
            yield vbeg, vend, ref_id, pos, pos + max(span, 1)
            pos_abs += 4 + rec_len
            # trim consumed bytes, keep block table aligned
            if pos_abs - trimmed > (1 << 20):
                cut = pos_abs - trimmed
                del buf[:cut]
                trimmed += cut
                blocks = [(s, c) for s, c in blocks if s + 0x10000 > trimmed]


def build_index(bam_path, bai_path=None, n_ref=None):
    """Build a .bai for a coordinate-sorted BAM (samtools index
    equivalent). Returns the index path."""
    if bai_path is None:
        bai_path = bam_path + ".bai"
    if n_ref is None:
        from .bam import BamReader
        rd = BamReader(bam_path)
        n_ref = len(rd.header.ref_names)
        rd.close()
    bins_per_ref = [dict() for _ in range(n_ref)]
    linear_per_ref = [[] for _ in range(n_ref)]
    stats = [[0, 0, None, None] for _ in range(n_ref)]  # mapped, unmapped, off_beg, off_end
    n_no_coor = 0
    last_tid = -1
    for vbeg, vend, ref_id, pos, ref_end in _record_spans(bam_path):
        if ref_id < 0:
            n_no_coor += 1
            continue
        if ref_id < last_tid:
            raise ValueError(f"{bam_path}: not coordinate-sorted")
        last_tid = ref_id
        b = reg2bin(pos, ref_end)
        chunks = bins_per_ref[ref_id].setdefault(b, [])
        if chunks and vbeg >> 16 <= chunks[-1][1] >> 16:
            chunks[-1][1] = vend
        else:
            chunks.append([vbeg, vend])
        linear = linear_per_ref[ref_id]
        w0, w1 = pos >> LINEAR_SHIFT, (ref_end - 1) >> LINEAR_SHIFT
        if len(linear) <= w1:
            linear.extend([0] * (w1 + 1 - len(linear)))
        for w in range(w0, w1 + 1):
            if linear[w] == 0 or vbeg < linear[w]:
                linear[w] = vbeg
        st = stats[ref_id]
        st[0] += 1
        st[2] = vbeg if st[2] is None else min(st[2], vbeg)
        st[3] = vend if st[3] is None else max(st[3], vend)
    for ref_id in range(n_ref):
        linear = linear_per_ref[ref_id]
        # fill gaps with the previous window's offset (samtools behavior)
        for w in range(1, len(linear)):
            if linear[w] == 0:
                linear[w] = linear[w - 1]
        st = stats[ref_id]
        if st[2] is not None:
            bins_per_ref[ref_id][PSEUDO_BIN] = [
                (st[2], st[3]), (st[0], st[1])]
        bins_per_ref[ref_id] = {
            k: [tuple(c) for c in v] for k, v in bins_per_ref[ref_id].items()}
    BaiIndex(bins_per_ref, linear_per_ref, n_no_coor).save(bai_path)
    return bai_path


def find_index(bam_path):
    """Existing index path for a BAM, or None ('x.bam.bai' then 'x.bai')."""
    import os
    for cand in (bam_path + ".bai", bam_path[:-4] + ".bai"
                 if bam_path.endswith(".bam") else bam_path + ".bai"):
        if os.path.exists(cand):
            return cand
    return None


def iter_chunk_records(raw_fh, vbeg, vend):
    """Yield raw record payloads (without the 4-byte length prefix) whose
    start virtual offset lies in [vbeg, vend), decompressing from vbeg."""
    raw_fh.seek(vbeg >> 16)
    buf = bytearray()
    blocks = []  # (abs start in decompressed-stream coords, coffset)
    coffset = vbeg >> 16
    abs_pos = vbeg & 0xFFFF

    def fill(need):
        nonlocal coffset
        while len(buf) < need:
            payload, csize = _read_block(raw_fh)
            if payload is None:
                return False
            blocks.append((len(buf), coffset))
            buf.extend(payload)
            coffset += csize
        return True

    def voffset(p):
        for start, coff in reversed(blocks):
            if start <= p:
                return (coff << 16) | (p - start)
        raise AssertionError

    while True:
        if not fill(abs_pos + 4):
            return
        if voffset(abs_pos) >= vend:
            return
        (rec_len,) = struct.unpack_from("<i", buf, abs_pos)
        if not fill(abs_pos + 4 + rec_len):
            raise ValueError("truncated BAM record in chunk")
        yield bytes(buf[abs_pos + 4:abs_pos + 4 + rec_len])
        abs_pos += 4 + rec_len
