"""Tabix (.tbi) index for BGZF-compressed VCF: build, load, query.

Counterpart of htslib's tabix layer (the reference links htslib for its
VCF/dbSNP IO; see SURVEY 2.6/2.27). Same R-tree binning + linear index as
BAI (io/bai.py) but over newline-delimited text records, keyed by the
CHROM/POS columns. Lets dbSNP lookups and downstream consumers seek into
bgzipped VCFs instead of decompressing the whole file.
"""

import struct

from .bai import LINEAR_SHIFT, _read_block, reg2bin, reg2bins

MAGIC = b"TBI\x01"

# preset for VCF (tabix -p vcf): seq col 1, begin col 2, end 0 (use
# begin + rlen(REF)), comment '#', no skip
VCF_FORMAT = 2
COL_SEQ, COL_BEG, COL_END = 1, 2, 0
META_CHAR = ord("#")


class TabixIndex:
    def __init__(self, names, bins_per_ref, linear_per_ref, n_no_coor=0):
        self.names = list(names)
        self.name_to_id = {n: i for i, n in enumerate(self.names)}
        self.bins = bins_per_ref
        self.linear = linear_per_ref
        self.n_no_coor = n_no_coor

    @classmethod
    def load(cls, path):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:2] == b"\x1f\x8b":
            import gzip
            data = gzip.decompress(data)  # multi-member aware (BGZF)
        if data[:4] != MAGIC:
            raise ValueError(f"{path}: not a tabix index")
        (n_ref, _fmt, _cs, _cb, _ce, _meta, _skip, l_nm) = struct.unpack_from(
            "<8i", data, 4)
        off = 36
        names = [n.decode() for n in data[off:off + l_nm].split(b"\x00") if n]
        off += l_nm
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
        return cls(names, bins_per_ref, linear_per_ref, n_no_coor)

    def query(self, contig, beg, end):
        """Merged (vbeg, vend) chunks overlapping [beg, end) 0-based."""
        ref_id = self.name_to_id.get(contig)
        if ref_id is None or beg >= end:
            return []
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        win = beg >> LINEAR_SHIFT
        min_off = linear[win] if win < len(linear) else 0
        chunks = []
        for b in reg2bins(beg, end):
            for vbeg, vend in bins.get(b, ()):
                if vend > min_off:
                    chunks.append((max(vbeg, min_off), vend))
        chunks.sort()
        merged = []
        for vbeg, vend in chunks:
            if merged and vbeg >> 16 <= merged[-1][1] >> 16:
                merged[-1][1] = max(merged[-1][1], vend)
            else:
                merged.append([vbeg, vend])
        return [tuple(c) for c in merged]

    def save(self, path):
        from . import bgzf
        out = bytearray(MAGIC)
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        out += struct.pack("<8i", len(self.bins), VCF_FORMAT, COL_SEQ,
                           COL_BEG, COL_END, META_CHAR, 0, len(names_blob))
        out += names_blob
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
        # .tbi files are themselves BGZF-compressed
        with bgzf.Writer(path) as w:
            w.write(bytes(out))


def _line_spans(path):
    """Yield (vbeg, vend, line_bytes) per line of a BGZF text file."""
    with open(path, "rb") as fh:
        coffset = 0
        buf = bytearray()
        blocks = []  # (abs start, coffset)
        trimmed = 0

        def voffset(abs_pos):
            for start, coff in reversed(blocks):
                if start <= abs_pos:
                    return (coff << 16) | (abs_pos - start)
            raise AssertionError

        pos_abs = 0
        while True:
            nl = buf.find(b"\n", pos_abs - trimmed)
            while nl < 0:
                payload, csize = _read_block(fh)
                if payload is None:
                    if trimmed + len(buf) > pos_abs:
                        yield (voffset(pos_abs),
                               voffset(trimmed + len(buf)),
                               bytes(buf[pos_abs - trimmed:]))
                    return
                blocks.append((trimmed + len(buf), coffset))
                buf.extend(payload)
                coffset += csize
                nl = buf.find(b"\n", pos_abs - trimmed)
            end_abs = trimmed + nl + 1
            yield (voffset(pos_abs), voffset(end_abs),
                   bytes(buf[pos_abs - trimmed:nl]))
            pos_abs = end_abs
            if pos_abs - trimmed > (1 << 20):
                cut = pos_abs - trimmed
                del buf[:cut]
                trimmed += cut
                blocks = [(s, c) for s, c in blocks if s + 0x10000 > trimmed]


def build_index(vcf_gz_path, tbi_path=None):
    """Build a .tbi for a coordinate-sorted bgzipped VCF. Returns the
    index path."""
    if tbi_path is None:
        tbi_path = vcf_gz_path + ".tbi"
    names = []
    bins_per_ref, linear_per_ref = [], []
    last = (-1, -1)
    for vbeg, vend, line in _line_spans(vcf_gz_path):
        if not line or line[0] == META_CHAR:
            continue
        fields = line.split(b"\t", 4)
        contig = fields[0].decode()
        beg = int(fields[1]) - 1
        end = beg + len(fields[3])  # END tags unsupported; VCF REF span
        if contig not in names:
            names.append(contig)
            bins_per_ref.append({})
            linear_per_ref.append([])
        ref_id = names.index(contig)
        if (ref_id, beg) < last:
            raise ValueError(f"{vcf_gz_path}: not coordinate-sorted")
        last = (ref_id, beg)
        b = reg2bin(beg, end)
        chunks = bins_per_ref[ref_id].setdefault(b, [])
        if chunks and vbeg >> 16 <= chunks[-1][1] >> 16:
            chunks[-1][1] = vend
        else:
            chunks.append([vbeg, vend])
        linear = linear_per_ref[ref_id]
        w0, w1 = beg >> LINEAR_SHIFT, (end - 1) >> LINEAR_SHIFT
        if len(linear) <= w1:
            linear.extend([0] * (w1 + 1 - len(linear)))
        for w in range(w0, w1 + 1):
            if linear[w] == 0 or vbeg < linear[w]:
                linear[w] = vbeg
    for linear in linear_per_ref:
        for w in range(1, len(linear)):
            if linear[w] == 0:
                linear[w] = linear[w - 1]
    bins_per_ref = [{k: [tuple(c) for c in v] for k, v in bins.items()}
                    for bins in bins_per_ref]
    TabixIndex(names, bins_per_ref, linear_per_ref).save(tbi_path)
    return tbi_path


def fetch_lines(vcf_gz_path, index, contig, beg, end):
    """Yield VCF data lines (str) overlapping [beg, end) 0-based, using
    the index to seek."""
    chunks = index.query(contig, beg, end)
    if not chunks:
        return
    with open(vcf_gz_path, "rb") as raw:
        for vbeg, vend in chunks:
            raw.seek(vbeg >> 16)
            buf = bytearray()
            blocks = []
            coffset = vbeg >> 16
            abs_pos = vbeg & 0xFFFF

            def fill(need):
                nonlocal coffset
                while len(buf) < need:
                    payload, csize = _read_block(raw)
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
                nl = buf.find(b"\n", abs_pos)
                while nl < 0:
                    if not fill(len(buf) + 1):
                        nl = len(buf)
                        break
                    nl = buf.find(b"\n", abs_pos)
                if abs_pos >= len(buf) or voffset(abs_pos) >= vend:
                    break
                line = bytes(buf[abs_pos:nl]).decode()
                abs_pos = nl + 1
                if not line or line.startswith("#"):
                    continue
                fields = line.split("\t", 4)
                if fields[0] != contig:
                    return
                pos0 = int(fields[1]) - 1
                if pos0 >= end:
                    return
                if pos0 + len(fields[3]) > beg:
                    yield line
