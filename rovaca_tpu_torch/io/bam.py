"""BAM reading/writing in pure Python (BGZF + binary record codec).

Serves the role of the reference's htslib-backed BamLoader (reference:
src/IOStream/bam_loader.cpp:118-142): sequential whole-file iteration of
coordinate-sorted reads, plus a writer used to synthesize test BAMs. Multiple
input files are k-way merged by (tid, pos, reverse, file-index) exactly as the
reference merges (bam_loader.cpp:93-116).
"""

import heapq
import struct

import numpy as np

from ..reads.cigar import Cigar, CigarOp
from ..reads.record import ReadRecord
from . import bgzf

_CIGAR_OPS = [CigarOp(i) for i in range(9)]

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
_NT16_CODE.update({"a": 1, "c": 2, "g": 4, "t": 8, "n": 15})

_NT16_BYTES = np.frombuffer(SEQ_NT16.encode(), dtype=np.uint8)


def _decode_seq(packed, l_seq):
    """4-bit packed BAM bases -> ASCII bytes, vectorized."""
    arr = np.frombuffer(packed, dtype=np.uint8)
    out = np.empty(arr.size * 2, dtype=np.uint8)
    out[0::2] = _NT16_BYTES[arr >> 4]
    out[1::2] = _NT16_BYTES[arr & 0xF]
    return out[:l_seq].tobytes()


class BamHeader:
    def __init__(self, text="", ref_names=(), ref_lengths=()):
        self.text = text
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        self.name_to_id = {n: i for i, n in enumerate(self.ref_names)}

    @property
    def read_groups(self):
        """RG IDs and sample names parsed from @RG lines
        (reference: src/rovaca_tool.hpp:163-203)."""
        groups = []
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                              if ":" in f)
                groups.append(fields)
        return groups

    @property
    def samples(self):
        out = []
        for rg in self.read_groups:
            sm = rg.get("SM")
            if sm and sm not in out:
                out.append(sm)
        return out


CHUNK_BYTES = 4 << 20


class LazyTags(dict):
    """Tag dict parsed from the record payload on first access."""

    __slots__ = ("_raw",)

    def __init__(self, raw):
        super().__init__()
        self._raw = raw

    def _force(self):
        if self._raw is not None:
            super().update(_parse_tags(self._raw, 0))
            self._raw = None

    def __getitem__(self, k):
        self._force()
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._force()
        return super().get(k, default)

    def setdefault(self, k, default=None):
        self._force()
        return super().setdefault(k, default)

    def __contains__(self, k):
        self._force()
        return super().__contains__(k)

    def __iter__(self):
        self._force()
        return super().__iter__()

    def items(self):
        self._force()
        return super().items()

    def __len__(self):
        self._force()
        return super().__len__()


class BamReader:
    def __init__(self, path):
        self.path = path
        self._fh = bgzf.open_read(path)
        magic = self._fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._fh.read(4))
        text = self._fh.read(l_text).decode("latin-1").rstrip("\x00")
        (n_ref,) = struct.unpack("<i", self._fh.read(4))
        names, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._fh.read(4))
            names.append(self._fh.read(l_name)[:-1].decode())
            lengths.append(struct.unpack("<i", self._fh.read(4))[0])
        self.header = BamHeader(text, names, lengths)
        self._residual = b""
        self._queue = []
        self._qi = 0
        self._eof = False

    def __iter__(self):
        return self

    def __next__(self):
        while self._qi >= len(self._queue):
            if self._eof:
                raise StopIteration
            self._refill()
        rec = self._queue[self._qi]
        self._qi += 1
        return rec

    def _refill(self):
        chunk = self._fh.read(CHUNK_BYTES)
        if not chunk:
            self._eof = True
            if self._residual:
                raise ValueError(f"{self.path}: truncated BAM record")
            return
        buf = self._residual + chunk
        self._queue = []
        self._qi = 0
        from ..native import bamscan_native
        if bamscan_native.available():
            fields, consumed = bamscan_native.scan(buf)
            # chunk-wide vectorized decode: one nibble expansion + one qual
            # view array for the whole chunk instead of per-read numpy calls
            arr = np.frombuffer(buf, dtype=np.uint8)
            nib = np.empty(arr.size * 2, dtype=np.uint8)
            nib[0::2] = _NT16_BYTES[arr >> 4]
            nib[1::2] = _NT16_BYTES[arr & 0xF]
            self._chunk_quals = arr
            self._chunk_nib = nib
            mv = memoryview(buf)
            for k in range(fields["rec_off"].shape[0]):
                self._queue.append(self._parse_scanned(
                    mv, int(fields["rec_off"][k]),
                    int(fields["tid"][k]), int(fields["pos"][k]),
                    int(fields["mapq"][k]), int(fields["flag"][k]),
                    int(fields["n_cigar"][k]), int(fields["l_seq"][k]),
                    int(fields["l_read_name"][k]),
                    int(fields["next_tid"][k]), int(fields["next_pos"][k]),
                    int(fields["tlen"][k])))
            self._residual = buf[consumed:]
        else:
            off = 0
            while off + 4 <= len(buf):
                (block_size,) = struct.unpack_from("<i", buf, off)
                if off + 4 + block_size > len(buf):
                    break
                self._queue.append(self._parse(buf[off + 4:
                                                   off + 4 + block_size]))
                off += 4 + block_size
            self._residual = buf[off:]

    def _parse_scanned(self, mv, off, ref_id, pos, mapq, flag, n_cigar,
                       l_seq, l_read_name, next_ref, next_pos, tlen):
        body = mv[off:]
        p = 32
        name = bytes(body[p:p + l_read_name - 1]).decode()
        p += l_read_name
        cigar_raw = np.frombuffer(body, dtype="<u4", count=n_cigar, offset=p)
        p += 4 * n_cigar
        cigar = Cigar.from_raw(
            [(_CIGAR_OPS[c & 0xF], int(c) >> 4) for c in cigar_raw.tolist()])
        n_seq_bytes = (l_seq + 1) // 2
        # slices into the chunk-wide decoded arrays (see _refill)
        bases = self._chunk_nib[2 * (off + p):
                                2 * (off + p) + l_seq].tobytes()
        p += n_seq_bytes
        quals = self._chunk_quals[off + p:off + p + l_seq]
        p += l_seq
        # remaining payload = tags; copy so the chunk buffer can be freed
        rec_len = struct.unpack_from("<i", mv, off - 4)[0]
        tags = LazyTags(bytes(body[p:rec_len]))
        contig = (self.header.ref_names[ref_id]
                  if 0 <= ref_id < len(self.header.ref_names) else None)
        return ReadRecord(name=name, flag=flag, ref_id=ref_id, pos=pos,
                          mapping_quality=mapq, cigar=cigar, bases=bases,
                          quals=quals, mate_ref_id=next_ref,
                          mate_pos=next_pos, tlen=tlen, tags=tags,
                          contig=contig)

    def _parse(self, data):
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
        off = 32
        name = data[off:off + l_read_name - 1].decode()
        off += l_read_name
        cigar_raw = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=off)
        off += 4 * n_cigar
        cigar = Cigar((CigarOp(int(c) & 0xF), int(c) >> 4) for c in cigar_raw)
        n_seq_bytes = (l_seq + 1) // 2
        seq_packed = data[off:off + n_seq_bytes]
        off += n_seq_bytes
        bases = _decode_seq(seq_packed, l_seq)
        quals = np.frombuffer(data, dtype=np.uint8, count=l_seq,
                              offset=off).copy()
        off += l_seq
        tags = _parse_tags(data, off)
        contig = (self.header.ref_names[ref_id]
                  if 0 <= ref_id < len(self.header.ref_names) else None)
        return ReadRecord(name=name, flag=flag, ref_id=ref_id, pos=pos,
                          mapping_quality=mapq, cigar=cigar, bases=bases,
                          quals=quals, mate_ref_id=next_ref, mate_pos=next_pos,
                          tlen=tlen, tags=tags, contig=contig)

    def has_index(self):
        from . import bai
        return bai.find_index(self.path) is not None

    def fetch(self, contig, start, end):
        """Indexed iteration of reads overlapping [start, end) on contig
        (role of sam_itr_querys, reference: src/IOStream/bam_loader.cpp:87).
        Requires a .bai next to the BAM; records are yielded in coordinate
        order with overlap filtering."""
        from . import bai
        idx_path = bai.find_index(self.path)
        if idx_path is None:
            raise FileNotFoundError(f"no .bai index for {self.path}")
        if not hasattr(self, "_bai"):
            self._bai = bai.BaiIndex.load(idx_path)
        ref_id = self.header.name_to_id.get(contig)
        if ref_id is None:
            return
        with open(self.path, "rb") as raw:
            for vbeg, vend in self._bai.query(ref_id, start, end):
                for data in bai.iter_chunk_records(raw, vbeg, vend):
                    rec = self._parse(data)
                    if rec.ref_id != ref_id or rec.pos >= end:
                        return
                    if rec.end > start:
                        yield rec

    def close(self):
        self._fh.close()


def merged_fetch(readers, contig, start, end):
    """K-way merged indexed fetch across BamReaders, ordered like
    merged_reader (tid, pos, reverse, file-index)."""
    heap = []
    iters = [rd.fetch(contig, start, end) for rd in readers]
    for fi, it in enumerate(iters):
        read = next(it, None)
        if read is not None:
            heap.append(((read.pos, read.is_reverse, fi), fi, read))
    heapq.heapify(heap)
    while heap:
        _, fi, read = heapq.heappop(heap)
        yield read
        nxt = next(iters[fi], None)
        if nxt is not None:
            heapq.heappush(heap, ((nxt.pos, nxt.is_reverse, fi), fi, nxt))


def _parse_tags(data, off):
    tags = {}
    n = len(data)
    while off + 3 <= n:
        tag = data[off:off + 2].decode()
        typ = chr(data[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(data[off]); off += 1
        elif typ in "cC":
            tags[tag] = data[off] if typ == "C" else struct.unpack_from("<b", data, off)[0]
            off += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", data, off)[0]
            off += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", data, off)[0]
            off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", data, off)[0]; off += 4
        elif typ in "ZH":
            end = data.index(b"\x00", off)
            tags[tag] = data[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(data[off])
            (cnt,) = struct.unpack_from("<i", data, off + 1)
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[sub]
            vals = struct.unpack_from(f"<{cnt}{fmt}", data, off + 5)
            tags[tag] = list(vals)
            off += 5 + cnt * struct.calcsize(fmt)
        else:
            break
    return tags


class BamWriter:
    def __init__(self, path, header, level=6):
        self.header = header
        self._w = bgzf.Writer(path, level)
        text = header.text.encode()
        buf = b"BAM\x01" + struct.pack("<i", len(text)) + text
        buf += struct.pack("<i", len(header.ref_names))
        for name, length in zip(header.ref_names, header.ref_lengths):
            nb = name.encode() + b"\x00"
            buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(buf)

    def write(self, read):
        name = read.name.encode() + b"\x00"
        cigar_raw = b"".join(
            struct.pack("<I", (n << 4) | int(op)) for op, n in read.cigar)
        l_seq = len(read.bases)
        seq_codes = [_NT16_CODE.get(chr(b), 15) for b in read.bases]
        if l_seq % 2:
            seq_codes.append(0)
        packed = bytes((seq_codes[i] << 4) | seq_codes[i + 1]
                       for i in range(0, len(seq_codes), 2))
        quals = bytes(np.asarray(read.quals, dtype=np.uint8))
        tags = b""
        for tag, val in read.tags.items():
            if isinstance(val, str) and len(val) == 1 and tag in ("XA",):
                tags += tag.encode() + b"A" + val.encode()
            elif isinstance(val, int):
                tags += tag.encode() + b"i" + struct.pack("<i", val)
            elif isinstance(val, float):
                tags += tag.encode() + b"f" + struct.pack("<f", val)
            else:
                tags += tag.encode() + b"Z" + str(val).encode() + b"\x00"
        body = struct.pack(
            "<iiBBHHHiiii", read.ref_id, read.pos, len(name),
            read.mapping_quality, 0, len(read.cigar.elements), read.flag,
            l_seq, read.mate_ref_id, read.mate_pos, read.tlen)
        body += name + cigar_raw + packed + quals + tags
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def merged_reader(paths):
    """K-way merge of coordinate-sorted BAMs by (tid, pos, reverse, file)
    (reference: src/IOStream/bam_loader.cpp:93-116). Yields ReadRecords."""
    readers = [BamReader(p) for p in paths]
    heap = []
    for fi, rd in enumerate(readers):
        try:
            read = next(rd)
            key = (read.ref_id if read.ref_id >= 0 else 1 << 30, read.pos,
                   read.is_reverse, fi)
            heap.append((key, fi, read))
        except StopIteration:
            pass
    heapq.heapify(heap)
    while heap:
        key, fi, read = heapq.heappop(heap)
        yield read
        try:
            nxt = next(readers[fi])
            nkey = (nxt.ref_id if nxt.ref_id >= 0 else 1 << 30, nxt.pos,
                    nxt.is_reverse, fi)
            heapq.heappush(heap, (nkey, fi, nxt))
        except StopIteration:
            pass
    for rd in readers:
        rd.close()
