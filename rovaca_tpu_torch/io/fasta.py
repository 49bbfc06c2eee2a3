"""FASTA access with .fai index support.

Counterpart of the reference's faidx-backed FastaLoader (reference:
src/IOStream/fasta_loader.h:14-44): whole-chromosome or range fetch, contig
dict {name -> length} in file order, and base normalization (everything
outside ACGTacgt becomes N — mirroring the seq_nt16_str_refine table,
fasta_loader.h:12).
"""

import os

_NORM = bytearray(b"N" * 256)
for _c in b"ACGT":
    _NORM[_c] = _c
for _lo, _up in zip(b"acgt", b"ACGT"):
    _NORM[_lo] = _up
_NORM = bytes(_NORM)


class FastaFile:
    def __init__(self, path):
        self.path = path
        fai = path + ".fai"
        self._index = {}      # name -> (length, offset, linebases, linewidth)
        self.contig_names = []
        if os.path.exists(fai):
            with open(fai) as fh:
                for line in fh:
                    name, length, off, lb, lw = line.split()[:5]
                    self._index[name] = (int(length), int(off), int(lb), int(lw))
                    self.contig_names.append(name)
        else:
            self._build_index()
        self._fh = open(path, "rb")

    def _build_index(self):
        with open(self.path, "rb") as fh:
            name = None
            length = 0
            offset = 0
            linebases = linewidth = 0
            pos = 0
            for line in fh:
                if line.startswith(b">"):
                    if name is not None:
                        self._index[name] = (length, offset, linebases, linewidth)
                        self.contig_names.append(name)
                    name = line[1:].split()[0].decode()
                    length = 0
                    offset = pos + len(line)
                    linebases = linewidth = 0
                else:
                    if not linebases:
                        linewidth = len(line)
                        linebases = len(line.rstrip(b"\r\n"))
                    length += len(line.rstrip(b"\r\n"))
                pos += len(line)
            if name is not None:
                self._index[name] = (length, offset, linebases, linewidth)
                self.contig_names.append(name)

    @property
    def contig_dict(self):
        """Ordered {contig -> length} (the reference's fasta dict,
        fasta_loader.h:33)."""
        return {n: self._index[n][0] for n in self.contig_names}

    def contig_length(self, name):
        return self._index[name][0]

    def fetch(self, contig, start=0, end=None):
        """Uppercase, N-normalized bytes for [start, end) (0-based)."""
        length, offset, lb, lw = self._index[contig]
        if end is None or end > length:
            end = length
        start = max(0, start)
        if start >= end:
            return b""
        first_line = start // lb
        byte_start = offset + first_line * lw + (start - first_line * lb)
        last_line = (end - 1) // lb
        byte_end = offset + last_line * lw + ((end - 1) - last_line * lb) + 1
        self._fh.seek(byte_start)
        raw = self._fh.read(byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").translate(_NORM)

    def close(self):
        self._fh.close()


def write_fasta(path, contigs, line_width=60):
    """Write {name: sequence} to a FASTA file + .fai index (test helper)."""
    with open(path, "w") as fh:
        for name, seq in contigs.items():
            if isinstance(seq, bytes):
                seq = seq.decode()
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")
    # build the .fai alongside
    with open(path + ".fai", "w") as fh:
        offset = 0
        for name, seq in contigs.items():
            offset += len(name) + 2
            fh.write(f"{name}\t{len(seq)}\t{offset}\t{line_width}\t{line_width + 1}\n")
            full_lines = len(seq) // line_width
            rem = len(seq) % line_width
            offset += full_lines * (line_width + 1) + (rem + 1 if rem else 0)
