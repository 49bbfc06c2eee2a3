"""BGZF block gzip: the container format for BAM and bgzipped VCF.

A BGZF file is a series of gzip members, each with a BC extra field recording
the compressed block size, ending with a 28-byte EOF marker block. Reading
uses the stdlib gzip module (multi-member aware); writing emits spec-compliant
blocks. (Serves the role of htslib's bgzf layer used by the reference's IO,
reference: src/IOStream/bam_loader.cpp:42-43.)
"""

import gzip
import struct
import zlib

MAX_BLOCK_SIZE = 0x10000 - 256  # uncompressed payload per block

EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def open_read(path):
    """A buffered file-like yielding the decompressed stream."""
    return gzip.open(path, "rb")


def _block(payload, level=6):
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    # BC subfield = total block size - 1 (SAM spec 4.1):
    # header(12) + extra(6) + cdata + crc/isize(8) - 1
    bsize = len(data) + 25
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,    # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,          # mtime, xfl, os
        6,                   # xlen
        0x42, 0x43, 2,       # 'BC', slen
        bsize)
    trailer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload) & 0xFFFFFFFF)
    return header + data + trailer


class Writer:
    def __init__(self, path, level=6, append=False):
        if append:
            # strip an existing EOF marker so appended blocks precede it
            import os
            if os.path.exists(path) and os.path.getsize(path) >= 28:
                with open(path, "r+b") as fh:
                    fh.seek(-28, 2)
                    if fh.read(28) == EOF_BLOCK:
                        fh.seek(-28, 2)
                        fh.truncate()
            self._fh = open(path, "ab")
        else:
            self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data):
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_SIZE:
            self._flush_block(MAX_BLOCK_SIZE)

    def _flush_block(self, n):
        payload = bytes(self._buf[:n])
        del self._buf[:n]
        self._fh.write(_block(payload, self._level))

    def close(self):
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_BLOCK_SIZE))
        self._fh.write(EOF_BLOCK)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
