"""A genome-coordinate view over a reference slice.

Pipeline code indexes the reference with absolute genome positions; carrying
whole contigs in every prepared region would make region payloads huge (and
unpicklable at scale). RefWindow wraps a window's bytes + offset and
translates absolute indexing, so region code is oblivious.
"""


class RefWindow:
    __slots__ = ("data", "offset")

    def __init__(self, data, offset):
        self.data = bytes(data)
        self.offset = offset

    @classmethod
    def of(cls, ref, start, stop):
        """Window covering [start, stop] inclusive of a full contig."""
        if isinstance(ref, RefWindow):
            base = ref.offset
            return cls(ref.data[start - base:stop + 1 - base], start)
        return cls(ref[start:stop + 1], start)

    def __getitem__(self, key):
        if isinstance(key, slice):
            start = key.start - self.offset if key.start is not None else None
            stop = key.stop - self.offset if key.stop is not None else None
            if start is not None and start < 0:
                raise IndexError(f"position {key.start} before window start "
                                 f"{self.offset}")
            return self.data[start:stop:key.step]
        local = key - self.offset
        if local < 0:
            raise IndexError(f"position {key} before window start "
                             f"{self.offset}")
        return self.data[local]

    def __len__(self):
        return self.offset + len(self.data)  # acts like a prefix-truncated contig

    def __contains__(self, pos):
        return self.offset <= pos < self.offset + len(self.data)
