"""Positional downsampler reproducing Java's LCG bit-for-bit.

The reference replicates GATK's PositionalDownsampler including Java
java.util.Random semantics so results match GATK exactly (reference:
src/common/downsampler_hc.h:10-13, 94-210). Same here: reservoir sampling per
alignment start with the Java LCG (multiplier 0x5DEECE66D, addend 0xB, raw
state seed 25170011922 — the reference seeds the state directly, without
Java's setSeed scramble).
"""

from .. import constants as C

_MASK32 = 0xFFFFFFFF


def _to_int32(x):
    x &= _MASK32
    return x - 0x100000000 if x >= 0x80000000 else x


class JavaLCG:
    """java.util.Random's next(bits)/nextInt(bound), state seeded raw."""

    def __init__(self, seed=C.DOWNSAMPLER_SEED):
        self.state = seed & C.JAVA_LCG_MASK

    def next_bits(self, bits):
        self.state = (self.state * C.JAVA_LCG_MULTIPLIER
                      + C.JAVA_LCG_ADDEND) & C.JAVA_LCG_MASK
        return _to_int32(self.state >> (48 - bits))

    def next_int(self, bound):
        if bound <= 0:
            return -1
        r = self.next_bits(31)
        m = bound - 1
        if (bound & m) == 0:  # power of two
            return _to_int32((bound * r) >> 31)
        u = r
        r = u % bound
        while _to_int32(u - r + m) < 0:
            u = self.next_bits(31)
            r = u % bound
        return r


class PositionalDownsampler:
    """Reservoir-downsample reads sharing an alignment start to `target`
    (downsampler_hc.h:94-210). Feed coordinate-sorted reads via submit();
    pull finalized reads with consume(); call finalize() at end of input."""

    def __init__(self, target=C.DOWNSAMPLE_DEFAULT_TARGET):
        self.target = target
        self.rng = JavaLCG()
        self.reservoir = []
        self.finalized = []
        self.previous = None
        self.total_seen = 0
        self.discarded = 0

    def submit(self, read):
        if self.previous is not None:
            prev_key = (self.previous.ref_id, self.previous.pos)
            cur_key = (read.ref_id, read.pos)
            if cur_key != prev_key:
                self._finalize_reservoir()
        if read.ref_id < 0 or read.pos < 0:
            self.finalized.append(read)
            return
        self.total_seen += 1
        if self.total_seen <= self.target:
            self.reservoir.append(read)
            self.previous = read
        else:
            self.discarded += 1
            slot = self.rng.next_int(self.total_seen)
            if slot < self.target:
                self.reservoir[slot] = read
                self.previous = read

    def _finalize_reservoir(self):
        if self.reservoir:
            self.finalized.extend(self.reservoir)
            self.reservoir = []
            self.total_seen = 0
        self.previous = None

    def consume(self):
        out = self.finalized
        self.finalized = []
        return out

    def finalize(self):
        self._finalize_reservoir()
        return self.consume()

    def __call__(self, reads):
        """Streaming generator over an iterable of sorted reads."""
        for read in reads:
            self.submit(read)
            if self.finalized:
                yield from self.consume()
        yield from self.finalize()

    def stream_consume(self, reads, at_eof):
        """Replicate the reference's ReadsDownsampleIterator + dispatch
        consumption, including its end-of-stream read loss.

        The iterator's has_next() is `upstream.has_next() AND no finalized
        items` (reads_stream.h:238); the dispatch loop checks it BEFORE
        each next() (ActiveMainThread.cpp:77-82), and the BAM loader's
        has_next() stays stale-true until a read attempt hits EOF
        (bam_loader.cpp:91,118-142). Net effect: every group finalized by
        a position change is drained fully, but the END-SIGNAL reservoir
        flush — the final alignment-start group of the whole stream — is
        returned to the dispatcher exactly once before the gate goes
        false, so all but its FIRST read are silently dropped.
        Bit-equivalence requires reproducing that; pass at_eof=True only
        for the stream's final segment."""
        out = []
        for read in reads:
            self.submit(read)
            if self.finalized:
                out.extend(self.consume())
        if at_eof:
            tail = self.finalize()   # input_end_signal reservoir flush
            if tail:
                out.append(tail[0])
        return out
