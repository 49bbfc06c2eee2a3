"""ReadRecord: the aligned-read domain object.

Counterpart of the reference's pool-allocated ReadRecord wrapping bam1_t
(reference: src/haplotypecaller/genotype/read_record.h), as a plain Python
object with numpy payloads. Carries alignment info, lazy-decoded bases/quals,
and the per-base gap penalties the PairHMM needs.
"""

import numpy as np

from .. import constants as C
from .cigar import Cigar, CigarOp, CONSUMES_QUERY, CONSUMES_REF

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


class ReadRecord:
    __slots__ = ("name", "flag", "ref_id", "pos", "mapping_quality", "cigar",
                 "bases", "quals", "mate_ref_id", "mate_pos", "tlen", "tags",
                 "contig", "hard_left", "hard_right", "_one2one_cache",
                 "_pileup_layout_cache", "_quals_private")

    def __init__(self, name, flag, ref_id, pos, mapping_quality, cigar,
                 bases, quals, mate_ref_id=-1, mate_pos=-1, tlen=0, tags=None,
                 contig=None, hard_left=0, hard_right=0):
        self.name = name
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos  # 0-based leftmost aligned position
        self.mapping_quality = mapping_quality
        self.cigar = cigar if isinstance(cigar, Cigar) else Cigar.from_string(cigar)
        self.bases = bases.encode() if isinstance(bases, str) else bytes(bases)
        self.quals = np.asarray(quals, dtype=np.uint8)
        self.mate_ref_id = mate_ref_id
        self.mate_pos = mate_pos
        self.tlen = tlen
        self.tags = tags if tags is not None else {}
        self.contig = contig
        # query bases removed by hard clips on each side — the reference
        # keeps H cigar elements and folds them back into read-position
        # distances (read_pos_rank_sum_test.cpp:49-54); we track counts
        self.hard_left = hard_left
        self.hard_right = hard_right
        # per-read memos for the GVCF model (gapped one-to-one arrays and
        # pileup layout — safe on region-local finalized copies)
        self._one2one_cache = None
        self._pileup_layout_cache = None
        self._quals_private = False

    # --- flags ---
    @property
    def is_unmapped(self):
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self):
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self):
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_duplicate(self):
        return bool(self.flag & FLAG_DUP)

    @property
    def fails_qc(self):
        return bool(self.flag & FLAG_QCFAIL)

    @property
    def is_paired(self):
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_first_of_pair(self):
        return bool(self.flag & FLAG_FIRST)

    @property
    def mate_is_unmapped(self):
        return self.is_paired and bool(self.flag & FLAG_MATE_UNMAPPED)

    @property
    def mate_is_reverse(self):
        return self.is_paired and bool(self.flag & FLAG_MATE_REVERSE)

    @property
    def insert_size(self):
        return self.tlen

    @property
    def unclipped_length(self):
        """seq length minus soft-clipped bases (the reference's
        unclipped_read_length, read_record.cpp:155-163)."""
        return len(self.bases) - sum(n for op, n in self.cigar
                                     if op == CigarOp.S)

    # --- coordinates ---
    def __len__(self):
        return len(self.bases)

    @property
    def end(self):
        """0-based exclusive reference end of the aligned span."""
        return self.pos + self.cigar.reference_length

    @property
    def unclipped_start(self):
        s = self.pos
        for op, n in self.cigar:
            if op in (CigarOp.S, CigarOp.H):
                s -= n
            else:
                break
        return s

    @property
    def unclipped_end(self):
        e = self.end
        for op, n in reversed(self.cigar.elements):
            if op in (CigarOp.S, CigarOp.H):
                e += n
            else:
                break
        return e

    def overlaps(self, start, end):
        """Overlap test against a 0-based half-open [start, end) span."""
        return self.pos < end and self.end > start

    # --- per-base arrays for PairHMM ---
    @property
    def ins_quals(self):
        """BI tag if present, else the GATK default gap-open of 45."""
        bi = self.tags.get("BI")
        if bi is not None:
            return np.frombuffer(bi.encode(), dtype=np.uint8) - 33
        return np.full(len(self.bases), C.DEFAULT_GAP_OPEN_PHRED,
                       dtype=np.uint8)

    @property
    def del_quals(self):
        bd = self.tags.get("BD")
        if bd is not None:
            return np.frombuffer(bd.encode(), dtype=np.uint8) - 33
        return np.full(len(self.bases), C.DEFAULT_GAP_OPEN_PHRED,
                       dtype=np.uint8)

    @property
    def gcp(self):
        return np.full(len(self.bases), C.GAP_CONTINUATION_PHRED,
                       dtype=np.uint8)

    # --- coordinate mapping ---
    def index_at_ref_coord(self, ref_coord):
        """(read_index, op) for the cigar element covering ref_coord,
        walking from the soft start with soft clips consuming reference —
        the reference's get_read_index_for_reference_coordinate
        (read_record_utils.cpp:72-105, hc_assemble_utils.c C twin).
        Deletion/skip elements return the read index at their boundary
        with op 'D'/'N'; (None, None) when not covered."""
        soft_start = self.pos - self.cigar.left_soft_clip
        if ref_coord < soft_start:
            return None, None
        rpos = 0
        ref = soft_start
        for op, n in self.cigar:
            consumes_read = op in CONSUMES_QUERY
            consumes_ref = op in CONSUMES_REF or op == CigarOp.S
            first_r, first_ref = rpos, ref
            rpos += n if consumes_read else 0
            ref += n if consumes_ref else 0
            if first_ref <= ref_coord < ref:
                return (first_r + (ref_coord - first_ref)
                        if consumes_read else first_r), op
        return None, None

    def read_pos_at_ref_pos(self, ref_pos):
        """Query offset aligned at ref_pos, or (None, deletion_flag).

        Returns (query_index or None, is_deletion_at_that_pos).
        """
        r = self.pos
        q = 0
        for op, n in self.cigar:
            if op in CONSUMES_REF and op in CONSUMES_QUERY:
                if r <= ref_pos < r + n:
                    return q + (ref_pos - r), False
                r += n
                q += n
            elif op in CONSUMES_REF:
                if r <= ref_pos < r + n:
                    return None, True
                r += n
            elif op in CONSUMES_QUERY:
                q += n
        return None, False

    def copy(self, **overrides):
        kw = dict(name=self.name, flag=self.flag, ref_id=self.ref_id,
                  pos=self.pos, mapping_quality=self.mapping_quality,
                  cigar=self.cigar, bases=self.bases, quals=self.quals.copy(),
                  mate_ref_id=self.mate_ref_id, mate_pos=self.mate_pos,
                  # .items() honors lazy tag parsing (io.bam.LazyTags)
                  tlen=self.tlen, tags=dict(self.tags.items()),
                  contig=self.contig, hard_left=self.hard_left,
                  hard_right=self.hard_right)
        kw.update(overrides)
        return ReadRecord(**kw)

    def __repr__(self):
        return (f"ReadRecord({self.name} {self.contig or self.ref_id}:"
                f"{self.pos} {self.cigar} mq{self.mapping_quality})")
