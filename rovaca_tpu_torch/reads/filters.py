"""Read filtering: the GATK WellformedReadFilter equivalent.

Mirrors HCReadFilter (reference: src/common/reads_filter_hc.h:15-58): drop
reads with UNMAP/SECONDARY/DUP/QCFAIL flags, mapping quality outside
[20, 255), zero reference length; optional strict well-formedness checks.
"""

from .. import constants as C
from .record import (FLAG_DUP, FLAG_QCFAIL, FLAG_SECONDARY, FLAG_UNMAPPED)

FILTER_FLAGS = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_DUP | FLAG_QCFAIL


class HCReadFilter:
    def __init__(self, min_mapping_quality=C.READ_FILTER_MIN_MAPPING_QUALITY,
                 max_mapping_quality=C.READ_FILTER_UNAVAILABLE_MAPPING_QUALITY,
                 inspect=False):
        self.min_mq = min_mapping_quality
        self.max_mq = max_mapping_quality
        self.inspect = inspect
        self.filtered_count = 0

    def test(self, read):
        ok = (not (read.flag & FILTER_FLAGS)
              and self.min_mq <= read.mapping_quality < self.max_mq
              and read.cigar.reference_length > 0
              and (not self.inspect or self._well_formed(read)))
        if not ok:
            self.filtered_count += 1
        return ok

    @staticmethod
    def _well_formed(read):
        """Strict validation (--inspect-reads; reads_filter_lib.h checks)."""
        if read.pos < 0 or read.ref_id < 0:
            return False
        if len(read.bases) != len(read.quals):
            return False
        if read.cigar.is_empty:
            return False
        if read.cigar.query_length != len(read.bases):
            return False
        return read.cigar.is_valid()

    def __call__(self, reads):
        return (r for r in reads if self.test(r))
