from .banded import BandedSWResult, sw_align_banded_batch  # noqa: F401
