from .cigar import Cigar, CigarOp  # noqa: F401
from .record import ReadRecord  # noqa: F401
