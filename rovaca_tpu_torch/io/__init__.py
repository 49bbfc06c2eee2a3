from .fasta import FastaFile  # noqa: F401
from .bed import BedFile  # noqa: F401
from .bam import BamReader, BamWriter, BamHeader  # noqa: F401
