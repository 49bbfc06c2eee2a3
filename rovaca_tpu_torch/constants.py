"""GATK/Rovaca-compatible constants.

Every constant is cited against the reference implementation so equivalence can
be audited (reference: path:line refers to files under /root/reference).
"""

import numpy as np

# --- PairHMM numerics (reference: src/haplotypecaller/pairhmm/adapter.h:1-38,
#     rovaca/context.h:105-155, rovaca/common.h:9) ---
MIN_QUALITY = 6                       # floor applied to sub-threshold base quals
MIN_QUALITY_THRESHOLD = 18            # quals below this are floored to MIN_QUALITY
MAX_REPEAT_LENGTH = 20                # STR repeat count cap for the PCR model
MAX_STR_UNIT_LENGTH = 8               # max STR unit length searched
TRISTATE_CORRECTION = 3.0             # mismatch emission divisor
GAP_CONTINUATION_PHRED = 10           # constant GCP ('+' - 33; pairhmm_internal.cpp:560-562)

INITIAL_CONSTANT_F32 = float(np.ldexp(np.float32(1.0), 120))    # 2^120
INITIAL_CONSTANT_F64 = float(np.ldexp(1.0, 1020))               # 2^1020
LOG10_INITIAL_CONSTANT_F32 = 36.1236000061                      # adapter.h:26
LOG10_INITIAL_CONSTANT_F64 = 307.050595577260822                # adapter.h:27
MIN_ACCEPTED_F32 = 1e-28              # float result below this reruns in double

# Likelihood post-processing (adapter.h:20-24)
LOG10_QUALITY_PER_BASE = -4.0
EXPECTED_ERROR_RATE_PER_BASE = 0.02
MAXIMUM_EXPECTED_ERROR_PER_READ = 2.0
MAXIMUM_BEST_ALT_LIKELIHOOD_DIFFERENCE = -4.5

# PCR indel model gap-open caps indexed by tandem-repeat length 0..20
# (adapter.h:13-15)
PCR_INDEL_MODEL_HOSTILE = np.array(
    [40, 40, 39, 38, 37, 36, 34, 32, 28, 23, 17, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10],
    dtype=np.uint8)
PCR_INDEL_MODEL_AGGRESSIVE = np.array(
    [40, 40, 40, 39, 39, 39, 38, 38, 37, 37, 36, 35, 34, 33, 32, 30, 28, 26, 23, 20, 17],
    dtype=np.uint8)
PCR_INDEL_MODEL_CONSERVATIVE = np.array(
    [40, 40, 40, 40, 39, 39, 39, 39, 39, 38, 38, 38, 37, 37, 37, 36, 36, 35, 34, 33, 33],
    dtype=np.uint8)

# Base encoding for PairHMM match test: match iff (read_code & hap_code) != 0
# (pairhmm_internal.cpp:27-43)
BASE_A, BASE_C, BASE_T, BASE_G, BASE_N = 0x1, 0x2, 0x4, 0x8, 0xF

# Default gap-open penalty for reads without BI/BD tags (GATK convention: 45)
DEFAULT_GAP_OPEN_PHRED = 45

# --- Read filtering (reference: src/common/reads_filter_hc.h:15-49) ---
READ_FILTER_MIN_MAPPING_QUALITY = 20
READ_FILTER_UNAVAILABLE_MAPPING_QUALITY = 255

# --- Positional downsampler, Java LCG (reference: src/common/downsampler_hc.h:10-13) ---
DOWNSAMPLE_DEFAULT_TARGET = 50
JAVA_LCG_MULTIPLIER = 0x5DEECE66D
JAVA_LCG_ADDEND = 0xB
JAVA_LCG_MASK = (1 << 48) - 1
DOWNSAMPLER_SEED = 25170011922

# --- Activity profile / active-region engine
#     (reference: src/haplotypecaller/ActiveRegion/ActiveRegionEngine.h:133-137,
#      ActiveMainThread.h:194-210, haplotypecaller_engine.cpp:28-29) ---
ACTIVITY_FILTER_SIZE = 50             # Gaussian half-width (filter spans 2*50+1 taps)
ACTIVITY_SIGMA = 17.0
ACTIVE_PROB_THRESHOLD = 0.002
REGION_MIN_SIZE = 50
REGION_MAX_SIZE = 300
REGION_PADDING = 100                  # reads overlapping region +- this are attached
REFERENCE_PADDING = 500               # reference context attached to each region

# --- Genotyping defaults (reference: src/haplotypecaller/genotype/genotype_argument.h:15-83) ---
SAMPLE_PLOIDY = 2
MAX_ALTERNATE_ALLELES = 6
MAX_GENOTYPE_COUNT = 1024
SNP_HETEROZYGOSITY = 1.0e-3
INDEL_HETEROZYGOSITY = 1.25e-4
HETEROZYGOSITY_STDEV = 0.01
SNP_PADDING_FOR_GENOTYPING = 20
STR_PADDING_FOR_GENOTYPING = 75
INDEL_PADDING_FOR_GENOTYPING = 75
STANDARD_CONFIDENCE_VCF = 30.0
STANDARD_CONFIDENCE_GVCF = 0.0
MAPPING_QUALITY_THRESHOLD = 20
INFORMATIVE_READ_OVERLAP_MARGIN = 2
MIN_READ_LENGTH_AFTER_TRIMMING = 10
MAX_MNP_DISTANCE = 0

# --- Assembly (reference: src/haplotypecaller/haplotypecaller_engine.cpp:60,
#     apply/assemble/hc_assemble_reads.c:46-60, hc_assemble_dijkstra_shortest_path.c:22) ---
ASSEMBLY_KMER_SIZES = (10, 25)
ASSEMBLY_KMER_STEP = 10
ASSEMBLY_MAX_KMER_ITERATIONS = 6
MAX_HAPLOTYPES_PER_REGION = 128
MIN_BASE_QUALITY_TO_USE_IN_ASSEMBLY = 10
PRUNE_FACTOR = 2
MIN_DANGLING_BRANCH_LENGTH = 4
NUM_PRUNING_SAMPLES = 1

# --- Smith-Waterman parameter sets {match, mismatch, gapOpen, gapExtend}
#     (reference: src/rovaca_tool_args.h:40-42) ---
SW_DANGLING_END = (25, -50, -110, -6)
SW_HAPLOTYPE_TO_REFERENCE = (200, -150, -260, -11)
SW_READ_TO_HAPLOTYPE = (10, -15, -30, -5)

# --- Reference-confidence / GVCF (reference: src/rovaca_tool_args.h:62,
#     reference_confidence_model.cpp:25-27, haplotypecaller.cpp:217-228) ---
REF_MODEL_DELETION_QUAL = 30
MAX_N_INDEL_INFORMATIVE_READS = 40
MAX_INDEL_SIZE = 10
DEFAULT_GVCF_GQ_BANDS = tuple(range(1, 61)) + (70, 80, 90, 99)

# --- CLI defaults (reference: src/rovaca_tool_args.h:137-146) ---
DEFAULT_MAX_READS_DEPTH = 50
DEFAULT_BASE_QUALITY_THRESHOLD = 18
DEFAULT_MIN_BASE_QUALITY_SCORE = 10
DEFAULT_INTERVAL_PADDING = 0
WES_PREPADDING = 100
