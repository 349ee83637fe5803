"""Global constants for the TPU-native SNAP-RNA aligner.

These mirror the *behavioral* constants of the reference implementation
(andrewmagis/snap-rnaseq) so that alignment results are comparable:

- MAX_K:                reference SNAPLib/LandauVishkin.h:9
- SNP/GAP probabilities: reference SNAPLib/BaseAligner.h:264-266
- maxMergeDist:         reference SNAPLib/BaseAligner.h:163
- InvalidGenomeLocation: reference SNAPLib/Genome.h:29
- default aligner options: reference SNAPLib/AlignerOptions.cpp:55-84
- MAPQ_LIMIT_FOR_SINGLE_HIT: reference SNAPLib/AlignerOptions.h:34
"""

MAX_K = 31                      # Max edit distance the banded LV kernel supports.
MAX_READ_LENGTH = 512           # Reference uses 500 (Read.h:45); we round to a lane-friendly 512.

SNP_PROB = 0.001
GAP_OPEN_PROB = 0.001
GAP_EXTEND_PROB = 0.5

INVALID_GENOME_LOCATION = 0xFFFFFFFF
UNUSED_HASH_VALUE = 0xFFFFFFFE  # value half of a hash entry with no hits (HashTable.h "unused")

MAX_MERGE_DIST = 48             # candidates within this distance are one logical alignment
MAPQ_LIMIT_FOR_SINGLE_HIT = 10
MAX_MAPQ = 70

DEFAULT_CHROMOSOME_PADDING = 500   # 'n' bases inserted around every chromosome (GenomeIndex.cpp:43)

MIN_SEED_LENGTH = 16
MAX_SEED_LENGTH = 25

# Default operating points (AlignerOptions.cpp:73-82)
SINGLE_DEFAULTS = dict(max_dist=14, num_seeds=25, max_hits=300)
PAIRED_DEFAULTS = dict(max_dist=15, num_seeds=8, max_hits=16000,
                       min_spacing=50, max_spacing=1000)
DEFAULT_EXTRA_SEARCH_DEPTH = 2
DEFAULT_CONF_DIFF = 2

# Read-level quality filter defaults (AlignerOptions.cpp:69-71, SingleAligner.cpp:246-257)
DEFAULT_MIN_PERCENT_ABOVE_PHRED = 90.0
DEFAULT_MIN_PHRED = 20
DEFAULT_PHRED_OFFSET = 33
DEFAULT_MIN_READ_LENGTH = 50

# Base codes.  The reference (Tables.cpp) uses A=0, G=1, C=2, T=3 so that a
# base's complement is its bitwise negation (code ^ 3).  We keep that and add:
#   4 = 'N' (in reads / raw FASTA)
#   5 = 'n' (genome padding + genome Ns; the reference lowercases genome Ns
#            specifically so they never match read Ns — FASTA.cpp:104-117)
BASE_A, BASE_G, BASE_C, BASE_T, BASE_N, BASE_PAD = 0, 1, 2, 3, 4, 5
