"""File-format constants, byte-compatible with the reference archives
(reference: include/tomahawk.h:44-70)."""

TWK_MAGIC = b"TOMAHAWK\x01"            # .twk archives
TWO_MAGIC = b"TWO\x01"                 # .two LD-record streams
TWOAGG_MAGIC = b"TWOAGG\x01"           # .twa aggregate rasters

# EOF sentinels. The reference stores these as 64-char hex strings but writes
# only the first 32 ASCII characters (std::string::data() with length 32;
# reference: include/tomahawk.h:66-70).
FILE_EOF = b"a4f54f39f5e251a6993796f48164ccf554f1b680c2ebbb13be301f3ff76f82cf"[:32]
TWOAGG_EOF = b"48814f3c53866e57bac4d87d2b800ed7de295ae6caa39e198f9ffa169bd2bee3"[:32]

INDEX_START_MARKER = 1954702206512158641  # uint64 guard before every index

# Sorted-state enum for .two indices (reference: include/index.h:103-105)
TWK_IDX_UNSORTED = 0
TWK_IDX_PARTIAL = 1
TWK_IDX_SORTED = 2

# Allele single-base encoding (reference TWK_BASE_MAP, include/core.h:38-49:
# 'A'->0 (and every unmapped byte), 'T'->1, 'G'->2, 'C'->3, 'N'->4).
BASE_MAP = {"A": 0, "T": 1, "G": 2, "C": 3, "N": 4}
BASE_MAP_INV = "ATGC"  # TWK_BASE_MAP_INV (include/core.h:49)

# TWO record flag bits (reference: include/core.h:770-783)
FLAG_USED_PHASED_MATH = 1 << 0
FLAG_SAME_CONTIG = 1 << 1
FLAG_LONG_RANGE = 1 << 2
FLAG_COMPLETE_LD = 1 << 3
FLAG_PERFECT_LD = 1 << 4
FLAG_MULTIPLE_ROOTS = 1 << 5
# bits 6-7 are vestigial in the reference too: nothing ever sets them
# (its -S sampling / fast mode is disabled at include/core.h:777-779);
# defined here so flag masks round-trip, never produced
FLAG_FAST_MODE = 1 << 6
FLAG_SAMPLED = 1 << 7
FLAG_MISSING_A = 1 << 8
FLAG_MISSING_B = 1 << 9
FLAG_LOW_AC_A = 1 << 10
FLAG_LOW_AC_B = 1 << 11
FLAG_INVALID_HWE_A = 1 << 12
FLAG_INVALID_HWE_B = 1 << 13

# Thresholds used when setting flags (reference: lib/ld/ld_engine.h:33-37)
LOW_AC_THRESHOLD = 5
INVALID_HWE_THRESHOLD = 1e-4
LONG_RANGE_THRESHOLD = 500e3
MINIMUM_ALLOWED_ALLELES = 5
ALLOWED_ROUNDING_ERROR = 1e-5
