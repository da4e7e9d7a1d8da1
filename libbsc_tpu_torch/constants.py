"""Public constants mirroring the reference ABI (libbsc.h:36-84)."""

LIBBSC_VERSION_STRING = "3.3.5"  # format-compatible with reference libbsc 3.3.5

# Error codes (libbsc.h:41-51)
NO_ERROR = 0
BAD_PARAMETER = -1
NOT_ENOUGH_MEMORY = -2
NOT_COMPRESSIBLE = -3
NOT_SUPPORTED = -4
UNEXPECTED_EOB = -5
DATA_CORRUPT = -6
GPU_ERROR = -7
GPU_NOT_SUPPORTED = -8
GPU_NOT_ENOUGH_MEMORY = -9

# Block sorters (libbsc.h:53-65)
BLOCKSORTER_NONE = 0
BLOCKSORTER_BWT = 1
# format extension (mode-gated like CODER_QLFC_WIDE): BWT with a high-rate
# aux-index tail (~n/4096 sampling) exposing thousands of parallel
# inverse-LF chains for the device unbwt; old decoders reject the id
BLOCKSORTER_BWT_WIDEAUX = 2
BLOCKSORTER_ST3 = 3
BLOCKSORTER_ST4 = 4
BLOCKSORTER_ST5 = 5
BLOCKSORTER_ST6 = 6
BLOCKSORTER_ST7 = 7
BLOCKSORTER_ST8 = 8

# Entropy coders (libbsc.h:67-70)
CODER_NONE = 0
CODER_QLFC_STATIC = 1
CODER_QLFC_ADAPTIVE = 2
CODER_QLFC_FAST = 3
CODER_QLFC_WIDE = 4  # format extension: wide-lane lockstep profile (ops/wide.py)

# Features bitmask (libbsc.h:72-76)
FEATURE_NONE = 0
FEATURE_FASTMODE = 1
FEATURE_MULTITHREADING = 2
FEATURE_LARGEPAGES = 4
FEATURE_CUDA = 8  # requests the CUDA route (the reference's -G)

# Defaults (libbsc.h:78-82)
DEFAULT_LZPHASHSIZE = 15
DEFAULT_LZPMINLEN = 128
DEFAULT_BLOCKSORTER = BLOCKSORTER_BWT
DEFAULT_CODER = CODER_QLFC_STATIC
DEFAULT_FEATURES = FEATURE_FASTMODE | FEATURE_MULTITHREADING

# Per-block header size in bytes (libbsc.h:84)
HEADER_SIZE = 28

ALPHABET_SIZE = 256

# Maximum input sizes (libbsc.cpp:124,259)
MAX_COMPRESS_SIZE = 1073741824
MAX_COMPRESS_INPLACE_SIZE = 2146435072

# Sorting context conventions (filters.h:36-37, bsc.cpp:48)
CONTEXTS_FOLLOWING = 1
CONTEXTS_PRECEDING = 2
CONTEXTS_AUTODETECT = 3

# LZP stream flag byte (lzp.cpp:42)
LZP_MATCH_FLAG = 0xF2
