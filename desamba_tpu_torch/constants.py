"""Constants of the classify path, with the same values as the JAX package's.

Each value names the line it copies: `constants.py` (the reference engine's
compile-time constants, each citing its C source line there) or
`engine/fast_engine.py` (the fast path's static schedule and caps), both
under desamba_tpu/. tests/test_torch_host.py holds every value equal to
its source.
"""
from __future__ import annotations

# ---- reference engine (desamba_tpu/constants.py) ----------------------
L_PRE_IDX = 13               # 13-base prefix hash             (:9)
PRE_IDX_MASK = 0x3FFFFFF     # 26-bit prefix mask              (:10)
MIN_UNI_L = 35               # min unitig length kept          (:11)
BP_PER_BLOCK = 256           # FM occ block size in bp         (:12)
BLOCK_BYTES = 168            # 40 B base + 128 B codes         (:13)
SINGLE_BASE_MAX_RATIO = 0.8  # low-complexity filter           (:23)
# e_kmer size ladder: (max n_kmer threshold exclusive, table bytes,
#                      hash mask bits, e-kmer length)           (:26-35)
EK_SIZE_LADDER = [
    ((1 << 31) // 9, 0x8000000, 30, 16),
    ((1 << 32) // 9, 0x10000000, 31, 17),
    ((1 << 33) // 9, 0x20000000, 32, 17),
    ((1 << 34) // 9, 0x40000000, 33, 18),
    ((1 << 35) // 9, 0x80000000, 34, 18),
    ((1 << 36) // 9, 0x100000000, 35, 19),
    ((1 << 37) // 9, 0x200000000, 36, 19),
    ((1 << 38) // 9, 0x400000000, 37, 20),
]
MIN_READ_LEN = 40            # shorter reads are not classified (:38)
STEP_EK = 3                  # island probe stride             (:39)
SEED_RANGE = 100             # top-seed window                 (:40)
MEM_SEARCH_FAST = 2          # fast_classify's max_rst         (:42)
MIN_MEM_LEN_FAST = 21        #                                 (:43)
MEM_SEARCH_SLOW = 8          # slow_classify's max_rst         (:44)
MIN_MEM_LEN_SLOW = 20        #                                 (:45)
LV_ERROR = 4                 # max LV edit distance            (:46)
LV_L = 12                    # max LV query length             (:47)
MIN_S_1 = 12                 #                                 (:48)
MIN_S_2 = 20                 #                                 (:49)
SP_SET_CAP = 500             # dedup ring capacity             (:50)
MAX_DIS_MINUS = 30           # chain diagonal tolerance        (:55)
MAX_WAITING_LEN = 400        # chain gap cap                   (:56)
MAX_ANCHOR_OVERLAP = 3       #                                 (:57)
CHAIN_M3_THRESHOLD = 50      # anchors >= 50: SDP chaining     (:58)
S_A_KMER_L = 9               # sparse-align k-mer length       (:61)
MIN_SCORE_MEM = 12           #                                 (:62)
OVER_SEARCH_M2 = 50          #                                 (:63)
MAX_SMS_OVERLAP = 6          #                                 (:64)
FILTER_MIN_SCORE_2G = 26     # NGS reads                       (:67)
FILTER_MIN_SCORE_SHORT_3G = 30  # short 3G reads               (:68)
NGS_MAX_READ_L = 510         #                                 (:69)
SHORT_3G_READ_L = 310        #                                 (:70)
DEFAULT_FILTER_MIN_LENGTH = 170  # -l default                  (:71)
DEFAULT_MIN_SCORE = 64       # -s default                      (:72)
DEFAULT_MAX_SEC_N = 5        # -r default                      (:73)
P_E = 0.15                   # MAPQ model                      (:77)
Q_MEM_MAX = 2000             #                                 (:78)
MAX_LV_WRONG = 20            #                                 (:79)
MAX_LV_R_LEN = 20            #                                 (:80)
N_NEEDED = 5000              # reads per batch                 (:83)
PRIMARY, SECONDARY, SUPPLEMENTARY = 1, 2, 3  # hit kinds       (:88)

# ---- fast path schedule (desamba_tpu/engine/fast_engine.py) -----------
ROWS_PER_SEARCH = 2          # MEM_SEARCH_FAST                 (:86)
FM_EXT_CAP = 28              # lockstep interval-search depth  (:87)
REFPOS_PER_ANCHOR = 4        # occurrences expanded per anchor (:94)
VOTE_TILE = 64               # anchors per vote scan step      (:96)
IV_BURST = 2                 # interval-search burst rounds    (:98)
IV_MID = 8                   # second interval phase rounds    (:105)
WALK_BURST = 12              # row-walk burst rounds           (:106)
WALK_MID = 16                # second walk phase rounds        (:107)
WALK_TAIL = 32               # final walk phase rounds         (:108)
# packed result-row order of the [7, Bp] chunk result; row 6 is the
# strand-folded n_exist                                         (:556)
PACK_KEYS = ("score", "ref", "direction", "cov", "pos", "score_alt")
AMB_MARGIN = 8               # replay below this cross-ref gap (:582)
AMB_MARGIN_LARGE = 24        # ... once the index has AMB_LARGE_L rows (:586)
AMB_LARGE_L = 1 << 27        #                                 (:593)
AMB_MIN_EXIST = 1            # unclassified reads with this many exist hits
                             # on the probe grid are replayed   (:594)
LONG_OVERLAP = 512           # overlap of long-read segments    (:842)


def _pow2(n: int, lo: int = 64) -> int:
    """Smallest power-of-two multiple of lo that is >= n (:65-69)."""
    v = lo
    while v < n:
        v <<= 1
    return v


def _bucket(n: int, lo: int = 256) -> int:
    """Width bucket: powers of two up to 2048, then steps of 1024 (:72-83).
    Every width is a multiple of 256 and of 16 (the packed wire format)."""
    v = lo
    while v < n and v < 2048:
        v <<= 1
    if v >= n:
        return v
    return -(-n // 1024) * 1024


def _band(W: int) -> int:
    """Half-width of the stage-4 diagonal band (:116-124)."""
    return min(128, max(32, W >> 5))
