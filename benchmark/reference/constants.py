"""RFC 7932 format constants.

Single source of truth for every alphabet size and limit in the Brotli
format. Mirrors the *semantics* of the reference's ``c/common/constants.h``
(cited for parity checking only); all values here are normative per RFC 7932.
"""

# --- Alphabets (RFC 7932 sections 3.4, 4, 5) -------------------------------
NUM_LITERAL_SYMBOLS = 256
NUM_COMMAND_SYMBOLS = 704  # combined insert-and-copy length codes
NUM_BLOCK_LEN_SYMBOLS = 26
NUM_DISTANCE_SHORT_CODES = 16
MAX_NPOSTFIX = 3
MAX_NDIRECT = 120
MAX_DISTANCE_BITS = 24  # regular streams
LARGE_MAX_DISTANCE_BITS = 62  # large-window streams

NUM_INSERT_LEN_CODES = 24
NUM_COPY_LEN_CODES = 24

# Context modeling (RFC 7932 section 7.1)
LITERAL_CONTEXT_BITS = 6  # 64 literal contexts per block type
DISTANCE_CONTEXT_BITS = 2  # 4 distance contexts per block type
NUM_LITERAL_CONTEXTS = 1 << LITERAL_CONTEXT_BITS
NUM_DISTANCE_CONTEXTS = 1 << DISTANCE_CONTEXT_BITS

# Block types (RFC 7932 section 6)
MAX_BLOCK_TYPES = 256

# Huffman coding (RFC 7932 section 3)
HUFFMAN_MAX_CODE_LENGTH = 15
CODE_LENGTH_CODES = 18
HUFFMAN_MAX_CODE_LENGTH_CODE_LENGTH = 5
INITIAL_REPEATED_CODE_LENGTH = 8
REPEAT_PREVIOUS_CODE_LENGTH = 16  # code-length symbol: repeat prev len
REPEAT_ZERO_CODE_LENGTH = 17  # code-length symbol: run of zeros

# Order in which code-length-code lengths appear in the stream (RFC 3.5).
CODE_LENGTH_CODE_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12,
                          13, 14, 15)

# The fixed prefix code used to encode the code-length-code lengths
# (RFC 7932 section 3.5): symbol -> (code, length). Codes are stored so that
# bit k (LSB) of the code is the (k+1)-th bit read from the stream.
# Parity anchor: c/dec/decode.c kCodeLengthPrefix{Length,Value}.
CODE_LENGTH_CODE_FIXED = {
    0: (0b0000, 2),   # reads as 0,0
    1: (0b0111, 4),   # reads as 1,1,1,0
    2: (0b0011, 3),   # reads as 1,1,0
    3: (0b0010, 2),   # reads as 0,1
    4: (0b0001, 2),   # reads as 1,0
    5: (0b1111, 4),   # reads as 1,1,1,1
}

# --- Window / stream limits (RFC 7932 section 9) ---------------------------
WINDOW_GAP = 16
MIN_WINDOW_BITS = 10
MAX_WINDOW_BITS = 24
LARGE_MIN_WINDOW_BITS = 10
LARGE_MAX_WINDOW_BITS = 30
MAX_ALLOWED_DISTANCE = 0x7FFFFFFC

MIN_INPUT_BLOCK_BITS = 16
MAX_INPUT_BLOCK_BITS = 24
MAX_METABLOCK_SIZE = 1 << 24  # MLEN limit per metablock

# Initial distance ring buffer (RFC 7932 section 4).
INITIAL_DISTANCE_RB = (16, 15, 11, 4)

# Static dictionary (RFC 7932 Appendix A; section 8).
MIN_DICTIONARY_WORD_LENGTH = 4
MAX_DICTIONARY_WORD_LENGTH = 24
NUM_TRANSFORMS = 121


def max_backward_distance(window_bits: int) -> int:
    """Maximum LZ77 backward distance for a window (RFC 9.1)."""
    return (1 << window_bits) - WINDOW_GAP


def distance_alphabet_size(npostfix: int, ndirect: int,
                           maxnbits: int = MAX_DISTANCE_BITS) -> int:
    """Distance alphabet size (RFC 7932 section 4 / 3.3)."""
    return NUM_DISTANCE_SHORT_CODES + ndirect + (maxnbits << (npostfix + 1))
