"""Decoder error identities, mirroring the reference's public error
enum (c/include/brotli/decode.h:64-105 BrotliDecoderErrorCode). The
negative values match the reference exactly so tooling that knows the
reference's numbers can read ours; codes below -100 are conditions the
reference reports through other channels (result codes / malloc
failure) that a whole-buffer decoder must surface as errors.
"""

import enum


class DecoderError(enum.IntEnum):
    # format errors (decode.h: BROTLI_DECODER_ERROR_FORMAT_*)
    EXUBERANT_NIBBLE = -1
    RESERVED = -2
    EXUBERANT_META_NIBBLE = -3
    SIMPLE_HUFFMAN_ALPHABET = -4
    SIMPLE_HUFFMAN_SAME = -5
    CL_SPACE = -6
    HUFFMAN_SPACE = -7
    CONTEXT_MAP_REPEAT = -8
    BLOCK_LENGTH_1 = -9
    BLOCK_LENGTH_2 = -10
    TRANSFORM = -11
    DICTIONARY = -12
    WINDOW_BITS = -13
    PADDING_1 = -14
    PADDING_2 = -15
    DISTANCE = -16
    BLOCK_SWITCH = -17
    COMPOUND_DICTIONARY = -18
    DICTIONARY_NOT_SET = -19
    INVALID_ARGUMENTS = -20
    # conditions outside the reference's format-error range
    TRUNCATED = -102       # ref: result NEEDS_MORE_INPUT
    ALLOC = -103           # ref: BROTLI_DECODER_ERROR_ALLOC_*
    OUTPUT_TOO_LARGE = -104  # ref: output budget exhausted
    UNREACHABLE = -31


#: code -> short name (for messages and the CLI)
NAMES = {e.value: e.name for e in DecoderError}
