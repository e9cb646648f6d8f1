"""Releases of scripts, each sent compressed against the release before
it: RFC 9842's dictionary-compressed brotli (`dcb`, Compression
Dictionary Transport).

A site ships a new release of a JavaScript bundle. A browser that still
holds the release before asks for the new one and names the old one as
its dictionary; the site answers with the new release compressed with
the old one as a raw (compound) LZ77 dictionary, as upstream's
`brotli -D OLD` does (c/tools/brotli.c). The traffic's `pairs` are
(older, newer) files of real releases, copied byte for byte into
benchmark/data/<folder> with their licences (NOTICE.txt there): the
documents are the newer files and each document's dictionary is the
older one of its pair.

Document i of a pool made from the run's seed s is pair (s + i) mod n:
the seed rotates the pool's order and never changes its sizes or bytes.
"""

import pathlib

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def _pairs(seed: int, pairs) -> list:
    k = seed % len(pairs)
    return list(pairs[k:]) + list(pairs[:k])


def documents(seed: int, folder: str, pairs) -> list:
    """The newer release of each pair, in the pool's order."""
    return [(DATA / folder / new).read_bytes()
            for _, new in _pairs(seed, pairs)]


def dictionaries(seed: int, folder: str, pairs) -> list:
    """The older release of each pair, in the order of `documents`."""
    return [(DATA / folder / old).read_bytes()
            for old, _ in _pairs(seed, pairs)]
