"""Buffer codecs.  zlib (stdlib) stands in for snappy/zstd."""

from __future__ import annotations

import zlib

NONE, ZLIB = "none", "zlib"


def compress(codec: str, buf: bytes, level: int = 1) -> bytes:
    if codec == NONE:
        return buf
    if codec == ZLIB:
        return zlib.compress(buf, level)
    raise ValueError(codec)


def decompress(codec: str, buf: bytes) -> bytes:
    if codec == NONE:
        return buf
    if codec == ZLIB:
        return zlib.decompress(buf)
    raise ValueError(codec)
