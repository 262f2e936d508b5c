"""Packed validity bitmaps (Arrow little-endian bit order).

Replaces the reference's unsafe long-array null bitset
(encoders/.../encoding/BitSet.scala, ColumnEncoding.scala:37-53 nulls
header). Packed form is the at-rest/persistence format; on device nulls are
bool masks (TPU vector units want lanes, not bit twiddling).
"""

from __future__ import annotations

import numpy as np


def pack(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> uint8[ceil(n/8)] with little-endian bit order."""
    return np.packbits(mask.astype(np.uint8), bitorder="little")


def unpack(packed: np.ndarray, n: int) -> np.ndarray:
    """uint8[ceil(n/8)] -> bool[n]."""
    return np.unpackbits(packed, count=n, bitorder="little").astype(np.bool_)


def popcount(packed: np.ndarray, n: int) -> int:
    return int(unpack(packed, n).sum())
