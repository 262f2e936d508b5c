"""Spark-compatible Murmur3 x86_32 hashing.

The reference's single most load-bearing trick for avoiding shuffles is
that store bucket placement uses the SAME hash as Catalyst's
HashPartitioning (StoreHashFunction.computeHash, core/.../store/
StoreHashFunction.scala:109-118) — so a join or group-by keyed on the
partitioning column needs no exchange. We reproduce that contract:
`murmur3_hash_np` matches Spark's Murmur3_x86_32 with seed 42 for
int/long inputs (each int is hashed as its 4-byte little-endian block;
longs hash low then high word, matching Spark's hashLong).

Port of snappydata_tpu/parallel/hashing.py: vectorized numpy for
placement and for the AQP sketches (aqp/sketches.py).
"""

from __future__ import annotations

import numpy as np

SPARK_SEED = np.uint32(42)

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_k1(k1):
    k1 = (k1 * _C1).astype(np.uint32)
    k1 = _rotl32(k1, 15)
    return (k1 * _C2).astype(np.uint32)


def _mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return (h1 * np.uint32(5) + np.uint32(0xE6546B64)).astype(np.uint32)


def _fmix(h1, length):
    h1 = h1 ^ np.uint32(length)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = (h1 * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = (h1 * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return h1 ^ (h1 >> np.uint32(16))


def hash_int32_np(values: np.ndarray, seed=SPARK_SEED) -> np.ndarray:
    """Spark Murmur3_x86_32.hashInt for a vector of int32."""
    with np.errstate(over="ignore"):
        k1 = _mix_k1(values.astype(np.int64).astype(np.uint32))
        h1 = _mix_h1(np.broadcast_to(np.uint32(seed),
                                     values.shape).astype(np.uint32), k1)
        return _fmix(h1, 4).astype(np.int32)


def hash_int64_np(values: np.ndarray, seed=SPARK_SEED) -> np.ndarray:
    """Spark Murmur3_x86_32.hashLong: low word then high word."""
    with np.errstate(over="ignore"):
        v = values.astype(np.int64)
        low = (v & 0xFFFFFFFF).astype(np.uint32)
        high = ((v >> 32) & 0xFFFFFFFF).astype(np.uint32)
        h1 = np.broadcast_to(np.uint32(seed), v.shape).astype(np.uint32)
        h1 = _mix_h1(h1, _mix_k1(low))
        h1 = _mix_h1(h1, _mix_k1(high))
        return _fmix(h1, 8).astype(np.int32)


def hash_bytes(b: bytes, seed=SPARK_SEED) -> int:
    """Spark Murmur3_x86_32.hashUnsafeBytes: little-endian 4-byte words,
    then each remaining byte mixed as a full (sign-extended) word."""
    with np.errstate(over="ignore"):
        n = len(b)
        aligned = n - n % 4
        h1 = np.uint32(seed)
        if aligned:
            for w in np.frombuffer(b, dtype="<u4", count=aligned // 4):
                h1 = _mix_h1(h1, _mix_k1(np.uint32(w)))
        for i in range(aligned, n):
            byte = b[i]
            if byte > 127:
                byte -= 256
            h1 = _mix_h1(h1, _mix_k1(np.uint32(byte & 0xFFFFFFFF)))
        return int(np.int32(_fmix(h1, n)))


def hash_strings_np(values, seed=SPARK_SEED) -> np.ndarray:
    """UTF8 murmur3 for an object/str column; NULL hashes to the seed
    (Spark's HashPartitioning skips null children, leaving the seed)."""
    cache = {}
    out = np.empty(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        h = cache.get(v)
        if h is None:
            if v is None:
                h = int(np.int32(np.uint32(seed)))
            elif isinstance(v, bytes):
                # numpy 'S' arrays route here: hash the UTF-8 content,
                # not the repr "b'...'" (the same logical value stored as
                # str vs bytes must land in the same bucket)
                h = hash_bytes(v, seed)
            else:
                h = hash_bytes(str(v).encode("utf-8"), seed)
            cache[v] = h
        out[i] = h
    return out


def murmur3_hash_np(values: np.ndarray, seed=SPARK_SEED) -> np.ndarray:
    """Hash a column the way Spark's HashPartitioning would."""
    values = np.asarray(values)
    if values.dtype.kind in ("O", "U", "S"):
        return hash_strings_np(values, seed)
    if values.dtype in (np.dtype(np.int8), np.dtype(np.int16),
                        np.dtype(np.int32), np.dtype(np.bool_)):
        return hash_int32_np(values, seed)
    if values.dtype == np.dtype(np.int64):
        return hash_int64_np(values, seed)
    if values.dtype == np.dtype(np.float32):
        # match Java floatToIntBits semantics Spark relies on: -0.0f
        # normalizes to 0.0f and every NaN to the canonical NaN pattern
        v = np.where(values == 0.0, np.float32(0.0), values)
        bits = v.view(np.int32)
        bits = np.where(np.isnan(v), np.int32(0x7FC00000), bits)
        return hash_int32_np(bits, seed)
    if values.dtype == np.dtype(np.float64):
        v = np.where(values == 0.0, np.float64(0.0), values)
        bits = v.view(np.int64)
        bits = np.where(np.isnan(v), np.int64(0x7FF8000000000000), bits)
        return hash_int64_np(bits, seed)
    raise TypeError(f"unhashable dtype {values.dtype}")


def bucket_of_np(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Bucket id for each key: Spark's Pmod(hash, n) (non-negative mod)."""
    h = murmur3_hash_np(values).astype(np.int64)
    return ((h % num_buckets) + num_buckets) % num_buckets


# -- the same hash over int64 tensors, on their device ---------------------
# The mesh lane's shuffle exchange buckets its join keys where they live.
# Every product is split so that no int64 intermediate overflows (a 32-bit
# value times a 16-bit half stays under 2^48); the bits equal
# hash_int64_np's.

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2^32 of non-negative 32-bit int64 values `a`."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _rotl32_t(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def hash_int64_torch(values, seed: int = 42):
    """Spark Murmur3_x86_32.hashLong of an int64 tensor (int64 results in
    the signed int32 range), bit-equal to `hash_int64_np`."""
    import torch

    v = values.to(torch.int64)
    h1 = torch.full_like(v, int(seed))
    for word in (v & _M32, (v >> 32) & _M32):
        k1 = _mul32(_rotl32_t(_mul32(word, 0xCC9E2D51), 15), 0x1B873593)
        h1 = _rotl32_t(h1 ^ k1, 13)
        h1 = (_mul32(h1, 5) + 0xE6546B64) & _M32
    h1 = h1 ^ 8
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    h1 = h1 ^ (h1 >> 16)
    return torch.where(h1 >= (1 << 31), h1 - (1 << 32), h1)


def bucket_of_torch(values, num_buckets: int):
    """`bucket_of_np` of an int64 tensor, on its device."""
    h = hash_int64_torch(values)
    return ((h % num_buckets) + num_buckets) % num_buckets
