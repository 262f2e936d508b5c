"""String interning for column ingest.

Port of the vectorized pandas path of snappydata_tpu/native/__init__.py
(`fast_encode_strings`), which that module documents as the equivalent of
its C++ encoder: values intern into the table's append-only dictionary in
first-appearance order, so the same inserts mint the same codes in both
packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fast_encode_strings(values: np.ndarray, lookup: dict, store: list
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One pass: intern `values` into (lookup, store) and return
    (int32 codes, null mask | None)."""
    import pandas as pd

    values = np.ascontiguousarray(np.asarray(values, dtype=object))
    # pandas-style missing markers (float NaN, pd.NA) are SQL NULLs
    na = pd.isna(values)
    if na.any():
        values = values.copy()
        values[na] = None
    # factorize in C, walk only the uniques in Python
    inverse, uniques = pd.factorize(values, use_na_sentinel=True)
    trans = np.empty(max(1, len(uniques)), dtype=np.int32)
    for j, v in enumerate(uniques.tolist()):
        code = lookup.get(v)
        if code is None:
            code = len(store)
            lookup[v] = code
            store.append(v)
        trans[j] = code
    nulls = inverse < 0
    codes = trans[np.maximum(inverse, 0)].astype(np.int32)
    if nulls.any():
        codes = np.where(nulls, 0, codes)
        return codes, nulls
    return codes, None
