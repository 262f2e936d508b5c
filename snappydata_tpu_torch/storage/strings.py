"""The plain version of the native string-intern encoder.

Port of the vectorized pandas path of snappydata_tpu/native/__init__.py,
the twin of `csrc/fastingest.cpp` (`snappydata_tpu_torch.native`): values
intern into the table's append-only dictionary in first-appearance order,
so the same inserts mint the same codes through either encoder and in
both packages.  Ingest calls `native.fast_encode_strings`, which comes
here only when the C++ encoder cannot be built.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def encode_plain(values: np.ndarray, lookup: dict, store: list
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Intern the object array `values` (missing markers already None)
    into (lookup, store); return (int32 codes, null mask | None)."""
    import pandas as pd

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
