"""Stratified reservoir sampling.

Reference behavior (docs/aqp.md:24-43): a SAMPLE TABLE declares QCS (query
column set) columns and a sampling fraction; the sampler keeps a reservoir
PER STRATUM (distinct QCS combination) so rare groups stay represented,
and every sampled row carries `snappy_sampler_weight` = observed/kept for
unbiased scale-up of SUM/COUNT.

Vectorized host implementation (ingest-side); the observe() inner loop is
numpy per-stratum partitioning + Vitter-style acceptance, which keeps up
with the row-buffer ingest path. On-device reservoir update kernels are a
later optimization, per SURVEY.md §7.9.
"""

from __future__ import annotations

import threading
from snappydata_tpu_torch.utils import locks
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


RESERVOIR_WEIGHT_COLUMN = "snappy_sampler_weight"
# hidden ("__"-prefixed) per-row stratum id: closed-form error estimation
# needs within-stratum sample moments, so every materialized sample row
# carries the integer id of the stratum (QCS combination) it came from
STRATUM_ID_COLUMN = "__stratum_id"


class StratifiedReservoir:
    def __init__(self, qcs_indices: Sequence[int], num_columns: int,
                 reservoir_size: int = 50, seed: int = 0):
        self.qcs = list(qcs_indices)
        self.num_columns = num_columns
        self.cap = reservoir_size
        self._rng = np.random.default_rng(seed)
        self._lock = locks.named_lock("aqp.reservoir")
        # stratum key -> (list of row tuples (len == cap max), seen count)
        self._strata: Dict[tuple, Tuple[List[tuple], int]] = {}
        # stable stratum → integer id (materialization order)
        self._stratum_ids: Dict[tuple, int] = {}
        self.version = 0

    def observe(self, arrays: Sequence[np.ndarray]) -> None:
        arrays = [np.asarray(a) for a in arrays]
        n = int(arrays[0].shape[0])
        if n == 0:
            return
        keys = list(zip(*(arrays[i].tolist() for i in self.qcs))) \
            if self.qcs else [()] * n
        with self._lock:
            for i, key in enumerate(keys):
                rows, seen = self._strata.get(key, ([], 0))
                seen += 1
                if len(rows) < self.cap:
                    rows.append(tuple(a[i] for a in arrays))
                else:
                    # classic reservoir: replace with prob cap/seen
                    j = int(self._rng.integers(0, seen))
                    if j < self.cap:
                        rows[j] = tuple(a[i] for a in arrays)
                self._strata[key] = (rows, seen)
            self.version += 1

    def stats(self) -> Dict[tuple, Tuple[int, int]]:
        with self._lock:
            return {k: (len(rows), seen)
                    for k, (rows, seen) in self._strata.items()}

    def to_arrays(self, dtypes) -> Tuple[List[np.ndarray], np.ndarray,
                                         np.ndarray]:
        """Materialize the sample: per-column arrays + weight column +
        stratum-id column (stable insertion-order ids)."""
        with self._lock:
            all_rows: List[tuple] = []
            weights: List[float] = []
            stratum_ids: List[int] = []
            for key, (rows, seen) in self._strata.items():
                sid = self._stratum_ids.setdefault(key,
                                                   len(self._stratum_ids))
                w = seen / max(1, len(rows))
                for r in rows:
                    all_rows.append(r)
                    weights.append(w)
                    stratum_ids.append(sid)
        cols: List[np.ndarray] = []
        for ci in range(self.num_columns):
            vals = [r[ci] for r in all_rows]
            dt = dtypes[ci]
            if dt.name == "string":
                cols.append(np.array(vals, dtype=object))
            else:
                cols.append(np.array(
                    [0 if v is None else v for v in vals],
                    dtype=dt.np_dtype))
        return (cols, np.array(weights, dtype=np.float64),
                np.array(stratum_ids, dtype=np.int64))


class SampleTableMaintainer:
    """Keeps a SAMPLE table's storage in sync with its base table: base
    inserts feed the reservoir, and the sample's column store is refreshed
    lazily before reads (ref: SampleInsertExec keeps samples transactional
    with base inserts)."""

    def __init__(self, sample_info, base_info, reservoir: StratifiedReservoir):
        self.sample_info = sample_info
        self.base_info = base_info
        self.reservoir = reservoir
        self._materialized_version = -1

    def on_insert(self, arrays, nulls=None) -> None:
        self.reservoir.observe(arrays)

    def refresh(self) -> None:
        if self._materialized_version == self.reservoir.version:
            return
        dtypes = [f.dtype for f in self.base_info.schema.fields]
        cols, weights, sids = self.reservoir.to_arrays(dtypes)
        self.sample_info.data.truncate()
        if len(weights):
            self.sample_info.data.insert_arrays(
                list(cols) + [weights, sids])
        self._materialized_version = self.reservoir.version
