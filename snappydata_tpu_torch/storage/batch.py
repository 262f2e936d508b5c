"""ColumnBatch — the immutable unit of columnar storage.

Equivalent of the reference's column batch (key=(batchId, bucketId,
columnIndex) region entries, encoders/.../impl/ColumnFormatEntry.scala:61-97
with meta columns statsRow=-1, deltaStatsRow=-2, deleteMask=-3). Here a
batch is a single host object holding every encoded column plus the stats
row; deltas and delete masks are NOT stored inside it — they live in the
manifest's BatchView so that snapshots are immutable (MVCC, see
table_store.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.storage.encoding import ColumnStats, EncodedColumn, encode_column


@dataclasses.dataclass(frozen=True)
class ColumnBatch:
    batch_id: int
    bucket_id: int
    num_rows: int
    capacity: int
    columns: tuple  # Tuple[EncodedColumn], one per schema field

    @property
    def stats(self) -> List[Optional[ColumnStats]]:
        return [c.stats for c in self.columns]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    @staticmethod
    def from_arrays(batch_id: int, bucket_id: int, schema: T.Schema,
                    arrays: List[np.ndarray], capacity: int,
                    validities: Optional[List[Optional[np.ndarray]]] = None,
                    dictionaries: Optional[dict] = None,
                    precoded: Optional[dict] = None) -> "ColumnBatch":
        """Encode one batch from per-column host arrays (ref
        ColumnInsertExec's per-column encoder loop, ColumnInsertExec.scala:92).

        `dictionaries` maps column index → shared table-level dictionary for
        string columns (codes comparable across batches); `precoded` maps
        column index → ready EncodedColumn (fused native encode path)."""
        n = int(arrays[0].shape[0])
        assert n <= capacity, (n, capacity)
        cols = []
        for i, (f, arr) in enumerate(zip(schema.fields, arrays)):
            if precoded and i in precoded:
                cols.append(precoded[i])
                continue
            validity = validities[i] if validities else None
            hint = dictionaries.get(i) if dictionaries else None
            cols.append(encode_column(np.asarray(arr), f.dtype, validity,
                                      dictionary_hint=hint))
        return ColumnBatch(batch_id, bucket_id, n, capacity, tuple(cols))
