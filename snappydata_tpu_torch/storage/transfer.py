"""Carry encoded column batches into the port's storage unchanged.

`import_batches` takes a table's encoded batches as plain numpy — per
column the encoding kind, the codes or values, the dictionary, the run
lengths, the packed validity bits and the stats; per batch the row count
and capacity — and publishes them in a port table as they are, so both
packages can be shown to scan byte-identical storage rather than merely
the same inserts.

One batch is a dict:

    {"num_rows": int, "capacity": int,
     "columns": [{"encoding": int,            # storage.encoding.Encoding
                  "data": ndarray,            # values / codes / run values
                  "dictionary": ndarray|None, # DICTIONARY, VALUE_DICT
                  "runs": ndarray|None,       # RUN_LENGTH run lengths
                  "validity": ndarray|None,   # packed bits, None = no nulls
                  "stats": (min, max, null_count, count)|None}, ...]}

String columns carry the table's shared dictionary in their DICTIONARY
batches; it is append-only, so the longest one covers every code.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from snappydata_tpu_torch.storage.batch import ColumnBatch
from snappydata_tpu_torch.storage.encoding import (ColumnStats,
                                                   EncodedColumn, Encoding)


def import_batches(session, table: str, batches: Sequence[dict]) -> int:
    """Publish `batches` in `table` of `session`; returns the rows added."""
    info = session.catalog.describe(table)
    data = info.data
    fields = info.schema.fields
    built: List[ColumnBatch] = []
    string_dicts: Dict[int, np.ndarray] = {}
    for b in batches:
        num_rows, capacity = int(b["num_rows"]), int(b["capacity"])
        if capacity != data.capacity:
            raise ValueError(f"batch capacity {capacity} != the table's "
                             f"{data.capacity}")
        if len(b["columns"]) != len(fields):
            raise ValueError(f"expected {len(fields)} columns, got "
                             f"{len(b['columns'])}")
        cols = []
        for ci, (f, c) in enumerate(zip(fields, b["columns"])):
            enc = Encoding(int(c["encoding"]))
            st = c.get("stats")
            cols.append(EncodedColumn(
                enc, f.dtype, num_rows, np.asarray(c["data"]),
                dictionary=_opt(c.get("dictionary")),
                runs=_opt(c.get("runs")),
                validity=_opt(c.get("validity")),
                stats=ColumnStats(*st) if st is not None else None))
            d = c.get("dictionary")
            if f.dtype.name == "string" and d is not None \
                    and len(d) > len(string_dicts.get(ci, ())):
                string_dicts[ci] = np.asarray(d, dtype=object)
        built.append(ColumnBatch(0, 0, num_rows, capacity, tuple(cols)))
    data.append_batches(built, string_dicts)
    return sum(b.num_rows for b in built)


def _opt(a):
    return None if a is None else np.asarray(a)
