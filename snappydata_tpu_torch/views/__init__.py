"""Incrementally-maintained materialized aggregates.

`matview.py` holds the whole subsystem: definition validation, the
delta-fold partial programs, the [G]-space device-resident state with
{2^k, 1.5*2^k} bucket-ladder growth, subtraction on deletes, staleness,
checkpoint/recovery glue, and the observability snapshot.
"""

from snappydata_tpu_torch.views.matview import (MaterializedView, MatViewError,
                                          matviews, matviews_on,
                                          view_snapshot)

__all__ = ["MaterializedView", "MatViewError", "matviews", "matviews_on",
           "view_snapshot"]
