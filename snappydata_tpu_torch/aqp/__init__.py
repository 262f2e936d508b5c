"""Approximate Query Processing (AQP/SDE).

The reference ships this as a closed-source plug-in behind
SnappyContextFunctions hooks (core/.../SnappyContextFunctions.scala:29-94;
docs/aqp.md): stratified samples (CREATE SAMPLE TABLE ... OPTIONS (qcs,
fraction)), error-bounded SUM/AVG/COUNT rewrites, and TopK structures
backed by CountMinSketch + StreamSummary (the clearspring utilities
vendored in core). Same shape here: a plug-in package the session calls
into, nothing in the core engine depends on it.  Port of
snappydata_tpu/aqp: host numpy code; the estimation's per-(group,
stratum) moment reduction is an ordinary aggregate over the sample's
device plates.
"""

from snappydata_tpu_torch.aqp.sampling import StratifiedReservoir  # noqa: F401
from snappydata_tpu_torch.aqp.sketches import CountMinSketch, TopKSummary  # noqa: F401
from snappydata_tpu_torch.aqp.rewrite import approx_rewrite  # noqa: F401
