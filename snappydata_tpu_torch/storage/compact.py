"""Background compaction: fold MVCC mutation debris back into clean
encoded batches so the compressed-domain fast paths stay hot.

Every mutation class leaves a residue the compressed-domain scan and
aggregate lanes cannot consume: update deltas disqualify a column's
encoded bind (``compressed_fallback_deltas``), delete masks punch
row-level holes the run-space aggregate can't see (its static gate,
executor._rle_agg_ready, turns the lane off for the whole table), and
force-rollover stubs / divergent per-batch encoder choices leave a
column with MIXED encodings across batches
(``compressed_fallback_mixed_encoding``).  Under sustained ingest those
reasons only accumulate — the fast path decays monotonically.

This module is the counterweight.  A pass:

1. rolls the row buffer (row-buffer rows are a per-bind fallback all by
   themselves),
2. selects debris batches — any view carrying deltas or a delete mask,
   any view whose column encodings sit in the minority for this table,
   and undersized stubs that can merge with them,
3. decodes the selected views' LIVE rows (delta-merged, deletes
   dropped) outside any lock, re-cuts them into full capacity batches
   through the normal encoder (string columns ride their table-shared
   dictionary codes, so code-domain group-by stays valid across the
   rewrite), and
4. republishes through the ordinary manifest swap under the table lock
   — after verifying by OBJECT IDENTITY that every selected view is
   still live (update/delete replace view objects via
   dataclasses.replace, so identity is a race detector; a raced pass
   aborts counted, never publishes a lost update).

Readers need no cooperation: a pinned snapshot keeps its
manifest version — and the device plates cached under it — alive until
unpinned, so a scan mid-flight across a compaction sees one consistent
pre-rewrite table.  The swap is the same publish every INSERT does.

Durability is untouched: compaction re-encodes what the WAL already
made durable (the deltas/deletes it folds each have their own journal
records), so no WAL record is written and recovery replays to the same
logical rows.

Port of snappydata_tpu/storage/compact.py: the synchronous pass
(`run_compaction_pass`) and its selection.  The reference's scheduler
(`maybe_kick` / `_sweep_body`, kicked by the resource broker's admission
path) waits for the broker; a caller runs the pass itself.

Fault injection: the ``storage.compaction`` failpoint sits inside the
table lock immediately before the publish — a raise/kill there proves
the crash contract: the old manifest stays live, the half-built batches
are garbage-collected, and no reader ever observes a torn rewrite.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from snappydata_tpu_torch import config

# fallback reasons a rewrite pass can actually fix; "disabled",
# "decimal_exact", "join_key" etc. are structural and would only make
# the compactor spin
FOLDABLE_REASONS = frozenset(
    {"deltas", "row_buffer", "mixed_encoding", "rle_agg"})

def foldable_fallbacks(data) -> int:
    """This table's decode-first reroutes a compaction pass could fix."""
    from snappydata_tpu_torch.storage.device_decode import table_fallbacks

    return sum(n for r, n in table_fallbacks(data).items()
               if r in FOLDABLE_REASONS)


def _encoding_majority(views) -> Dict[int, str]:
    """Per-column majority encoding name across the table's batches —
    the convergence target for mixed-encoding rewrites."""
    tally: Dict[int, Dict[str, int]] = {}
    for v in views:
        for ci, col in enumerate(v.batch.columns):
            c = tally.setdefault(ci, {})
            c[col.encoding.name] = c.get(col.encoding.name, 0) + 1
    return {ci: max(c.items(), key=lambda kv: kv[1])[0]
            for ci, c in tally.items()}


def _select_views(data, views) -> Tuple[List[object], Dict[str, int]]:
    """Debris batches worth rewriting, plus the itemized skip tally for
    clean ones.  A view qualifies when it carries deltas or a delete
    mask (fold), when any column's encoding is in this table's minority
    (re-encode toward convergence), or when it is an undersized stub
    AND other candidates exist to merge with."""
    majority = _encoding_majority(views)
    selected: List[object] = []
    stubs: List[object] = []
    half = max(1, data.capacity // 2)
    for v in views:
        if v.deltas or v.delete_mask is not None:
            selected.append(v)
        elif any(col.encoding.name != majority[ci]
                 for ci, col in enumerate(v.batch.columns)):
            selected.append(v)
        elif v.batch.num_rows < half:
            stubs.append(v)
    # a lone stub with nothing to merge into stays put — rewriting it
    # alone reproduces the same undersized batch
    if selected or len(stubs) > 1:
        selected.extend(stubs)
        stubs = []
    return selected, ({"undersized_single": len(stubs)} if stubs else {})


def run_compaction_pass(data, force: bool = False) -> dict:
    """One synchronous rewrite pass over `data`.  Returns an itemized
    summary dict; every batch NOT rewritten is accounted under a
    compaction_skip_<reason> counter — the pass never declines silently.
    `force=True` bypasses the compaction_enabled knob (manual/test
    invocation)."""
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.reliability import failpoints
    from snappydata_tpu_torch.storage.device_decode import reset_table_fallbacks
    from snappydata_tpu_torch.storage.table_store import ColumnTableData

    reg = global_registry()
    out = {"rewritten": 0, "produced": 0, "reclaimed_bytes": 0,
           "skipped": {}}

    def skip(reason: str, n: int = 1) -> None:
        if n:
            reg.inc("compaction_skip_" + reason, n)
            out["skipped"][reason] = out["skipped"].get(reason, 0) + n

    if not isinstance(data, ColumnTableData):
        skip("row_table")
        return out
    if not force and not config.global_properties().compaction_enabled:
        skip("disabled")
        return out

    # row-buffer rows fall back per bind; roll them into batches first
    # so the rewrite below sees everything as views
    if data.snapshot().row_count:
        data.force_rollover()

    man = data.snapshot()
    if not man.views:
        skip("empty_table")
        return out
    selected, skips = _select_views(data, man.views)
    for r, n in skips.items():
        skip(r, n)
    if not selected:
        skip("clean")
        return out
    if data.__dict__.get("_compact_stable_version") == man.version:
        # this exact manifest is OUR OWN last output: re-encoding is
        # deterministic, so rewriting again can only reproduce it (a
        # full batch whose encoding genuinely sits in the minority
        # would otherwise churn every interval)
        skip("stable", len(selected))
        return out
    reg.inc("compaction_passes")

    # ---- rewrite phase: decode + re-encode OUTSIDE any lock ----------
    nfields = len(data.schema.fields)
    old_bytes = 0
    col_parts: List[List[np.ndarray]] = [[] for _ in range(nfields)]
    null_parts: List[List[Optional[np.ndarray]]] = [[] for _ in
                                                    range(nfields)]
    for v in selected:
        live = v.live_mask()
        old_bytes += sum(col.nbytes for col in v.batch.columns)
        for _ci, hit, values, vnulls in v.deltas:
            old_bytes += hit.nbytes + values.nbytes \
                + (vnulls.nbytes if vnulls is not None else 0)
        if v.delete_mask is not None:
            old_bytes += v.delete_mask.nbytes
        if not live.any():
            continue
        for ci in range(nfields):
            # device domain: string columns decode to their table-shared
            # dictionary CODES, which _cut_batch re-wraps verbatim —
            # codes stay globally comparable across the rewrite
            col_parts[ci].append(v.decoded_column(ci)[live])
            nm = v.null_mask(ci)
            null_parts[ci].append(nm[live] if nm is not None else None)

    total = sum(a.shape[0] for a in col_parts[0]) if col_parts[0] else 0
    new_views: List[object] = []
    new_bytes = 0
    if total:
        cols = [np.concatenate(parts) for parts in col_parts]
        nulls: List[Optional[np.ndarray]] = []
        for ci in range(nfields):
            if any(p is not None for p in null_parts[ci]):
                nulls.append(np.concatenate(
                    [p if p is not None else
                     np.zeros(a.shape[0], dtype=np.bool_)
                     for p, a in zip(null_parts[ci], col_parts[ci])]))
            else:
                nulls.append(None)
        pos = 0
        while pos < total:
            take = min(data.capacity, total - pos)
            sl = slice(pos, pos + take)
            arrays = [c[sl] for c in cols]
            nmasks = [m[sl] if m is not None else None for m in nulls]
            codes = {ci: np.ascontiguousarray(arrays[ci], dtype=np.int32)
                     for ci in data._dicts}
            new_views.append(data._cut_batch(arrays, nmasks,
                                             str_codes=codes))
            pos += take
        new_bytes = sum(col.nbytes for v in new_views
                        for col in v.batch.columns)

    # ---- publish phase: identity-checked swap under the table lock ---
    sel_ids = {id(v) for v in selected}
    # locklint: lock=storage.column_table (the gate above rejects row
    # tables; the pass body holds nothing else)
    with data._lock:
        # the crash seam: a raise/kill here (test_compact crash matrix)
        # must leave the OLD manifest live and the new batches
        # unreferenced
        failpoints.hit("storage.compaction")
        cur = list(data._manifest.views)
        live_sel = sum(1 for v in cur if id(v) in sel_ids)
        if live_sel != len(selected):
            # a concurrent update/delete replaced (dataclasses.replace)
            # or truncate dropped one of our source views: publishing
            # would resurrect pre-mutation rows.  Abort the whole pass;
            # the debris is still there for the next interval.  This
            # check is deliberately the LAST thing before the publish.
            skip("raced", len(selected))
            return out
        keep = [v for v in cur if id(v) not in sel_ids]
        # splice the rewrites where the first source batch sat, keeping
        # rough scan order for tiled passes
        at = min((i for i, v in enumerate(cur) if id(v) in sel_ids),
                 default=len(keep))
        at = min(at, len(keep))
        newman = data._publish(tuple(keep[:at]) + tuple(new_views)
                               + tuple(keep[at:]))
        data.__dict__["_compact_stable_version"] = newman.version

    reg.inc("compaction_batches_rewritten", len(selected))
    reg.inc("compaction_bytes_reclaimed", max(0, old_bytes - new_bytes))
    reset_table_fallbacks(data)
    out["rewritten"] = len(selected)
    out["produced"] = len(new_views)
    out["reclaimed_bytes"] = max(0, old_bytes - new_bytes)
    return out
