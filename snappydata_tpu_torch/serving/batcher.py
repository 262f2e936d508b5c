"""Adaptive micro-batcher: coalesce concurrent executes of one prepared
plan into a single fused device dispatch.

Port of snappydata_tpu/serving/batcher.py.  The reference fuses a batch
into one `jax.vmap` dispatch; here the relations bind once, each request
runs on that bind, and the batch comes home in one device-to-host copy
(engine/executor.CompiledPlan.execute_batched).

Inference-server shape ("Global Hash Tables Strike Back!" frames why
concurrent small aggregates should share one device pass instead of
contending): the first request on an idle plan becomes the LEADER; if it
is alone it waits up to `serving_batch_wait_us` for batchmates, then
dispatches.  While a dispatch is in flight, new arrivals queue with NO
added wait — they fuse into the next leader's batch, so under load the
batcher adds zero artificial latency and occupancy rises naturally.

Correctness inside a fused batch:
- every request keeps its own governor context — a request cancelled (or
  timed out) before dispatch is dropped from the batch and raises its
  own CancelException; its batchmates are untouched;
- requests with incompatible bind signatures (different param dtypes,
  or sessions on different devices) never fuse, so the leader serves its
  batchmates on its own thread inside one device scope;
- only the live requests run; the reference's {2^k, 1.5*2^k} padding
  bucket survives as the size half of the `serving_vmap_compiles` key;
- any fused-dispatch failure (ragged aux shapes, a bind-check failure,
  per-request overflow) falls back to per-request engine execution — the
  batch path can only ever be an optimization, never an answer change.
"""

from __future__ import annotations

import threading
from snappydata_tpu_torch.utils import locks
import time
from typing import List, Optional, Sequence

import numpy as np

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability import tracing
from snappydata_tpu_torch.observability.metrics import global_registry


# how recently another request must have overlapped this plan's queue
# for a LONE leader to open the coalescing window.  Wide enough that a
# steady minority stream (e.g. the 30%-aggregate share of a mixed
# serving load) keeps coalescing between bursts; a truly single-stream
# caller still never waits (first request sees a cold signal).
_CONCURRENCY_HORIZON_S = 0.05


def bucket_ladder(bmax: int) -> List[int]:
    """{2^k, 1.5*2^k} padded batch sizes up to bmax (same ladder as
    storage.device.batch_bucket)."""
    out = [1]
    k = 1
    while out[-1] < bmax:
        for cand in (1 << k, (1 << k) + (1 << (k - 1))):
            if cand <= bmax and cand > out[-1]:
                out.append(cand)
        k += 1
    if out[-1] != bmax:
        out.append(bmax)
    return out


def _pad_bucket(n: int, bmax: int) -> int:
    for b in bucket_ladder(bmax):
        if b >= n:
            return b
    return bmax


def _bind_signature(params, device) -> tuple:
    """The dtype each bind uploads as, plus the session's device."""
    from snappydata_tpu_torch.engine.executor import _param_dtype

    return tuple(str(_param_dtype(v)) for v in params) + (str(device),)


class _Request:
    __slots__ = ("params", "ctx", "session", "sig", "done", "result",
                 "error", "trace", "span")

    def __init__(self, session, params, ctx):
        self.session = session
        self.params = params
        self.ctx = ctx
        self.sig = _bind_signature(params, session.device)
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None
        # the submitter's trace: a leader that re-executes this request
        # records its spans there, never under the leader's own trace
        self.trace = tracing.current()
        self.span = tracing.current_span()


class BatchQueue:
    """Per-PreparedPlan queue + leader election state."""

    def __init__(self):
        self.cond = locks.named_condition("serving.batcher_cond")
        self.waiting: List[_Request] = []
        self.leader: Optional[_Request] = None
        # adaptive coalescing signal: last time a request arrived while
        # another was queued/dispatching — a lone leader only opens the
        # serving_batch_wait_us window when concurrency was seen within
        # _CONCURRENCY_HORIZON_S, so a single-stream caller pays ZERO
        # added latency
        self.saw_concurrency = float("-inf")


class MicroBatcher:
    def submit(self, entry, session, params, ctx):
        """Execute `entry` with `params`, fusing with concurrent
        submissions when possible.  Blocks until this request's result
        (or error) is ready."""
        q = entry.batch_queue
        if q is None:
            # locklint: lock=serving.plan (entry is a PreparedPlan)
            with entry._lock:
                if entry.batch_queue is None:
                    entry.batch_queue = BatchQueue()
                q = entry.batch_queue
        req = _Request(session, params, ctx)
        with q.cond:
            if q.waiting or q.leader is not None:
                q.saw_concurrency = time.monotonic()
            q.waiting.append(req)
            q.cond.notify_all()
            while True:
                if req.done:
                    break
                if q.leader is None:
                    q.leader = req
                    break
                q.cond.wait()
        if not req.done:      # we are the leader
            try:
                self._lead(entry, q, req)
            finally:
                with q.cond:
                    q.leader = None
                    q.cond.notify_all()
        if req.error is not None:
            raise req.error
        return req.result

    # -- leader ---------------------------------------------------------

    def _lead(self, entry, q: BatchQueue, leader: _Request) -> None:
        props = config.global_properties()
        bmax = max(1, int(props.serving_batch_max or 1))
        wait_s = max(0.0, float(props.serving_batch_wait_us or 0.0)) / 1e6
        with q.cond:
            mine = [r for r in q.waiting if r.sig == leader.sig]
            if len(mine) < bmax and wait_s > 0 and bmax > 1 and \
                    time.monotonic() - q.saw_concurrency \
                    < _CONCURRENCY_HORIZON_S:
                # partial batch and concurrency was seen in the last few
                # ms: open the coalescing window to top up toward
                # serving_batch_max; batchmates arriving mid-window
                # notify and fuse.  (A single-stream caller never enters
                # here — straight through, no added wait.)
                deadline = time.monotonic() + wait_s
                while True:
                    mine = [r for r in q.waiting if r.sig == leader.sig]
                    if len(mine) >= bmax:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    q.cond.wait(remaining)
            # the leader MUST ride its own batch: with more than bmax
            # compatible waiters, a plain prefix could omit it — its
            # submit() would then return with neither result nor error
            mine.remove(leader)
            batch = [leader] + mine[:bmax - 1]
            for r in batch:
                q.waiting.remove(r)
        try:
            self._dispatch(entry, batch)
        finally:
            with q.cond:
                for r in batch:
                    r.done = True
                q.cond.notify_all()

    def _dispatch(self, entry, batch: List[_Request]) -> None:
        reg = global_registry()
        # per-request cancellation/timeout gate: a dead request must not
        # ride (or poison) the fused dispatch
        live: List[_Request] = []
        for r in batch:
            try:
                if r.ctx is not None:
                    r.ctx.check()
                live.append(r)
            except BaseException as e:     # noqa: BLE001 — delivered as-is
                r.error = e
        if not live:
            return
        if len(live) == 1:
            reg.inc("serving_straight_through")
            self._solo(entry, live[0])
            return
        session = live[0].session
        bmax = max(len(live),
                   int(config.global_properties().serving_batch_max or 1))
        bucket = _pad_bucket(len(live), bmax)
        try:
            tables, outs = entry.compiled_for(session).execute_batched(
                [r.params for r in live], session.device, bucket=bucket)
            results = [entry.assemble_batched(r.session, outs, tables, i,
                                              r.params)
                       for i, r in enumerate(live)]
        except BaseException:              # noqa: BLE001
            # ragged aux, a bind-check failure, OOM — anything: the batch
            # path must never change answers, so every request
            # re-executes through the normal engine path
            reg.inc("serving_batch_fallbacks")
            for r in live:
                self._solo(entry, r)
            return
        reg.inc("serving_batched_dispatches")
        reg.inc("serving_batch_requests", len(live))
        for r, res in zip(live, results):
            if res is None:     # this lane overflowed its static bounds
                self._solo(entry, r)  # executor.execute counts it
            else:
                r.result = res
                # engine counters for fused lanes (solo reroutes count
                # inside executor.execute — don't double-count them)
                reg.inc("queries")
                reg.inc("rows_returned", res.num_rows)

    @staticmethod
    def _solo(entry, r: _Request) -> None:
        # runs in the LEADER's thread: scope the request's OWN governor
        # context so cooperative checks see r's cancellation/deadline,
        # not the leader's — a leader timing out mid-fallback must not
        # poison the batchmate it is re-executing (and vice versa).  Its
        # spans go to r's own trace (none when r was untraced)
        from snappydata_tpu_torch.resource.context import query_scope

        try:
            with tracing.attach_or_detach(r.trace, r.span):
                if r.ctx is not None:
                    with query_scope(r.ctx):
                        r.result = r.session.executor.execute(
                            entry.tokenized, r.params,
                            plan_key=entry.core_key)
                else:
                    r.result = r.session.executor.execute(
                        entry.tokenized, r.params, plan_key=entry.core_key)
        except BaseException as e:         # noqa: BLE001
            r.error = e


_BATCHER = MicroBatcher()


def global_batcher() -> MicroBatcher:
    return _BATCHER
