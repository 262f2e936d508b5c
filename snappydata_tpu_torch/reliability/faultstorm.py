"""Seeded fault-storm scheduler (port of snappydata_tpu/reliability/
faultstorm.py): drive a durable workload while the failpoint registry
(reliability/failpoints.py) injects one fault per round at a seam picked
by a seeded RNG, and ACCOUNT for every injection.  Each fired fault must
end in either

  * **recovered**: the operation (or a background worker) absorbed the
    fault and the answer stayed value-exact (tier quarantine + rebuild,
    prefetch worker restart, bounded EIO re-read, short-write spill
    abort), or
  * **typed_error**: the statement failed with a typed fault-domain
    error (IOError, TierQuarantinedError, WorkerKilled ...), after which
    crash recovery restores a state where every acked row is present
    and every present row carries the value inserted for its key.

Anything else (an untyped exception, a lost acked row, a duplicated key,
a value that does not match its key) lands in `unexpected` /
`value_mismatches` and fails the storm.

Rows verify themselves: key k always carries value k * 0.5, so a scan
proves "never a wrong row" from the aggregate alone (sum(v) == 0.5 *
sum(k)) and a full read proves it per row.

Corruption faults get a CONTROLLED phase: scans over tier memmaps bypass
the CRC by design (promotion is the verify point), so `tier.write`
corruption runs as demote -> promote (the CRC catches it, quarantine +
rebuild heals) -> value check, with no free-running scan between the
corrupting write and the promote.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Dict, List, Optional

from snappydata_tpu_torch.reliability import failpoints as rfail

_log = logging.getLogger("snappydata_tpu_torch.reliability.faultstorm")

# counters the storm reports as deltas (self-healing evidence)
_TIER_COUNTERS = ("tier_quarantined_files", "tier_rebuilds",
                  "tier_rebuild_failures", "tier_read_retries")
_PREFETCH_COUNTERS = ("prefetch_worker_deaths", "prefetch_worker_restarts")


def _typed(exc: BaseException) -> bool:
    """A fault-domain error the storm accepts: retryable per the
    reliability contract, or one of the typed injection / quarantine
    families (OSError covers InjectedFault, WAL poisoning and EIO)."""
    from snappydata_tpu_torch import reliability
    from snappydata_tpu_torch.storage import tier

    if reliability.is_retryable(exc):
        return True
    return isinstance(exc, (OSError, tier.TierQuarantinedError,
                            rfail.WorkerKilled))


class _Storm:
    """One storm run over a single durable session."""

    def __init__(self, data_dir: str, seed: int, device=None):
        self.dir = data_dir
        self.seed = seed
        self.device = device
        self.rng = random.Random(seed)
        self.present: Dict[int, float] = {}   # acked key -> value
        self.attempted: Dict[int, float] = {} # every key ever sent
        self.next_k = 0
        self.value_mismatches = 0
        self.unexpected: List[str] = []
        self.crash_recoveries = 0
        self.injected = 0
        self.recovered = 0
        self.typed_errors = 0
        self.scan_ms: List[float] = []    # verify-scan latencies
        self.session = self._open(recover=False)

    # -- session lifecycle ------------------------------------------------

    def _open(self, recover: bool):
        from snappydata_tpu_torch import SnappySession
        from snappydata_tpu_torch.catalog import Catalog

        if recover:
            return SnappySession(data_dir=self.dir, recover=True,
                                 device=self.device)
        s = SnappySession(catalog=Catalog(), data_dir=self.dir,
                          recover=False, device=self.device)
        s.sql("CREATE TABLE storm (k BIGINT, v DOUBLE) USING column")
        return s

    @property
    def data(self):
        return self.session.catalog.describe("storm").data

    def crash_and_recover(self) -> None:
        """Treat the failed statement as a crash: reopen from disk, then
        re-derive the authoritative key set from the recovered table —
        every acked key must survive, every present row must carry the
        value its key implies, and no key may appear twice."""
        self.crash_recoveries += 1
        try:
            self.session.disk_store.close()
        except Exception:
            pass
        self.session = self._open(recover=True)
        rows = self.session.sql("SELECT k, v FROM storm").rows()
        got: Dict[int, float] = {}
        for k, v in rows:
            k = int(k)
            if k in got:
                self.value_mismatches += 1
                self.unexpected.append(f"duplicated key {k} after recovery")
            got[k] = float(v)
        lost = set(self.present) - set(got)
        if lost:
            self.value_mismatches += len(lost)
            self.unexpected.append(
                f"{len(lost)} acked keys lost across recovery "
                f"(e.g. {sorted(lost)[:5]})")
        for k, v in got.items():
            if k not in self.attempted:
                self.value_mismatches += 1
                self.unexpected.append(f"phantom key {k} after recovery")
            elif abs(v - k * 0.5) > 1e-9:
                self.value_mismatches += 1
                self.unexpected.append(
                    f"wrong value for key {k}: {v} != {k * 0.5}")
        # unacked rows that made it to the WAL before the fault are
        # legitimate survivors — adopt the recovered state as acked
        self.present = got

    # -- workload ops (each is one storm round's victim) ------------------

    def op_insert(self) -> None:
        n = self.rng.randint(8, 64)
        k0, self.next_k = self.next_k, self.next_k + n
        rows = [(k0 + i, (k0 + i) * 0.5) for i in range(n)]
        for k, v in rows:
            self.attempted[k] = v
        self.session.insert("storm", *rows)
        for k, v in rows:
            self.present[k] = v

    def op_scan(self) -> None:
        self.verify_scan()

    def op_checkpoint(self) -> None:
        self.session.checkpoint()

    def op_spill(self) -> None:
        """Demote everything down the ladder (host pool -> disk tier)."""
        from snappydata_tpu_torch.storage import tier

        tier.demote([("storm", self.data)], 1 << 40)

    def op_promote(self) -> None:
        from snappydata_tpu_torch.storage import tier

        tier.promote_table(self.data)

    def op_crashrec(self) -> None:
        """A deliberate kill→rejoin (exercises wal.salvage faults)."""
        self.crash_and_recover()

    def op_compact(self) -> None:
        """Manufacture mutation debris (an UPDATE delta + a DELETE mask
        on committed batches), then force a synchronous compaction pass.
        With `storage.compaction` armed the pass dies at the publish
        seam INSIDE the table lock — the crash contract says the old
        manifest stays live, the half-built batches stay unreferenced,
        and the post-round verify_scan still proves every row carries
        its key-implied value."""
        from snappydata_tpu_torch.storage import compact

        ks = sorted(self.present)
        if len(ks) >= 4:
            ka, kd = ks[0], ks[1]
            # same-value UPDATE: leaves a fold-worthy delta without
            # disturbing the k -> k*0.5 self-verification invariant
            self.session.sql(
                f"UPDATE storm SET v = {ka * 0.5} WHERE k = {ka}")
            # un-ack BEFORE the DELETE: if anything dies between here
            # and durability, recovery legitimately adopts either state
            del self.present[kd]
            self.session.sql(f"DELETE FROM storm WHERE k = {kd}")
        compact.run_compaction_pass(self.data, force=True)

    def op_corrupt_heal(self) -> None:
        """Controlled corruption phase: checkpoint (a rebuild source on
        disk), demote THROUGH the armed corrupt_bytes fault, then
        promote — the CRC catches the damage and the quarantine +
        rebuild path must heal it without a wrong row."""
        from snappydata_tpu_torch.storage import tier

        try:
            self.session.checkpoint()
        except Exception:
            pass  # retained epochs still serve as the rebuild source
        tier.demote([("storm", self.data)], 1 << 40)
        rfail.disarm("tier.write")          # damage is on disk now
        tier.promote_table(self.data)       # CRC verify -> heal

    # -- verification -----------------------------------------------------

    def verify_scan(self) -> None:
        t0 = time.perf_counter()
        got = self.session.sql(
            "SELECT count(*), sum(v), sum(k) FROM storm").rows()[0]
        self.scan_ms.append((time.perf_counter() - t0) * 1e3)
        cnt = int(got[0])
        sv = float(got[1]) if got[1] is not None else 0.0
        sk = float(got[2]) if got[2] is not None else 0.0
        want_cnt = len(self.present)
        want_sv = sum(self.present.values())
        if cnt != want_cnt:
            self.value_mismatches += 1
            self.unexpected.append(
                f"scan count {cnt} != acked {want_cnt}")
        if abs(sv - want_sv) > 1e-6 * max(1.0, abs(want_sv)):
            self.value_mismatches += 1
            self.unexpected.append(f"scan sum(v) {sv} != {want_sv}")
        # self-verifying rows: sum(v) must equal 0.5 * sum(k) no matter
        # what the commit log says — a wrong ROW cannot hide here
        if abs(sv - 0.5 * sk) > 1e-6 * max(1.0, abs(sv)):
            self.value_mismatches += 1
            self.unexpected.append(
                f"rows not self-consistent: sum(v)={sv} vs "
                f"0.5*sum(k)={0.5 * sk}")


# one storm round = (failpoint, action, param, op attr). `count=1`
# everywhere: each round injects at most one fault, so the accounting
# maps 1:1 from fired counts to outcomes.
_MENU = (
    ("wal.append", "raise", 0, "op_insert"),
    ("wal.append", "sleep", 3, "op_insert"),
    ("wal.fsync", "return_errno", 0, "op_insert"),
    ("checkpoint.write", "raise", 0, "op_checkpoint"),
    ("checkpoint.publish", "raise", 0, "op_checkpoint"),
    ("wal.salvage", "sleep", 2, "op_crashrec"),
    ("tier.demote", "raise", 0, "op_spill"),
    ("tier.write", "short_write", 64, "op_spill"),
    ("tier.write", "corrupt_bytes", 4, "op_corrupt_heal"),
    ("tier.memmap_read", "return_errno", 0, "op_promote"),
    ("tier.promote", "sleep", 2, "op_promote"),
    ("prefetch.worker", "kill_worker", 0, "op_scan"),
    ("broker.admit", "raise", 0, "op_scan"),
    ("storage.compaction", "raise", 0, "op_compact"),
    ("storage.compaction", "kill_worker", 0, "op_compact"),
)


def run_storm(data_dir: str, seed: int = 1717, rounds: int = 26,
              device=None) -> dict:
    """Run `rounds` seeded fault rounds against a durable session and
    return the full accounting.  Tier budgets are pinched far below the
    working set, so the demotion ladder and the tile prefetcher are live
    targets, not dead code.  `device` is the sessions' torch device
    (`cuda` unless the caller asks for the CPU).  (The reference's
    `constrict` and `inject` switches serve its bench's clean baseline;
    the port has no bench.)"""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import global_registry

    props = config.global_properties()
    saved = (props.column_batch_rows, props.column_max_delta_rows,
             props.scan_tile_bytes, props.device_cache_bytes,
             props.tier_device_bytes, props.tier_host_bytes,
             props.tier_prefetch_depth)
    props.column_batch_rows = 128
    props.column_max_delta_rows = 128
    props.scan_tile_bytes = 2 * 128 * 32
    props.device_cache_bytes = 64 * 1024
    props.tier_device_bytes = 32 * 1024
    props.tier_host_bytes = 48 * 1024
    props.tier_prefetch_depth = 2
    reg = global_registry()
    c0 = reg.counters_snapshot()
    rfail.clear()
    rfail.reseed(seed)
    st = _Storm(data_dir, seed, device)

    def _fires() -> int:
        # the persistent ledger: disarm() drops a spec (and its fired
        # count), but every fired action bumped this counter
        return reg.counter("fault_injected")

    try:
        # seed enough rows that the table spans many batches
        for _ in range(6):
            st.op_insert()
        st.verify_scan()
        for rnd in range(rounds):
            point, action, param, opname = \
                _MENU[st.rng.randrange(len(_MENU))]
            fired0 = _fires()
            rfail.arm(point, action, param=param, count=1)
            ok, typed, err = True, False, None
            try:
                getattr(st, opname)()
            except Exception as e:         # noqa: BLE001 — classified below
                ok, typed, err = False, _typed(e), e
            finally:
                rfail.disarm(point)
            fired = _fires() - fired0
            st.injected += fired
            if not ok:
                # ANY failed op is treated as a crash: recovery must
                # land on a state with no lost ack and no wrong row
                st.crash_and_recover()
            if fired:
                if ok:
                    st.recovered += fired
                elif typed:
                    st.typed_errors += fired
                else:
                    st.unexpected.append(
                        f"round {rnd}: {point}={action} raised untyped "
                        f"{type(err).__name__}: {err}")
            elif not ok:
                # fault never fired, yet the op failed — that is a bug
                # regardless of typing
                st.unexpected.append(
                    f"round {rnd}: {opname} failed without a fault: "
                    f"{type(err).__name__}: {err}")
            st.verify_scan()
        rfail.clear()
        # final crash-recovery sweep: the storm's end state must survive
        # a cold reopen bit-for-bit
        st.crash_and_recover()
        st.verify_scan()
    finally:
        rfail.clear()
        try:
            st.session.disk_store.close()
        except Exception:
            pass
        (props.column_batch_rows, props.column_max_delta_rows,
         props.scan_tile_bytes, props.device_cache_bytes,
         props.tier_device_bytes, props.tier_host_bytes,
         props.tier_prefetch_depth) = saved
    c1 = reg.counters_snapshot()

    def delta(key: str) -> int:
        return c1.get(key, 0) - c0.get(key, 0)

    import numpy as _np

    lat = _np.asarray(st.scan_ms) if st.scan_ms else _np.zeros(1)
    accounted = st.recovered + st.typed_errors
    return {
        "seed": seed,
        "rounds": rounds,
        "injected": st.injected,
        "recovered": st.recovered,
        "typed_errors": st.typed_errors,
        "accounted": accounted,
        "recovery_ratio": round(accounted / st.injected, 4)
        if st.injected else 1.0,
        "value_mismatches": st.value_mismatches,
        "unexpected": st.unexpected,
        "crash_recoveries": st.crash_recoveries,
        "rows_final": len(st.present),
        # availability trajectory of the value-asserting scans THROUGH
        # the storm
        "scans": len(st.scan_ms),
        "scan_p50_ms": round(float(_np.percentile(lat, 50)), 2),
        "scan_p99_ms": round(float(_np.percentile(lat, 99)), 2),
        "scans_per_s": round(len(st.scan_ms) /
                             max(1e-9, float(lat.sum()) / 1e3), 1),
        "fired_by_point": {
            p: d for p in sorted({m[0] for m in _MENU})
            for d in (delta(f"fault_injected_{p.replace('.', '_')}"),)
            if d},
        "tier": {k: delta(k) for k in _TIER_COUNTERS},
        "prefetch": {k: delta(k) for k in _PREFETCH_COUNTERS},
    }
