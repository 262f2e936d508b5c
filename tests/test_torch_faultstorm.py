"""The port's seeded fault-storm scheduler (snappydata_tpu_torch/
reliability/faultstorm.py), case by case the reference's
tests/test_faultstorm.py on the CPU: every fault the storm injects across
the WAL / checkpoint / tier / prefetch / admission / compaction seams is
accounted as recovered in place or as a typed error followed by verified
crash recovery, never a wrong row and never an untyped failure.  The
reference's bench-guard case checks its bench.py and has no port
counterpart (the port has no benchmark).  Parity: the same seeded storm
runs through both packages and both account every injection, with the
same schedule of seams fired.
"""

import pytest

from snappydata_tpu.reliability import failpoints as ref_rfail
from snappydata_tpu.reliability import faultstorm as ref_faultstorm

from snappydata_tpu_torch import config
from snappydata_tpu_torch.reliability import failpoints as rfail, faultstorm

pytestmark = [pytest.mark.faults, pytest.mark.chaos]


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' properties at their defaults for the storm (an
    earlier test in the same process may have left a knob such as the
    WAL's fsync mode elsewhere, and the seams a storm reaches depend on
    them), with the background compactors off (the storm runs its own
    compaction rounds), and clear failpoint registries.  Durable stores
    that earlier tests of the process left behind are dropped from both
    packages' quarantine-rebuild registries (`storage/tier._STORES`)
    after a collection: a storm heals a tier file from its own store,
    and the reference's rebuild walks every attached store, so a
    leftover store holding another `storm` table could graft that
    table's batch (ROADMAP C4 / C5).  Tables that earlier tests keep
    alive leave both brokers' ledgers for the storm and come back after
    it: the tier ladder's steady-state pass walks every ledgered table
    against the storm's 48 KiB host cap, so a live leftover (the
    reference's `tests/test_flightsql.py` keeps its 5,000-row `fs_t`)
    moved the reference's demotions and changed which seams fired."""
    import dataclasses
    import gc

    from snappydata_tpu import config as ref_config
    from snappydata_tpu.resource.broker import global_broker as ref_broker
    from snappydata_tpu.storage import tier as ref_tier

    from snappydata_tpu_torch.resource.broker import global_broker
    from snappydata_tpu_torch.storage import tier

    gc.collect()
    for stores in (tier._STORES, ref_tier._STORES):
        stores.clear()
    brokers = (global_broker(), ref_broker())
    ledgered = []
    for b in brokers:
        with b._tables_lock:
            ledgered.append(dict(b._tables))
            b._tables.clear()

    props = (config.global_properties(), ref_config.global_properties())
    saved = [dataclasses.replace(p) for p in props]
    for p in props:
        fresh = type(p)()
        for f in dataclasses.fields(p):
            setattr(p, f.name, getattr(fresh, f.name))
        p.compaction_enabled = False
    rfail.clear()
    ref_rfail.clear()
    yield
    rfail.clear()
    ref_rfail.clear()
    for p, old in zip(props, saved):
        for f in dataclasses.fields(p):
            setattr(p, f.name, getattr(old, f.name))
    for b, tables in zip(brokers, ledgered):
        with b._tables_lock:
            for key, ref in tables.items():
                b._tables.setdefault(key, ref)


def test_storm_fully_accounted(tmp_path):
    res = faultstorm.run_storm(str(tmp_path), seed=1717, rounds=14,
                               device="cpu")
    assert res["injected"] > 0, "a 14-round storm must land some faults"
    assert res["value_mismatches"] == 0, res["unexpected"]
    assert res["unexpected"] == []
    assert res["accounted"] == res["injected"], res
    assert res["recovery_ratio"] == 1.0
    assert res["rows_final"] > 0
    assert res["tier"]["tier_rebuild_failures"] == 0
    assert res["tier"]["tier_quarantined_files"] == \
        res["tier"]["tier_rebuilds"]


def test_storm_is_seed_deterministic(tmp_path):
    a = faultstorm.run_storm(str(tmp_path / "a"), seed=31, rounds=8,
                             device="cpu")
    b = faultstorm.run_storm(str(tmp_path / "b"), seed=31, rounds=8,
                             device="cpu")
    for key in ("injected", "recovered", "typed_errors",
                "crash_recoveries", "rows_final", "fired_by_point"):
        assert a[key] == b[key], (key, a[key], b[key])


@pytest.mark.parametrize("seed", [1717, 26])
def test_same_storm_accounted_in_both_packages(tmp_path, seed):
    """One seeded schedule through both packages: each accounts every
    injection with no wrong row, and the same seams fire."""
    port = faultstorm.run_storm(str(tmp_path / "port"), seed=seed,
                                rounds=14, device="cpu")
    ref = ref_faultstorm.run_storm(str(tmp_path / "ref"), seed=seed,
                                   rounds=14)
    for res in (port, ref):
        assert res["value_mismatches"] == 0, res["unexpected"]
        assert res["unexpected"] == []
        assert res["recovery_ratio"] == 1.0
    assert sorted(port["fired_by_point"]) == sorted(ref["fired_by_point"]), \
        (port, ref)
    assert port["injected"] == ref["injected"], (port, ref)
    assert port["rows_final"] == ref["rows_final"], (port, ref)
