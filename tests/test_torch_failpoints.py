"""Failpoint arming from a spec string in the port's one registry
(reliability/failpoints.py): the spec-grammar cases of
tests/test_failpoints.py (the SNAPPY_TPU_FAULTS grammar and its JSON
form) and of tests/test_reliability_failpoints.py (the SNAPPY_FAILPOINTS
grammar), each parsed by both packages into the same specs, then arming
from the environment and from the `faults` property, and the triggers
and actions the first grammar brings (every-Nth, phase, latency, drop)."""

import os
import subprocess
import sys

import pytest

from snappydata_tpu import fault as ref_fault
from snappydata_tpu.reliability import failpoints as ref_rfail
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.reliability import failpoints as fp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    fp.clear()
    fp.reseed(1234)
    ref_fault.clear()
    ref_rfail.clear()
    yield
    fp.clear()
    ref_fault.clear()
    ref_rfail.clear()


FAULT_SPEC = ("wal.append=torn_write:7@1;"
              "flight.rpc=latency:0.01@p0.25;"
              "locator.heartbeat=raise@e3!conn;"
              "flight.rpc=drop@2#after")


def test_compact_spec_grammar():
    port = fp.arm_from_spec(FAULT_SPEC)
    ref = ref_fault.registry().arm_from_spec(FAULT_SPEC)
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        assert (p.name, p.action, p.param, p.exc, p.count, p.every,
                p.prob, p.phase) == \
            (r.name, r.action, r.param, r.exc, r.count, r.every, r.p,
             r.phase)
    by = {}
    for s in port:
        by.setdefault(s.name, []).append(s)
    tw = by["wal.append"][0]
    assert (tw.action, tw.param, tw.count) == ("torn_write", 7.0, 1)
    lat = by["flight.rpc"][0]
    assert (lat.action, lat.prob) == ("latency", 0.25)
    hb = by["locator.heartbeat"][0]
    assert (hb.action, hb.every, hb.exc) == ("raise", 3, "conn")
    drop = by["flight.rpc"][1]
    assert (drop.action, drop.count, drop.phase) == ("drop", 2, "after")


def test_json_spec():
    text = '[{"name": "a.b", "action": "raise", "count": 1}]'
    specs = fp.arm_from_spec(text)
    ref = ref_fault.registry().arm_from_spec(text)
    assert specs[0].name == ref[0].name == "a.b"
    assert specs[0].count == ref[0].count == 1
    one = fp.arm_from_spec('{"name": "c.d", "action": "latency", '
                           '"param": 0.5, "p": 0.5}')
    assert (one[0].action, one[0].param, one[0].prob) == \
        ("latency", 0.5, 0.5)


def test_reliability_spec_grammar():
    text = ("wal.append=raise:3;tier.write=corrupt_bytes(8):0.5;"
            "checkpoint.publish=sleep(12)")
    port = fp.arm_from_spec(text)
    ref = ref_rfail.arm_from_spec(text)
    assert [(s.name, s.action, s.param, s.count, s.prob) for s in port] \
        == [(s.name, s.action, s.param, s.count, s.prob) for s in ref]
    by_name = {s.name: s for s in port}
    assert by_name["wal.append"].count == 3
    assert by_name["tier.write"].param == 8
    assert by_name["tier.write"].prob == 0.5
    assert by_name["checkpoint.publish"].param == 12


def test_bad_entries_rejected():
    with pytest.raises(ValueError, match="bad failpoint entry"):
        fp.arm_from_spec("noequals")
    with pytest.raises(ValueError, match="unknown failpoint action"):
        fp.arm_from_spec("x=explode")
    with pytest.raises(ValueError, match="unknown exc family"):
        fp.arm_from_spec("x=raise@1!nope")
    with pytest.raises(ValueError, match="phase"):
        fp.arm("x", "raise", phase="during")
    with pytest.raises(ValueError, match="torn_write"):
        fp.arm_from_spec("x=torn_write:3@1#after")


def test_env_arming(monkeypatch):
    monkeypatch.setenv("SNAPPY_FAILPOINTS", "flight.send=raise:1")
    monkeypatch.setenv("SNAPPY_TPU_FAULTS", "wal.x=torn_write:5")
    fp._arm_env()
    with pytest.raises(fp.InjectedFault):
        fp.hit("flight.send")
    fp.hit("flight.send")         # single-shot
    # the second grammar reads ":5" as the torn write's bytes
    spec = fp.hit("wal.x")
    assert spec is not None and spec.param == 5.0


def test_config_arming(monkeypatch):
    """The `faults` property is read by the boot-time arming (the same
    grammar as SNAPPY_TPU_FAULTS)."""
    from snappydata_tpu_torch import config

    monkeypatch.delenv("SNAPPY_FAILPOINTS", raising=False)
    monkeypatch.delenv("SNAPPY_TPU_FAULTS", raising=False)
    monkeypatch.setattr(config.global_properties(), "faults",
                        "tier.write=raise@2!timeout")
    fp._arm_env()
    s = fp.snapshot()
    assert len(s) == 1 and s[0]["name"] == "tier.write", s
    assert s[0]["count"] == 2 and s[0]["exc"] == "timeout", s
    with pytest.raises(TimeoutError):
        fp.hit("tier.write")


def test_seed_from_the_environment_at_import():
    code = ("import random\n"
            "from snappydata_tpu_torch.reliability import failpoints as fp\n"
            "print(fp._RNG.random() == random.Random(77).random())\n")
    env = dict(os.environ)
    for var in ("SNAPPY_FAILPOINTS", "SNAPPY_TPU_FAULTS",
                "SNAPPY_FAILPOINT_SEED"):
        env.pop(var, None)
    env["SNAPPY_TPU_FAULT_SEED"] = "77"
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"]


def test_every_nth_phase_latency_and_drop():
    fp.arm("p.e", "raise", every=3)
    fired = 0
    for _ in range(9):
        try:
            fp.hit("p.e")
        except fp.InjectedFault:
            fired += 1
    assert fired == 3
    fp.arm("p.a", "raise", phase="after", count=1)
    assert fp.hit("p.a") is None            # the before side: nothing
    with pytest.raises(fp.InjectedFault):
        fp.hit("p.a", phase="after")
    fp.arm("p.d", "drop", count=1)
    with pytest.raises(ConnectionError):
        fp.hit("p.d")
    fp.arm("p.c", "raise", exc="conn", count=1)
    with pytest.raises(fp.FaultConnectionDropped):
        fp.hit("p.c")
    fp.arm("p.l", "latency", param=0.001, count=1)
    assert fp.hit("p.l") is None
    c0 = global_registry().counter("fault_injected")
    fp.arm("p.m", "raise", count=1)
    with pytest.raises(fp.InjectedFault):
        fp.hit("p.m")
    assert global_registry().counter("fault_injected") == c0 + 1
    armed = {s["name"]: s for s in fp.snapshot()}
    assert armed["p.e"]["every"] == 3 and armed["p.e"]["fired"] == 3
    assert armed["p.a"]["phase"] == "after"
