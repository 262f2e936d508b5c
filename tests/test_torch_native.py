"""The port's native string encoder (snappydata_tpu_torch/native, the C++
of csrc/fastingest.cpp built by g++ at first use) and its plain twin
(storage/strings.encode_plain) against the reference's
`fast_encode_strings`: codes, dictionaries and null masks equal on every
input, NaN and pd.NA cells as NULLs, values already in the lookup, and
two processes building the library at once."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from snappydata_tpu.native import fast_encode_strings as ref_encode
from snappydata_tpu_torch import native
from snappydata_tpu_torch.storage.strings import encode_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.default_rng(5)
    words = np.array(["air", "rail", "ship", "truck", "mail", "fob",
                      "reg air", ""], dtype=object)
    big = words[rng.integers(0, len(words), 20_000)]
    holes = big.copy()
    holes[rng.random(20_000) < 0.1] = None
    mixed = np.array(["a", np.nan, "b", pd.NA, None, "a", float("nan"),
                      "b", "c"], dtype=object)
    return {
        "plain": np.array(["N", "R", "A", "N", "N", "R"], dtype=object),
        "low_cardinality": big,
        "nulls": holes,
        "nan_and_na": mixed,
        "all_null": np.array([None, np.nan, pd.NA], dtype=object),
        "empty": np.array([], dtype=object),
        "unicode": np.array(["été", "東京", "été", "naïve"], dtype=object),
    }


def _encode(fn, values, lookup, store):
    codes, nulls = fn(np.array(values, dtype=object, copy=True), lookup,
                      store)
    return (codes.dtype, codes.tolist(),
            None if nulls is None else nulls.tolist(), list(store),
            dict(lookup))


@pytest.mark.parametrize("name", sorted(_inputs()))
@pytest.mark.parametrize("prefilled", [False, True])
def test_codes_dictionary_and_nulls_equal_the_references(name, prefilled):
    values = _inputs()[name]
    seed = ["ship", "b", "zzz"] if prefilled else []

    def state():
        return {v: i for i, v in enumerate(seed)}, list(seed)

    want = _encode(ref_encode, values, *state())
    assert native.native_available()
    assert _encode(native.fast_encode_strings, values, *state()) == want

    # the plain twin takes the missing markers as the encoder hands them
    lookup, store = state()
    vals = np.array(values, dtype=object, copy=True)
    vals[pd.isna(vals)] = None
    assert _encode(encode_plain, vals, lookup, store) == want


def test_successive_inserts_keep_earlier_codes():
    lookup, store = {}, []
    ref_lookup, ref_store = {}, []
    for part in np.array_split(_inputs()["nulls"], 7):
        got = native.fast_encode_strings(part, lookup, store)
        want = ref_encode(part, ref_lookup, ref_store)
        assert got[0].tolist() == want[0].tolist()
        assert (got[1] is None) == (want[1] is None)
    assert store == ref_store


def test_fallback_is_the_plain_encoder_and_is_counted(monkeypatch):
    values = _inputs()["nan_and_na"]
    want = _encode(ref_encode, values, {}, [])
    monkeypatch.setattr(native, "_load", lambda: None)
    native.reset_counters()
    assert _encode(native.fast_encode_strings, values, {}, []) == want
    assert native.counters()["native_fallbacks"] == 1


_BUILD = r"""
import sys
from snappydata_tpu_torch import native
native.SO = sys.argv[1]
assert native.native_available(), "no build"
codes, nulls = native.fast_encode_strings(
    __import__("numpy").array(["q", None, "q"], dtype=object), {}, [])
print("CODES", codes.tolist(), nulls.tolist())
"""


def test_two_processes_build_at_once(tmp_path):
    """Two interpreters build the library into the same fresh path at
    once: each compiles under a name of its own and moves it into place,
    so neither loads a half-written file."""
    so = str(tmp_path / os.path.basename(native.SO))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, so], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert "CODES [0, 0, 0] [False, True, False]" in out, out
    assert os.path.exists(so)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
