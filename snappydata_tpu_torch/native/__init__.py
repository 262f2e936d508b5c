"""The native string-intern encoder of column ingest, built at first use.

`csrc/fastingest.cpp` (a CPython extension: one fused pass that interns an
object array of strings into the table's dictionary and emits int32 codes
and the null mask) compiles with the system g++ into
`build/_fastingest-np<numpy version><extension suffix>` the first time a
process asks for it (the name keys the library to the interpreter and the
numpy it was built against).
The library is written under a temporary name and moved into place, so
processes building at once never load half a file.  Without a compiler
`fast_encode_strings` takes the encoder's plain version, the vectorized
pandas path of `storage/strings.py`, and counts each such call in
`counters()["native_fallbacks"]`.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
from typing import Dict, Optional, Tuple

import numpy as np

from snappydata_tpu_torch.utils import locks

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "fastingest.cpp")
BUILD = os.path.join(_PKG, "build")
SO = os.path.join(BUILD, f"_fastingest-np{np.__version__}"
                         f"{sysconfig.get_config_var('EXT_SUFFIX')}")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = locks.named_lock("native.loader")
_native = None
_tried = False
_counters: Dict[str, int] = {"native_fallbacks": 0}


def _command(out: str):
    return [os.environ.get("CXX", "g++"), *GXX_FLAGS,
            f"-I{sysconfig.get_paths()['include']}",
            f"-I{np.get_include()}", SRC, "-o", out]


def _build() -> Optional[str]:
    """The built library's path (compiled now when missing or older than
    the source), or None when the compiler is absent or fails."""
    if os.path.exists(SO) and os.path.getmtime(SO) >= os.path.getmtime(SRC):
        return SO
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(_command(tmp), check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, SO)
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return SO


def _load():
    global _native, _tried
    with _lock:
        if _tried:
            return _native
        _tried = True
        so_path = _build()
        if so_path is None:
            return None
        try:
            spec = importlib.util.spec_from_file_location("_fastingest",
                                                          so_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _native = mod
        except (ImportError, OSError):
            _native = None
        return _native


def native_available() -> bool:
    return _load() is not None


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters() -> None:
    for k in _counters:
        _counters[k] = 0


def fast_encode_strings(values: np.ndarray, lookup: dict, store: list
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One pass: intern `values` into (lookup, store) and return
    (int32 codes, null mask | None)."""
    import pandas as pd

    values = np.ascontiguousarray(np.asarray(values, dtype=object))
    # pandas-style missing markers (float NaN, pd.NA) are SQL NULLs: the
    # C pass would otherwise mint one dictionary entry per NaN object
    na = pd.isna(values)
    if na.any():
        values = values.copy()
        values[na] = None
    mod = _load()
    if mod is not None:
        return mod.encode_strings(values, lookup, store)
    from snappydata_tpu_torch.storage.strings import encode_plain

    _counters["native_fallbacks"] += 1
    return encode_plain(values, lookup, store)
