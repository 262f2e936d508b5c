"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into `build/lib<name>.so` — a
shared library with a plain C interface, loaded with ctypes — at first
use, so a fresh checkout needs nothing but the CUDA toolkit.  Built for
`sm_90a` (Hopper).  Never with --use_fast_math: it would let the compiler
undo the Kahan compensation the kernels rely on.

Nothing here runs at import: the CPU tests import every module on
machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                       "build the port's kernels")


def _paths(name: str):
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD, "lib" + name + ".so"))


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header under csrc/."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def _command(name: str, extra: Sequence[str] = ()):
    src, so = _paths(name)
    return [nvcc_path(), *NVCC_FLAGS, *extra, "-o", so, src]


def build(names: Sequence[str], force: bool = False,
          extra_flags: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every stale kernel in `names` (every one with `force`),
    one nvcc per source, all started together, with `extra_flags` after
    the usual ones (e.g. ("-Xptxas", "-v") for register and spill counts);
    returns nvcc's output per compiled source and raises with it when one
    fails."""
    os.makedirs(BUILD, exist_ok=True)
    procs = [(n, subprocess.Popen(_command(n, extra_flags),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for n in names if force or _stale(n)]
    errors = []
    outputs = {}
    for n, p in procs:
        out, _ = p.communicate()
        outputs[n] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def entry(source: str, name: str, argtypes: Sequence):
    """The C function `name` of `csrc/<source>.cu`, built and loaded on
    first use, typed with `argtypes` and returning its CUDA error code."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


_occ: Dict[tuple, int] = {}
_sms: Dict[int, int] = {}


def blocks_per_sm(source: str, fn: str, *args: int) -> int:
    """Resident blocks per SM of one kernel instantiation, from the C entry
    `fn` of `source` over cudaOccupancyMaxActiveBlocksPerMultiprocessor
    (cached): `args` are its int arguments, the dynamic shared-memory
    bytes last."""
    key = (source,) + args
    got = _occ.get(key)
    if got is None:
        per_sm = ctypes.c_int(0)
        argtypes = [ctypes.c_int] * (len(args) - 1) + [ctypes.c_longlong,
                                                       ctypes.c_void_p]
        rc = entry(source, fn, argtypes)(*args, ctypes.byref(per_sm))
        check(rc, fn)
        if per_sm.value < 1:
            raise ValueError(f"{source}: no block with {args[-1]} bytes of "
                             f"shared memory fits an SM")
        got = _occ[key] = per_sm.value
    return got


def sm_count(device) -> int:
    """The SM count of a CUDA device (a torch.device with an index), read
    once per device."""
    got = _sms.get(device.index)
    if got is None:
        import torch

        got = _sms[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return got
