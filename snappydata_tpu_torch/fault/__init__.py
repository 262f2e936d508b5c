"""Fault injection (port of snappydata_tpu/fault).  The port keeps one
failpoint registry, `reliability/failpoints.py`; this package re-exports
it under the reference's import path."""

from snappydata_tpu_torch.reliability import failpoints
from snappydata_tpu_torch.reliability.failpoints import (ACTIONS, FailSpec,
                                                         InjectedFault, arm,
                                                         clear, disarm, hit,
                                                         mangle, reseed)

__all__ = [
    "ACTIONS", "FailSpec", "InjectedFault", "arm", "clear", "disarm",
    "failpoints", "hit", "mangle", "reseed",
]
