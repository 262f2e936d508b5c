"""snappydata_tpu_torch — the PyTorch/CUDA port of snappydata_tpu.

The analytic scan of the JAX package (CREATE TABLE ... USING column, bulk
insert, filter/group/aggregate queries such as TPC-H Q1 and Q6) on torch
tensors, with the TPU kernels of that path rewritten by hand as CUDA C++
for Hopper (`csrc/`).  The package imports nothing of JAX or of
snappydata_tpu: the modules it shares with the reference are copies.

Layer map (mirrors snappydata_tpu):
  session.py — SnappySession.sql / insert_arrays (entry point)
  sql/       — lexer, parser, analyzer, optimizer
  catalog/   — table metadata
  storage/   — encodings, batches, table store, device plates
  engine/    — plan compiler + executor, expression lowering, host eval
  ops/       — the CUDA kernels' wrappers and the packed reductions
  csrc/      — CUDA C++ sources, built with nvcc at first use
"""

from snappydata_tpu_torch.session import SnappySession  # noqa: F401

__version__ = "0.1.0"
