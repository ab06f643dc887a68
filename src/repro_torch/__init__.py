"""repro_torch — Big Atomics in PyTorch for an NVIDIA H100.

A port of the JAX package `repro` (the reference, left as it is), module by
module under the same file names.  The engine round of the four lock-free
layouts runs through hand-written CUDA kernels for Hopper
(`kernels/csrc/engine_round.cu`); every kernel has a plain PyTorch version
beside it, which the CPU runs.  The public surface is `repro_torch.atomics`;
its clients are `repro_torch.sync` (LL/SC, atomic copy, the MPMC
queue), `repro_torch.core.cachehash`, the telemetry of `repro_torch.obs`
and the transactions of `repro_torch.txn` (MCAS, version lists, the
transactional map; `core.multiversion`, `core.wf_writable`).
"""
