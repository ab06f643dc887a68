"""Combining rounds of batched STORE/CAS.

The deterministic linearization serialises updates to the same cell into
rounds; within one round every live op targets a distinct cell, so a round
is an embarrassingly parallel gather -> compare -> conditional write-back.
`cas_apply_round` replaces the reference's Pallas kernel with the CUDA
kernel `cas_apply_round_kernel` (`csrc/table_ops.cu`): one thread per op.
`cas_apply_rounds` runs all the rounds of a sorted op list in one launch
(the segment replay of `csrc/segment_replay.cuh`), where the reference's
`ops.bigatomic_update_rounds` runs its Pallas kernel once per round.

Dead lanes (ops not live in this round) point at the reserved dummy row n.
The Pallas kernel rewrote every lane's row, dead and failed lanes included
(a TPU has no conditional DMA); here only successful lanes write, so the
dead lanes only read row n, and their witness is its contents, as in the
reference.
"""

from __future__ import annotations

import torch

from repro_torch.core.layout import WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    CAS, STORE, cas_apply_round_ref, cas_apply_rounds_ref,
)

__all__ = ["CAS", "STORE", "cas_apply_round", "cas_apply_rounds"]


def cas_apply_round(data, meta, slot, kind, expected, desired):
    """One conflict-free round.  data: word[n+1, k] (row n = dummy); meta:
    word[n+1, 2]; slot: int32[p] (dead lanes -> n; live lanes distinct and
    < n); kind: int32[p] or [p, 1] (STORE, CAS, anything else dead);
    expected/desired: word[p, k].

    Updates `data` and `meta` in place (success: the row := desired and
    version += 2, wrapping; the mark is untouched) and returns (data, meta,
    success int32[p, 1], witness word[p, k] = each lane's pre-round row).
    A slot outside [0, n+1) is a dead lane with a zero witness.

    CPU tensors run `ref.cas_apply_round_ref`; CUDA tensors launch the
    kernel or raise."""
    n1, k = data.shape
    p = slot.shape[0]
    kind = kind.reshape(p).to(torch.int32)
    dev = data.device
    _build.check(dev, ("data", data, WORD_DTYPE, (n1, k)),
                 ("meta", meta, WORD_DTYPE, (n1, 2)),
                 ("slot", slot, torch.int32, (p,)),
                 ("kind", kind, torch.int32, (p,)),
                 ("expected", expected, WORD_DTYPE, (p, k)),
                 ("desired", desired, WORD_DTYPE, (p, k)))
    if _build.runs_plain(dev, "cas_apply_round"):
        return cas_apply_round_ref(data, meta, slot, kind, expected, desired)
    succ = torch.empty((p, 1), dtype=torch.int32, device=dev)
    wit = torch.empty((p, k), dtype=WORD_DTYPE, device=dev)
    if p:
        _build.launch("table_ops", "cas_apply_round", dev, data.data_ptr(),
                      meta.data_ptr(), n1, k, slot.data_ptr(),
                      kind.data_ptr(), expected.data_ptr(),
                      desired.data_ptr(), p, succ.data_ptr(), wit.data_ptr())
        cas_apply_round.launches += 1
    return data, meta, succ, wit


def cas_apply_rounds(data, meta, slot, kind, expected, desired, rounds: int,
                     upd_rank):
    """All `rounds` combining rounds of a sorted STORE/CAS op list.

    data: word[n+1, k] (row n = dummy); meta: word[n+1, 2]; slot: int32[p]
    SORTED; kind: int32[p] or [p, 1]; expected/desired: word[p, k];
    upd_rank: integer [p], op i's round.  A lane is live iff
    0 <= upd_rank < rounds and 0 <= slot < n+1.  Contract: within a round
    the live slots are distinct, so within a segment (a run of equal slots)
    the live lanes' rounds rise in lane order.

    Each segment's live lanes are replayed in lane order against its row:
    the witness is the row before the lane's turn; STORE writes desired,
    CAS writes iff the row equals expected, any other kind reads its
    witness and fails; each write adds 2 to meta[s, 0] (wrapping) and never
    touches the mark; a dirty row is written back once.  On in-contract
    inputs that is exactly the round loop `ref.cas_apply_rounds_ref` (round
    t = the lanes of rank t through `cas_apply_round`).  Updates `data` and
    `meta` in place; returns (data, meta, success int32[p], witness
    word[p, k]), both zero for a lane that is never live.

    CPU tensors run `ref.cas_apply_rounds_ref`; CUDA tensors launch the
    kernel once, whatever `rounds` is, or raise."""
    n1, k = data.shape
    p = slot.shape[0]
    kind = kind.reshape(p).to(torch.int32)
    upd_rank = upd_rank.to(torch.int32)
    dev = data.device
    _build.check(dev, ("data", data, WORD_DTYPE, (n1, k)),
                 ("meta", meta, WORD_DTYPE, (n1, 2)),
                 ("slot", slot, torch.int32, (p,)),
                 ("kind", kind, torch.int32, (p,)),
                 ("expected", expected, WORD_DTYPE, (p, k)),
                 ("desired", desired, WORD_DTYPE, (p, k)),
                 ("upd_rank", upd_rank, torch.int32, (p,)))
    if _build.runs_plain(dev, "cas_apply_rounds"):
        return cas_apply_rounds_ref(data, meta, slot, kind, expected,
                                    desired, rounds, upd_rank)
    succ = torch.empty((p,), dtype=torch.int32, device=dev)
    wit = torch.empty((p, k), dtype=WORD_DTYPE, device=dev)
    if p:
        _build.launch("table_ops", "cas_apply_rounds", dev, data.data_ptr(),
                      meta.data_ptr(), n1, k, slot.data_ptr(),
                      kind.data_ptr(), expected.data_ptr(),
                      desired.data_ptr(), upd_rank.data_ptr(),
                      max(0, min(int(rounds), 2 ** 31 - 1)), p,
                      succ.data_ptr(), wit.data_ptr())
        cas_apply_rounds.launches += 1
    return data, meta, succ, wit


cas_apply_round.launches = 0
cas_apply_rounds.launches = 0
