"""Tier-1 observability: engine counters kept on the device (PyTorch).

The paper's headline claims are rates — fast-path hit frequency, slow-path
round counts, CAS retry behaviour under contention — and the engine round
already materializes every signal they need: the fast-path predicate, the
(slot, lane)-sorted slots, `ApplyStats` and per-lane success.  This module
accumulates them into int32 counters on the table's device, with in-place
adds issued right after the round, so counting reads nothing back to the
host and a CUDA graph that captured an `apply` goes on counting each time
it is replayed.

The gate is the BIGATOMIC_OBS environment variable, read per call:

  off       (default) no counter exists and no entry point touches one:
            `apply` launches exactly the operations it launches without
            this module.
  counters  `engine.apply` and `engine.read` count on the device;
            host-side retry loops (`sync.queue`) record into a host dict.
  trace     counters + the executor timeline (`obs.recorder`).

Counters are int32: they wrap at 2^31, as the reference's do.  Call
`reset()` per measurement window; it zeroes the counters in place, so a
captured graph keeps counting into the same tensors.  `snapshot()` is the
one place the counters are read to the host.

The metric names and the counting rules are the JAX package's
(`repro.obs.telemetry`); the contention histogram is computed from the
sorted slots the round already holds, in p-sized operations, where the
reference scatters into an (n + 1)-sized count array.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

N_KINDS = 10          # engine.LOAD .. engine.DELETE
N_HIST = 16           # log2 contention buckets: [1], [2,3], [4,7], ...

_MODES = ("off", "counters", "trace")

_KIND_NAMES = ("load", "store", "cas", "idle", "ll", "sc", "validate",
               "find", "insert", "delete")
_CAS, _IDLE, _SC = 2, 3, 5


def configured_mode() -> str:
    """The observability mode requested by the environment (read per
    call)."""
    mode = os.environ.get("BIGATOMIC_OBS", "off")
    if mode not in _MODES:
        raise ValueError(f"BIGATOMIC_OBS={mode!r}; expected one of {_MODES}")
    return mode


def counters_on() -> bool:
    return configured_mode() != "off"


def trace_on() -> bool:
    return configured_mode() == "trace"


class Telemetry(NamedTuple):
    """The device counters: int32 tensors (0-d, plus the per-kind vector
    and the contention histogram), all views of one flat buffer so that a
    batch is counted with one in-place add and read with one copy.

    Engine counters (per `engine.apply` batch):
      batches         table batches observed
      ops_kind        [N_KINDS] lanes per op kind (IDLE padding included)
      fast_eligible   batches passing the fast-path predicate
      fast_taken      batches whose round resolved on the fast branch
                      (always 0 under BIGATOMIC_ENGINE_KERNEL=off)
      rounds          sum of ApplyStats.rounds
      slow_rounds     rounds spent on batches NOT taken by the fast path
      cas_fail        active CAS lanes that failed
      sc_fail         active SC lanes that failed
      raced_loads     loads whose cell saw a same-batch write
      dirty_cells     distinct cells written per batch, summed
      contention_hist [N_HIST] cells by log2(active lanes targeting them):
                      bucket b counts cells with lane count in [2^b, 2^(b+1))
    Read-protocol counters:
      torn_retries    reads that observed a torn/locked cell (ok=False)
    MCAS protocol counters (per MCAS attempt round):
      mcas_commits / mcas_aborts / mcas_rounds / mcas_backoff
    Distributed counters (per collective round):
      route_overflow / collective_rounds / collective_words
    """

    batches: torch.Tensor
    ops_kind: torch.Tensor
    fast_eligible: torch.Tensor
    fast_taken: torch.Tensor
    rounds: torch.Tensor
    slow_rounds: torch.Tensor
    cas_fail: torch.Tensor
    sc_fail: torch.Tensor
    raced_loads: torch.Tensor
    dirty_cells: torch.Tensor
    contention_hist: torch.Tensor
    torn_retries: torch.Tensor
    mcas_commits: torch.Tensor
    mcas_aborts: torch.Tensor
    mcas_rounds: torch.Tensor
    mcas_backoff: torch.Tensor
    route_overflow: torch.Tensor
    collective_rounds: torch.Tensor
    collective_words: torch.Tensor


# Each field's width in the flat buffer (0 = a 0-d scalar), in field order.
_WIDTH = {"ops_kind": N_KINDS, "contention_hist": N_HIST}
_OFFSET = {}
_SIZE = 0
for _name in Telemetry._fields:
    _OFFSET[_name] = _SIZE
    _SIZE += _WIDTH.get(_name, 1)
# `count_table` adds one delta to the buffer's prefix up to the histogram.
_TABLE_END = _OFFSET["contention_hist"] + N_HIST


def _views(buf: torch.Tensor) -> Telemetry:
    return Telemetry(*(buf[_OFFSET[f]:_OFFSET[f] + _WIDTH[f]] if f in _WIDTH
                       else buf[_OFFSET[f]] for f in Telemetry._fields))


def _flat(t: Telemetry) -> torch.Tensor:
    """The flat buffer the fields of `t` are views of."""
    return torch.as_strided(t.batches, (_SIZE,), (1,), 0)


def init_telemetry(device="cuda") -> Telemetry:
    """Zeroed counters on `device`."""
    return _views(torch.zeros((_SIZE,), dtype=torch.int32,
                              device=torch.device(device)))


class _Consts(NamedTuple):
    """Constant tensors `count_table` compares against, made once per
    device (a fill, not a host copy, so they are ready before a capture)."""

    one: torch.Tensor          # [1] = 1
    kinds: torch.Tensor        # arange(N_KINDS)
    thresholds: torch.Tensor   # 2^b for b in [0, N_HIST)


def _consts(device) -> _Consts:
    return _Consts(
        torch.ones((1,), dtype=torch.int32, device=device),
        torch.arange(N_KINDS, dtype=torch.int32, device=device),
        torch.bitwise_left_shift(
            torch.ones((N_HIST,), dtype=torch.int32, device=device),
            torch.arange(N_HIST, dtype=torch.int32, device=device)))


# ---------------------------------------------------------------------------
# Accumulators (device operations only, issued after the round).
# ---------------------------------------------------------------------------

def contention_bucket(c: torch.Tensor) -> torch.Tensor:
    """floor(log2(c)) clipped to N_HIST-1, via integer threshold compares
    (the reference's definition; c >= 1)."""
    th = torch.bitwise_left_shift(
        torch.ones((N_HIST - 1,), dtype=c.dtype, device=c.device),
        torch.arange(1, N_HIST, dtype=c.dtype, device=c.device))
    return (c[:, None] >= th[None, :]).sum(1, dtype=torch.int32)


def contention_hist(n: int, s_slot: torch.Tensor,
                    thresholds: torch.Tensor) -> torch.Tensor:
    """The int32[N_HIST] histogram of cells by log2(active lanes on the
    cell), from the batch's slots sorted ascending with inactive lanes at
    n (`engine_round.sort_slots`): each cell's lane count is its run length
    in the sorted order, found by two binary searches; a cell counts once,
    at its run's first lane.  G[b] = cells with >= 2^b lanes, and bucket b
    holds G[b] - G[b + 1]."""
    p = s_slot.shape[0]
    left = torch.searchsorted(s_slot, s_slot, out_int32=True)
    right = torch.searchsorted(s_slot, s_slot, right=True, out_int32=True)
    first = ((left == torch.arange(p, dtype=torch.int32,
                                   device=s_slot.device))
             & (s_slot >= 0) & (s_slot < n))
    ge = ((right - left)[:, None] >= thresholds[None, :]) & first[:, None]
    g = ge.sum(0, dtype=torch.int32)
    return g - torch.nn.functional.pad(g[1:], (0, 1))


def count_table(live: "Counters", n: int, ops, result, stats, *, s_slot,
                eligible, taken) -> None:
    """Count one `engine.apply` batch into the live counters (`carry_in`),
    in place: the batch (`ops`), its per-lane success, its `ApplyStats`,
    the sorted slots the round ran on (`s_slot`: inactive lanes at n) and
    the fast-path predicate (`eligible`) and branch (`taken`), 0-d bools.
    Every round given `telem=` calls this after it resolves the batch."""
    c = live.consts
    onehot = ops.kind[:, None] == c.kinds[None, :]
    fail = (onehot & ~result.success[:, None]).sum(0, dtype=torch.int32)
    taken = taken.to(torch.int32)
    scalars = torch.stack([
        eligible.to(torch.int32), taken, stats.rounds,
        stats.rounds * (1 - taken), fail[_CAS], fail[_SC],
        stats.n_raced_loads, stats.n_dirty_cells])
    delta = torch.cat([c.one, onehot.sum(0, dtype=torch.int32), scalars,
                       contention_hist(n, s_slot, c.thresholds)])
    _flat(live.telem)[:_TABLE_END].add_(delta)


def count_read(t: Telemetry, ok: torch.Tensor) -> None:
    """Count one `engine.read` batch: ok=False lanes observed a torn/
    locked cell and must retry (blocking strategies only)."""
    t.torn_retries.add_((~ok).sum(dtype=torch.int32))


def count_mcas_round(t: Telemetry, committed, failed_now, lost) -> None:
    """Count one MCAS attempt round from the protocol's own masks."""
    t.mcas_commits.add_(committed.sum(dtype=torch.int32))
    t.mcas_aborts.add_(failed_now.sum(dtype=torch.int32))
    t.mcas_rounds.add_(1)
    t.mcas_backoff.add_(lost.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# The global store: device counters per device + one host counter dict.
# ---------------------------------------------------------------------------

_telem: dict[torch.device, tuple[Telemetry, _Consts]] = {}
_host: dict[str, int] = {}


def telemetry(device="cuda") -> Telemetry:
    """The live counters on `device` (made, zeroed, at first use; make
    them before capturing a CUDA graph that counts)."""
    return _entry(torch.device(device))[0]


def _entry(device: torch.device):
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _telem:
        _telem[device] = (init_telemetry(device), _consts(device))
    return _telem[device]


class Counters(NamedTuple):
    """What an entry point counts into: the device's counters and the
    constants `count_table` compares against."""

    telem: Telemetry
    consts: _Consts


def carry_in(device) -> Counters | None:
    """The counters an entry point on `device` should count into, or None
    when counting is off (then nothing is made and nothing is launched)."""
    if not counters_on():
        return None
    return Counters(*_entry(torch.device(device)))


def record(**events: int) -> None:
    """Host-side counters (queue retry loops, serving dispatch counts,
    executor events): plain ints keyed by metric name, merged into
    `snapshot()`.  No-op when counting is off."""
    if not counters_on():
        return
    for name, v in events.items():
        _host[name] = _host.get(name, 0) + int(v)


def record_dist(overflow, words: int, device="cuda") -> None:
    """Count one distributed collective round (route-overflow mask + the
    static `collective_words(dspec)` count), in place on `device`.  The
    `counters_on` gate lives in the caller."""
    t = telemetry(device)
    t.route_overflow.add_(torch.as_tensor(overflow).to(t.batches.device)
                          .sum(dtype=torch.int32))
    t.collective_rounds.add_(1)
    t.collective_words.add_(int(words))


def reset() -> None:
    """Zero every counter (device counters in place, host counters
    cleared)."""
    for t, _ in _telem.values():
        _flat(t).zero_()
    _host.clear()


def snapshot() -> dict:
    """Every counter as one flat {metric_name: int} dict — the stable
    metric-name schema.  Reads each device's counters to the host once and
    sums them; host-side counters (`record`) merge in under their own
    names."""
    total = [0] * _SIZE
    for t, _ in _telem.values():
        for i, v in enumerate(_flat(t).cpu().tolist()):
            total[i] += v
    total = [(v + 2 ** 31) % 2 ** 32 - 2 ** 31 for v in total]   # int32

    def at(name, j=0):
        return total[_OFFSET[name] + j]

    out = {"engine.batches": at("batches")}
    for j, name in enumerate(_KIND_NAMES):
        out[f"engine.ops.{name}"] = at("ops_kind", j)
    out["engine.fast.eligible"] = at("fast_eligible")
    out["engine.fast.taken"] = at("fast_taken")
    out["engine.rounds.total"] = at("rounds")
    out["engine.rounds.slow"] = at("slow_rounds")
    out["engine.fail.cas"] = at("cas_fail")
    out["engine.fail.sc"] = at("sc_fail")
    out["engine.loads.raced"] = at("raced_loads")
    out["engine.cells.dirty"] = at("dirty_cells")
    for b in range(N_HIST):
        out[f"engine.contention.log2_{b:02d}"] = at("contention_hist", b)
    out["read.torn_retries"] = at("torn_retries")
    out["mcas.commits"] = at("mcas_commits")
    out["mcas.aborts"] = at("mcas_aborts")
    out["mcas.rounds"] = at("mcas_rounds")
    out["mcas.backoff"] = at("mcas_backoff")
    out["dist.route_overflow"] = at("route_overflow")
    out["dist.rounds"] = at("collective_rounds")
    out["dist.words"] = at("collective_words")
    out.update(_host)
    return out


def derived(snap: dict) -> dict:
    """The counter-derived rates (the reference's definitions)."""
    batches = snap.get("engine.batches", 0)
    taken = snap.get("engine.fast.taken", 0)
    slow_batches = batches - taken
    return {
        "hit_rate_fast": taken / batches if batches else 0.0,
        "eligible_rate": (snap.get("engine.fast.eligible", 0) / batches
                          if batches else 0.0),
        "mean_slow_rounds": (snap.get("engine.rounds.slow", 0) / slow_batches
                             if slow_batches else 0.0),
    }
