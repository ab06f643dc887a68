#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
It imports only the port (`src/repro_torch`), never JAX or the reference
package, and runs these phases:

  1. build   compile the hand-written kernels (`kernels/csrc/*.cu`, one
             nvcc per source, started together) for sm_90a; print the build
             time, the card's name and power limit.
  2. kernel vs plain
             the prologue's radix sort against `torch.sort(stable=True)`
             (order and sorted slots bit for bit) at n=2**22, p=16384 on
             uniform, Zipf 0.99, all_same, all-IDLE, out-of-range and any
             int32 slots, and at p = 1, 700, 3000 and 2**20 (512 tiles);
             the passes it ran (3 at n=2**22); then the four engine-round
             kernels (`round_prologue`, `fast_round`, `slow_round`,
             `round_epilogue`) against their plain PyTorch versions on the
             card, bit for bit on every output and on the updated table,
             the last three with their branch taken and not taken (then
             nothing may change): spectra none / low / all_same, a long
             segment with chained CAS lanes and later links (k = 3, 5, 20),
             all seven op kinds, several k (odd included), and the main
             path's shapes (Zipf 0.99 and the long segment too); then the
             four kernels as `make_round` runs them against the plain round
             (`make_round(mode="xla")`) at n=2**22, k=4, p=2**20 on both
             branches (1024 epilogue tiles, more than the card holds at
             once: the epilogue's blocks take tickets).
  3. main path
             `atomics.apply` at n=2**22, k=4, p=16384 for seqlock, indirect,
             cached_wf and cached_me: (a) distinct slots, all kinds; (b)
             read-only with duplicate slots; (c) uniform slots, 20 %
             updates; (d) Zipf 0.99 slots, 20 % updates; (e) an LL batch,
             then SC/VALIDATE on the linked slots.  Launch counts are reset
             just before and read just after; the four kernels must have
             run, and each batch must have taken the branch its predicate
             (read after the batch) names.  The same batches replay through
             the numpy sequential oracle: results, links, logical values,
             versions and `read()` must agree exactly.
  3b. table ops
             the raw-table layer (`kernels/ops.py`, `llsc_commit`): its six
             kernels against their plain versions (k = 1, 3, 4, 5, 16,
             the gather also at k = 2 and 8 and at k = 4 and 16 on tables
             one word off 16 bytes, CacheHash kw/vw = 1/1, 2/2, 4/2, and
             full width; the find at
             kw/vw = 1/1, 2/2, 4/2, 1/3 and the run-time 3/1, max_chain 8,
             0 and 40 over chains with cycles and nexts past the pool;
             `cas_apply_rounds` against the round loop on uniform, Zipf
             0.99, one hot cell, LOAD lanes, truncated rounds and negative
             ranks), then, with the counts reset, `bigatomic_load`,
             `bigatomic_update_rounds` (uniform, Zipf 0.99, one hot cell:
             one `cas_apply_rounds` launch each, no `cas_apply_round`),
             `llsc_commit_round`, `commit_round` on cached_me and
             `cachehash_find` at n = m = 2**22, p = q = 16384 (one find
             kernel launch, the bare probe none), each equal to a numpy
             oracle; the path's four kernels must have run, and
             `commit_round` must have taken the fast branch; then the find
             kernel against its plain version at full width.  Then each
             entry point's and kernel's time, the plain versions', the
             round loop's it replaced, the device-busy share and device
             operations; a `cachehash_find` call must make exactly one.
             (`table_probe.py` runs this phase alone, and times
             `seqlock_gather` at k = 1, 4, 8, 16 on n = 2**22 tables.)
  4. timing  per layout and batch (a), (c), (d): one `apply` (donate)
             captured in a CUDA graph and replayed once, which must equal
             the eager `apply` and the numpy oracle (a capture that fails
             fails the phase); then the median time per `apply`, eager and
             replayed (CUDA events), the device operations and device time
             of each (torch.profiler), the branch the batch took (its
             predicate, read after the timed window), the four kernels
             alone, their plain versions, `torch.sort` alone (the
             prologue's library yardstick), and the host-side steps around
             them; the run fails if a layout's device operations per eager
             `apply` exceed `DEVICE_OPS_LIMIT`, if a device operation of
             `torch.sort` or the sort key's `masked_fill` shows in the
             profiled `apply`, or if a memset runs right before a round
             kernel; then `slow_round` alone on one cell, a long segment,
             Zipf 0.99, and Zipf 0.99 at k = 20, each beside its longest
             segment.
  5. guard   the integrity scrub (`guard`, `runtime.LocalTarget`): the
             digest kernel bit for bit against its plain version (k = 1,
             3, 4, 5, 16 at n = 1003; full width, also against numpy);
             then, with the counts reset, per layout at n=2**22: batch (a),
             a checkpoint, a STORE batch to 4096 distinct cells, the
             baseline digest, 64 seeded bit flips and torn writes on
             distinct cells (half dirty; a `bptr` flip on indirect and
             cached_wf, a version flip on cached_me), `Scrubber.scrub`:
             detected = the injected cells, repaired = the clean ones with
             the checkpoint's values, quarantined = the dirty ones, the
             invariants naming the pointer and version faults; a batch
             through `mask_ops` equal to the numpy oracle with every
             poisoned lane failed; a second scrub clean.  Then the times of
             `cell_digest`, the digest kernel, its plain version,
             `check_invariants` and `Scrubber.scrub`, and of the
             whole-table row gather (`table[idx]` against
             `layout.gather_rows`, 2**22 rows of 16 bytes).
  6. attention
             `flash_attention` against `flash_attention_plain` at the
             attention widths of glm4_9b (t=4096, causal, bf16),
             mixtral_8x7b (t=8192, window 4096, bf16 and fp32),
             hubert_xlarge (t=4096, hd=80, bidirectional, bf16),
             recurrentgemma_9b (t=4096, hd=256, kvh=1, window 2048, bf16
             and fp32) and Phi-3-mini (t=4096, hd=96, kvh=32, bf16), a
             ragged fp32 case (t=1000), bf16 at hd=64 (t=4096), three
             ragged bf16 cases at b=2 (t=1000, and tq != tkv), hd=16 at
             b=2 (tq 1000, tkv 1200) in bf16 and fp32, head dims the
             tensor-core kernels pad: bf16 at hd=100, 129, 184, 250
             (t=1000), hd=7 and 50 (b=2, tq 1000, tkv 1200) and hd=200
             (t=4096, window 2048), fp32 at hd=100 and 95 (t=1000) and
             hd=7 and 50 (b=2, tq 1000, tkv 1200), and fp32 past hd 128,
             where the 3xTF32 kernel's consumers split O: hd=129, 184, 250
             (t=1000), hd=200 (t=4096, window 2048) and recurrentgemma_9b's
             ragged b=2 case, with the counts reset
             (bf16 within 1e-3 + 1e-2 |want|, fp32 within 1e-4 + 1e-4
             |want|); each case must have launched the kernel
             it names (`kernel_for`: the wgmma kernel for bf16 and the
             3xTF32 kernel for fp32, at every hd); then each case's time, its
             bound (bytes over the memory rate, or operations over the
             card's fastest route for the type: bf16 tensor cores, fp32 as
             three TF32 passes), the plain version's and
             `scaled_dot_product_attention`'s (with a window, its masked
             path, and its causal path without the window beside it).
  7. obs     with BIGATOMIC_OBS=counters set inside the phase, per layout:
             `apply` of batches (a), (c), (d) at n=2**22, k=4, p=16384,
             eager and as a captured CUDA graph replayed 5 times;
             `obs.snapshot()` must equal a numpy recount of every batch
             run (`NpTelemetry`, from the lanes' delivered success); then
             eager and replayed ms and device operations per `apply`,
             counters off (gated by `DEVICE_OPS_LIMIT` as before) and on.
  8. sync    `llsc.ll` / `sc` / `validate` of 16384 lanes at n=2**22
             against `apply_sync_reference`; `copy_batch` of 1024 random
             and chained lanes against `copy_batch_reference` with its
             wave count; `BigQueue(4096, k=2, p_max=64)` on seqlock and
             cached_me under no and exponential backoff: `enqueue_batch`,
             `dequeue_batch`, two `run_batch` of 32 ENQ + 32 DEQ lanes,
             against a sequential FIFO replay of the commit log; ms per
             call and rounds.
  9. cachehash
             `HashSpec(nb=2**22, vw=2, p_max=16384)` inline on the four
             layouts and chaining on cached_me: 2**21 INSERTs in batches
             of 16384 (load 0.5), then FIND-only uniform, 90/5/5
             FIND/INSERT/DELETE uniform and Zipf 0.99 batches, each against
             a Python-dict oracle and the final contents against it as
             sorted arrays; ms, ops/s, rounds, chain steps, inline hits,
             device operations per call and host syncs per `apply_hash`
             (must be 1).  Its rounds launch no kernel.
  10. txn    the transaction layer, with the counts reset just before its
             checked path and read just after (the four round kernels
             must have run; their launches join the kernels line): k-word
             MCAS on `AtomicSpec(2**22, 4, p_max=16384)` for the four
             layouts, T = 4096 txns of W = 4 distinct slots uniform and
             Zipf 0.99, T = 128 over 8 cells with no backoff (and exp(1,
             4) on cached_me), 80 % of txns expecting the live values
             (`benchmarks/bench_txn.py`), each against `mcas_reference` in
             `linearization_order` (success, witnesses, logical values,
             versions, `read()`), one host read per round (counted with
             `torch.cuda.set_sync_debug_mode("warn")`), the hot cases'
             `mcas_round` driven to drain equal to `mcas`; version lists
             (`VersionSpec(2**22, 4, depth=4)`: six publishes of 16384
             slots, a hot quarter whose rings lap, timestamps across 2**31;
             `snapshot_read` at nine timestamps and `latest` against a
             numpy model, `check_version_list` clean); the versioned store
             over ~256 MiB of state (four publishes, `step_at`,
             `begin_publish` as the torn negative control); the
             transactional map on the cachehash phase's table at load 0.5
             (4096 disjoint read-modify-write txns, one hot counter of 64)
             against `transact_reference` and the contents; `wf_writable`
             at n = 2**22 (`store_batch` of 16384 lanes with repeated
             slots, `cas_batch`) against `oracle_apply`.  Then per layout
             and MCAS case ms per call, ktxn/s, rounds, one round's device
             operations and device time (profiled), and one `mcas_round`
             captured in a CUDA graph and replayed against the eager round
             (a failed capture fails the run); publish / read / transact /
             store_batch / cas_batch times.
  10b. dist  `core/distributed.py` on a one-rank NCCL world
             (`make_mesh((1,), ("shard",))` on the card: every route and
             return is an all_to_all to self): `DistSpec(AtomicSpec(2**22,
             4, p_max=16384), "shard", 1, 16384)` on the four layouts,
             flat and with `dedup_loads` + `interleave`, batches (a), (c),
             (d) and (e) with the ctx carried; the counts reset just before
             each `dist.apply` and read just after it (each of the four
             round kernels once: the branch is taken on the device; their
             launches join the kernels line); each batch's values,
             success, overflow, links, `logical` and `versions` equal
             `atomics.apply` on the same state and batch and the numpy
             oracle replaying `linearization_order`; batches (a), (c),
             (d) once more under the profiler (each round kernel once a
             batch, and two all_to_alls a batch, each putting at least
             one operation on the card: NCCL's, at one rank a copy to
             self); ms per eager `dist.apply` (median of 20, CUDA events)
             beside `atomics.apply`, its split into route / round / return,
             one all_to_all alone, host syncs per call;
             `apply_hash` on `HashSpec(2**22, 2, p_max=16384)` (the
             cachehash phase's prefill and three batches) against the
             dict oracle and its contents; `mcas` on the txn phase's
             cases against `mcas_reference`; `txn.map.transact_dist` on
             the txn phase's map cases (`map_check`: the table prefilled
             with the cachehash phase's first 32 batches, load 1/8)
             against the one-device `transact` bit for bit and
             `transact_reference`, ms and host syncs of each; a
             `runtime.DistTarget` over `DistSpec(AtomicSpec(2**22, 4),
             "shard", 1, 2048)` beside `LocalTarget` on phase 12's
             factor-4 hot streams (S = 8, 96 batches of 2048 lanes), each
             history replayed equal to its table, the tables equal, wall
             ms and Mops/s of each (with the counts reset just before the
             `DistTarget` run and read just after, its round launches join
             the kernels line).  The group is destroyed at the phase's
             end.
  11. serving
             the paged-KV server (`serving.engine.ServingEngine` over
             `models.transformer`, the CacheHash page table, the BigQueue
             rings and `txn.map`): glm4_9b at full width and depth (40
             layers, d_model 4096, bf16, ~17.5 GiB of weights drawn on the
             card from a seeded generator with `dense_init`'s scales),
             `ServingEngine(max_batch=4, page_size=16, n_pages=256,
             max_pages_per_seq=64)` on the default layout, six greedy
             requests of 128-512 prompt tokens and 32 new tokens.  With
             the counts reset just before and read just after, the checked
             run: the page table against a numpy model (`PageModel`) after
             every step (contents equal, no page mapped twice, the free
             ring's count; at the end every page back on the ring, once);
             the four round kernels (through the rings) and
             `flash_attention_wgmma` (through the prefills) must have run,
             their launches join the kernels line.  Then the paged decode
             against the dense path (`make_prefill_step` +
             `make_serve_step`, teacher-forced with the engine's tokens):
             logits within `SERVE_ATOL` + `SERVE_RTOL` |want|, tokens
             equal wherever the dense top-2 margin exceeds twice that; the
             prefill's attention route against its plain pair-list version
             at t = 512; the reduced fp32 deepseek_7b engine on the four
             lock-free layouts, tokens equal to the dense path's.  Then a
             timed run (prefill ms, decode ms per step, tokens/s, host
             syncs and host reads per step, a decode step's and a
             one-crossing step's reads gated to the CPU's pinned 4 and
             15, three plain decode steps profiled for their device
             operations and busy share) and a split run (FIND, gather,
             forward, append, bookkeeping, sampling).  Between them,
             with the counts reset, `run_to_completion` and
             `run_pipelined` (`runtime.Executor`: admission and decode as
             two streams) on fresh engines: tokens identical to the
             checked run's, wall time and tokens/s of each; the pipelined
             run's round and `flash_attention_wgmma` launches join the
             kernels line.
  11b. sharded serving
             two processes on the card in one gloo world (collectives on
             card tensors, staged through the host: NCCL takes one card a
             rank), `python3 chip_smoke.py --sharded-rank R PORT DIR`
             each (`ShardedRank`), the mesh `make_mesh((2,), ("shard",),
             device="cuda")`: the sharded `BigQueue(4096, k=2, p_max=64)`
             (enqueue 32, dequeue 16, a mixed batch of 16 ENQ + 16 DEQ)
             against the one-device ring; `transact_dist` at 2 shards
             (`map_check`) against `transact` and `transact_reference`,
             the hot counter in T rounds; the sharded runtime
             (`sharded_runtime`, `ShardedRuntime`) with the counts reset
             just before and read just after (rows 1-2b must launch on
             each rank, and their launches join the kernels line): on
             each lock-free layout `runtime.DistTarget` over
             `DistSpec(AtomicSpec(2**22, 4), "shard", 2, 1024)`, a run of
             S = 4 hot streams (slots 1, factor 4, `checkpoint_every=2`)
             with a `shard_loss` mid-round 3 recovered onto the mesh (1,
             2) (one shard, both ranks): the `Recovery` at one shard,
             p_global 2048 kept, the whole history replayed equal to the
             final table, both ranks' histories equal (a digest each),
             the recovery split into restore / reshard (gather, rebuild)
             / journal replay / post-recovery checkpoint; clean runs on
             phase 12's hot streams at factor 1 and 4 (Mops/s,
             `x_of_f1`, an issue's host time split into prepare / route
             / round / return / all_gather, host syncs and reads per
             issue counted in one more factor-4 run ending in the same
             table), the factor-4 history replayed and equal on both
             ranks, printed after phase 12 beside its `LocalTarget`
             numbers; `elastic.reshard_dist` 2 -> 1 -> 2 with values and
             versions equal after each hop, split into gather and
             rebuild, and an LL link taken before the trip committing
             after it; glm4_9b whole, bf16, each rank
             its own weights, through `ServingEngine(mesh=...)` on
             cached_me, the six greedy requests: tokens equal to the
             serving phase's (no mesh) and to rank 0's own engine without
             a mesh (run while the other rank waits), one fused dispatch
             a decode step, the table empty and every page back at the
             end; with the counts reset just before each rank's sharded
             run and read just after, rows 1-2b and 7a must have
             launched on every rank, and their launches join the kernels
             line.  Each step timed with CUDA events, the decode FIND
             split into route / round / return / all_gather.  Then, the
             serving models freed, sharded training (`sharded_training`):
             rank 0 alone (the other rank at a barrier) runs glm4_9b at
             its published width, SHARD_TRAIN_LAYERS of 40 layers, b 2,
             t 4096, bf16, remat, AdamW fp32 moments, one snapshot slot,
             through `launch.train.train` without a mesh for
             SHARD_TRAIN_STEPS steps; then both ranks the same config
             and seed through `train(mesh=(data 1, model 2))`, with the
             counts reset just before and read just after: each rank
             must launch `flash_attention_wgmma` 2 x layers x steps
             (remat) and `flash_attention_bwd_wgmma` layers x steps,
             every attention call on 16 query heads and 1 kv head on the
             card (no plain route), rows 1-2b through the store's
             publishes; every stored slice of a sharded leaf half the
             leaf; losses and grad norms within SHARD_BF16_RTOL of the
             one-device run's (step 1's tighter: the later steps follow
             AdamW's first sign step); these launches join the kernels
             line.
             One more step instrumented: the host time of its 'model'
             collectives (gloo, staged through the host).  Then data
             parallel at (data 2, model 1) on reduced glm4_9b in fp32
             (b 8, t 128) against rank 0's one-device run of it within
             SHARD_FP32_RTOL.  A rank
             that fails or a world that outlives `SHARD_WORLD_TIMEOUT_S`
             (each collective bounded by `SHARD_PG_TIMEOUT_S`) fails the
             run.
  12. runtime
             the oversubscribed executor (`runtime.Executor` over
             `LocalTarget`) on the four lock-free layouts at
             `AtomicSpec(2**22, 4, p_max=2048)`, initial words from a seed,
             with the counts reset just before and read just after (the
             four round kernels and `digest_rows` must have run; their
             launches join the kernels line): `bench_oversub.py`'s sweep at
             card scale (slots 2, factor 1 / 2 / 4 / 8, so 2 / 4 / 8 / 16
             `SyntheticStream`s, 96 batches of 2048 lanes split evenly,
             uniform and hot: 4 cells, half the lanes), per cell a checked
             run (host syncs seen by `torch.cuda.set_sync_debug_mode` and
             tensor-to-host reads counted: must be 0 per issue), two timed
             runs (wall, Mops/s, `x_of_f1`) and a profiled one (device-busy
             share), every run ending in the first run's table and
             versions; the factor-4 hot history replayed through
             `runtime.replay_history` (every delivered value and success,
             the final table and versions); one `McasStream` (T = 4096, W
             = 4 on the lower half of `AtomicSpec(2**22, 4, p_max=16384)`)
             beside two ops streams on the upper half, equal to `mcas`
             alone and to the replay; with BIGATOMIC_GUARD=on
             `guard.chaos.run_chaos` (3 streams, 8 batches, one checkpoint
             fault, a temporary `checkpoint_dir`) with `verify_chaos` ok,
             the scrub pause per boundary; a `preempt` fault, a fresh
             executor resumed from the disk checkpoint ending in the
             uninterrupted run's table; a checkpoint's write and restore
             times.
  13. model families
             the MoE, SSM and hybrid configs at their published widths
             through `launch.steps` (`make_prefill_step`, then 8 greedy
             `make_serve_step` steps), weights drawn on the card from a
             seeded generator at the reference's scales, one config at a
             time, freed before the next: mixtral_8x7b (16 of 32 layers,
             bf16, b 1, t 6144 past its window 4096: a ring cache; cf
             1.25, C = 1920) and in fp32 at 2 layers, llama4_maverick (1
             of 48 layers: 128 experts, top-1, b 2, t 2048, C = 40),
             mamba2_780m (48 layers, b 2, t 2048: 8 SSD chunks) in bf16
             and fp32, recurrentgemma_9b (38 layers, b 2, t 3072 past its
             window 2048, hd 256) and in fp32 at one period (3 layers, b
             1, t 4096, the 3xTF32 kernel past hd 128).  With the counts
             reset just before each served run and read just after, each
             config's attention kernel must have launched once an
             attention layer (mamba2: none); the phase's
             `flash_attention_wgmma` and `flash_attention_tf32x3`
             launches join the kernels line.  Each decode is held to
             `forward(mode="train")` over the prompt and the fed tokens
             (`FAMILY_TOL`; MoE dropless, teacher-forced, positions whose
             experts moved exempt within `ROUTE_NOISE`), greedy tokens
             equal where the margin is clear; one MoE layer at mixtral's
             full width in fp32 against the port on the CPU (capacity,
             two groups, dropless: routing equal, outputs within
             `MOE_TOL`).  Prefill ms (warm, and the first call), decode ms
             a step, tokens/s, peak memory (above what the earlier phases
             hold), and a decode step profiled (device operations, device
             ms, busy share).
  14. training
             the attention backward kernels (`BWD`: bf16
             `csrc/flash_attention_bwd_wgmma.cu`, fp32
             `csrc/flash_attention_bwd_tf32x3.cu`, both from the LSE their
             forward kernel writes) against their plain twin at
             glm4_9b (b 2, t 4096, kv 2, causal), mixtral_8x7b (t 6144,
             window 4096, kv 8), recurrentgemma_9b (hd 256, kv 1, window
             2048), hubert_xlarge (hd 80, non-causal, t 1000) and ragged hd
             7 / 100 at b 2, each in bf16 and fp32, within `BWD_TOL`; three
             faults planted in each kernel (`BWD_FAULTS`) must each fail it;
             each forward kernel's LSE within its dtype's `LSE_TOL` of the
             plain forward's, each of `LSE_FAULTS` outside it; their time
             beside the plain twin, SDPA's backward and the bound.
             Then `launch.train.train` on glm4_9b at its published width
             (TRAIN_LAYERS of 40 layers, b 2, t 4096, bf16, remat, AdamW
             with fp32 moments, the versioned store publishing every step):
             TRAIN_CKPT steps and a checkpoint there, restored
             (CRC-verified) into a fresh template on the host and equal bit
             for bit to the state the run returned, then resumed from it to
             TRAIN_STEPS; finite losses that fall; with the counts reset
             just before and read just after, the forward kernel launched
             twice an attention layer and step (remat) and the backward
             once (both join the kernels line); ms a step, tokens/s, peak
             memory, a step profiled.  One bf16 step of mixtral_8x7b (2
             layers, t 6144, capacity drops), mamba2_780m (whole) and
             recurrentgemma_9b (one period): loss, every gradient leaf and
             the updated state finite.  One fp32 step of every reduced
             config on the card (the kernels) against the CPU (the plain
             versions) within the STEP_* tolerances.

Exits non-zero on any failure, without the result line.  On success the
last lines are the card (nvidia-smi), a JSON line with one entry per
kernel, and `{"ok": true, "device": {...}}`.  Details go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
N, K, P = 2 ** 22, 4, 16384
STRATEGIES = ("seqlock", "indirect", "cached_wf", "cached_me")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published memory rate
TABLE_OPS_CU = "src/repro_torch/kernels/csrc/table_ops.cu"
KERNELS = {
    "fast_round": ("src/repro_torch/kernels/csrc/engine_round.cu",
                   "src/repro/kernels/engine_round.py:340"),
    "slow_round": ("src/repro_torch/kernels/csrc/engine_round.cu",
                   "src/repro/kernels/engine_round.py:506"),
    # the host code around the two Pallas rounds: the sort, the predicate
    # (`fast_path_ok`) and the gathers into the sorted order before them,
    # the rebuild and stats after them (`_slow_pallas`, `_assemble_fast`)
    "round_prologue": ("src/repro_torch/kernels/csrc/engine_round.cu",
                       "src/repro/kernels/engine_round.py:103"),
    "round_epilogue": ("src/repro_torch/kernels/csrc/engine_round.cu",
                       "src/repro/kernels/engine_round.py:525"),
    "seqlock_gather": (TABLE_OPS_CU, "src/repro/kernels/seqlock_gather.py:105"),
    "cas_apply_round": (TABLE_OPS_CU, "src/repro/kernels/cas_apply.py:154"),
    "cas_apply_rounds": (TABLE_OPS_CU, "src/repro/kernels/cas_apply.py:154"),
    "llsc_commit_round": (TABLE_OPS_CU,
                          "src/repro/kernels/llsc_commit.py:77"),
    "cachehash_probe": (TABLE_OPS_CU,
                        "src/repro/kernels/cachehash_probe.py:81"),
    # the probe with the reference's hash and chain walk around it
    # (`src/repro/kernels/ops.py::cachehash_find`) in one launch
    "cachehash_find": (TABLE_OPS_CU,
                       "src/repro/kernels/cachehash_probe.py:81"),
    "digest_rows": ("src/repro_torch/kernels/csrc/scrub_digest.cu",
                    "src/repro/guard/scrub.py:91"),
    "flash_attention_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/flash_attention.py:120"),
    "flash_attention_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
        "src/repro/kernels/flash_attention.py:120"),
    # no Pallas backward: XLA differentiates the reference's plain
    # pair-list attention on its training path; both on the tensor cores,
    # fp32 as three TF32 products
    "flash_attention_bwd_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        "src/repro/models/attention.py:46"),
    "flash_attention_bwd_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32x3.cu",
        "src/repro/models/attention.py:46"),
}
ROUND_KERNELS = ("round_prologue", "fast_round", "slow_round",
                 "round_epilogue")
TABLE_KERNELS = ("seqlock_gather", "cas_apply_round", "cas_apply_rounds",
                 "llsc_commit_round", "cachehash_probe", "cachehash_find")
TABLE_PATH_KERNELS = ("seqlock_gather", "cas_apply_rounds",
                      "llsc_commit_round", "cachehash_find")
GUARD_STORES, GUARD_FAULTS = 4096, 64      # the scrub path's batch, faults
M, KW, VW, MAX_CHAIN = 2 ** 22, 2, 2, 8     # CacheHash: buckets, key/value
STORE, CAS, FULL = 1, 2, 1                  # words, chain depth; constants
NEXT_END = 2 ** 32 - 1                      # next word of a chain's end
# Device operations per eager `apply` at the timing phase's shapes: with
# the sort as `torch.sort` and a memset before each of the prologue and the
# epilogue (the round before the sort moved into the prologue), and the
# most this version may take, its own count.  The count is exact, not a
# mean: the host launches the same operations on every call (it reads
# nothing back), and it is taken from a call whose every launch left its
# device operation in the trace.
TORCH_SORT_DEVICE_OPS = {"seqlock": 37, "indirect": 55, "cached_wf": 62,
                         "cached_me": 55}
DEVICE_OPS_LIMIT = {"seqlock": 18, "indirect": 36, "cached_wf": 43,
                    "cached_me": 36}
# Device operations an `apply` no longer runs: `torch.sort`'s kernels and
# the sort key's masked fill.
OLD_SORT_OPS = ("RadixSort", "radix_sort", "masked_fill", "sort_postprocess",
                "segmented_sort", "fill_index")
# The CUDA API calls that put an operation on the device.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")
# The first kernel each round-kernel wrapper launches.
ROUND_FIRST_KERNELS = ("round_prologue_kernel", "round_epilogue_kernel")
SORT_SPECTRA = ("uniform", "zipf", "all_same", "all_idle", "out_of_range",
                "int32")


def log(*args):
    print(*args, flush=True)


def ops_by_call(events, device, reps):
    """The device operations of each of `reps` annotated calls
    (`smoke_call_<i>`) in a profiler trace's `events`, each operation in
    `device` found by its launch's correlation id, each launch by the
    host-side annotation around it; and the counts of the calls whose
    every launch left its operation in the trace."""
    spans = {ev["name"]: (ev["ts"], ev["ts"] + ev["dur"]) for ev in events
             if ev.get("cat") == "user_annotation" and
             ev.get("name", "").startswith("smoke_call_")}
    spans = [spans.get(f"smoke_call_{i}") for i in range(reps)]
    launch_call = {}                        # correlation id -> call
    for ev in events:
        corr = ev.get("args", {}).get("correlation")
        if corr is None or not ev.get("name", "").startswith(LAUNCH_CALLS):
            continue
        for i, span in enumerate(spans):
            if span and span[0] <= ev["ts"] <= span[1]:
                launch_call[corr] = i
    missing = [0] * reps                    # launches with no operation
    for i in launch_call.values():
        missing[i] += 1
    ops = [0] * reps
    seen = set()
    for ev in device:
        corr = ev.get("args", {}).get("correlation")
        if corr in launch_call:
            ops[launch_call[corr]] += 1
            if corr not in seen:
                seen.add(corr)
                missing[launch_call[corr]] -= 1
    return ops, [ops[i] for i in range(reps)
                 if ops[i] and missing[i] == 0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class Smoke:
    def __init__(self, torch, atomics, engine, er, convert, tk):
        self.torch, self.atomics, self.engine = torch, atomics, engine
        self.er, self.convert, self.tk = er, convert, tk
        self.dev = torch.device("cuda", 0)
        self.max_err = dict.fromkeys(KERNELS, 0)

    # -- helpers -------------------------------------------------------------

    def words(self, arr):
        return self.convert.tensor(arr, self.dev, word=True)

    def np_words(self, t):
        return self.convert.array(t, word=True)

    def time_ms(self, fn, reps=20, warmup=3, setup=None):
        """Median ms per call, CUDA events around each call.  With `setup`,
        each call is `fn(*setup())`, its operands made and synchronised
        before its events: a call that updates its operands in place is
        timed on fresh copies of them."""
        torch = self.torch
        pairs = []
        for _ in range(warmup + reps):
            args = ()
            if setup is not None:
                args = setup()
                torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs[warmup:])

    def device_ms(self, fn, reps=20, setup=None):
        """Device ms per call of a launch-only `fn` (no host syncs): the
        calls queue behind a spin kernel, so the events bracket the
        kernels alone and not the host's time to launch them.  With
        `setup`, every call gets its own operands `setup()`, all made
        before the spin."""
        torch = self.torch
        fresh = [setup() if setup is not None else ()
                 for _ in range(reps + 1)]
        fn(*fresh[0])
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)       # ~50 ms while the host enqueues
        a.record()
        for args in fresh[1:]:
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def device_busy(self, run, reps=5, trace=None, setup=None, tries=1):
        """Share of the wall time of `run` (which ends synchronised) that
        the card spends in kernels, memcpys and memsets, from a
        torch.profiler trace; plus the kernels' device time by name, and
        the device operations of each call (each operation found by its
        launch's correlation id, each launch by the call's annotation):
        `device_ops_per_apply` is the most among the calls whose every
        launch left its operation in the trace (the profiler can drop the
        first call's, and now and then every call's: the gated callers
        then trace the calls again, up to `tries` traces), None if none
        did.  With
        `setup`, each call is `run(*setup())`, made before the trace."""
        for attempt in range(1, tries + 1):
            out = self._device_busy(run, reps, trace, setup)
            if out.get("device_ops_per_apply") is not None or \
                    "error" in out:
                break
        out["traces"] = attempt
        return out

    def _device_busy(self, run, reps, trace, setup):
        from torch.profiler import ProfilerActivity, profile, record_function
        torch = self.torch
        fresh = [setup() if setup is not None else () for _ in range(reps)]
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for i, args in enumerate(fresh):
                    with record_function(f"smoke_call_{i}"):
                        run(*args)
                wall_us = (time.perf_counter() - t) * 1e6
            path = trace or (ROOT / "chiprun_out" / "apply_trace.tmp.json")
            prof.export_chrome_trace(str(path))
            events = json.loads(Path(path).read_text())["traceEvents"]
        except Exception as err:          # the profiler is optional here
            return {"error": f"not measured: {err!r}"}
        finally:
            torch.cuda.synchronize()
        busy, by_name = 0.0, {}
        device = sorted((ev for ev in events if ev.get("cat") in
                         ("kernel", "gpu_memcpy", "gpu_memset")),
                        key=lambda ev: ev.get("ts", 0.0))
        for ev in device:
            busy += ev.get("dur", 0.0)
            name = ev.get("name", "?")[:60]
            by_name[name] = by_name.get(name, 0.0) + ev.get("dur", 0.0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        ops, whole = ops_by_call(events, device, reps)
        return {"device_busy_share": busy / wall_us,
                "device_ops": [(ev.get("cat"), ev.get("name", "?"))
                               for ev in device],
                "device_us_per_apply": busy / reps,
                "device_ops_per_apply": max(whole) if whole else None,
                "device_ops_by_call": ops,
                "top_device_us_per_apply": {k: v / reps for k, v in top}}

    def compare(self, name, got, want):
        """Bit-for-bit equality of kernel vs plain outputs; tracks the max
        absolute difference of the uint32 values (0 when equal)."""
        for i, (x, y) in enumerate(zip(got, want)):
            y = y.to(x.dtype)
            if not self.torch.equal(x, y):
                diff = (x.to(self.torch.int64) & 0xFFFFFFFF) - \
                    (y.to(self.torch.int64) & 0xFFFFFFFF)
                err = int(diff.abs().max())
                self.max_err[name] = max(self.max_err[name], err)
                raise SystemExit(f"{name}: output {i} differs from the plain "
                                 f"version (max abs err {err})")

    # -- batches ---------------------------------------------------------------

    @staticmethod
    def spectrum_batch(rng, n, k, p, spectrum, current, ver):
        """All seven kinds over slots: none (distinct), low (n / 8 slots),
        all_same (one cell), zipf (Zipf 0.99, as bench_atomics), long (60 %
        of the lanes on one cell, whose CAS lanes often expect the row an
        earlier lane wrote and whose links often match a later version)."""
        kind = rng.integers(0, 7, p).astype(np.int32)
        if spectrum == "none":
            slot = rng.choice(n, p, replace=False).astype(np.int32)
        elif spectrum == "low":
            slot = rng.integers(0, max(n // 8, 2), p).astype(np.int32)
        elif spectrum == "zipf":
            slot = ((rng.zipf(1.01, p) - 1) % n).astype(np.int32)
        elif spectrum == "long":
            slot = rng.integers(0, n, p).astype(np.int32)
            slot[rng.random(p) < 0.6] = rng.integers(0, n)
        else:
            slot = np.full(p, rng.integers(0, n), np.int32)
        expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        expected[take] = current[slot[take]]
        desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        cslot = np.where(rng.random(p) < 0.7, slot,
                         rng.integers(-1, n, p)).astype(np.int32)
        vnow = ver[np.clip(cslot, 0, n - 1)]
        cver = np.where(rng.random(p) < 0.8, vnow, vnow + 2).astype(np.uint32)
        if spectrum == "long":
            hot = np.flatnonzero(slot == np.bincount(slot).argmax())
            later = rng.random(len(hot)) < 0.4
            expected[hot[1:][later[1:]]] = desired[hot[:-1][later[1:]]]
            cver[hot] += (2 * rng.integers(0, len(hot) // 4 + 1,
                                           len(hot))).astype(np.uint32)
        ctx = (cslot, cver, np.zeros((p, k), np.uint32), rng.random(p) < 0.8)
        return (kind, slot, expected, desired), ctx

    def round_args(self, n, ops, ctx):
        """What the round hands its three kernels for `ops`: the batch and
        links on the card, the sort, the predicate, and the replay's sorted
        lane operands."""
        er = self.er
        ops = self.convert.op_batch(ops, self.dev)
        ctx = self.convert.link_ctx(ctx, self.dev)
        pro = er.round_prologue_plain(n, ops, ctx)
        return SimpleNamespace(
            ops=ops, ctx=ctx, s_slot=pro.s_slot, order=pro.order,
            s_kind=pro.s_kind, fast=pro.fast, slow=pro[2:7], prologue=pro)

    def round_out(self, p, k):
        """A `RoundOut` filled with values no kernel writes."""
        out = self.er.RoundOut.empty(p, k, self.dev)
        for t in (out.value, out.ctx.slot, out.ctx.version, out.ctx.value,
                  out.okw, out.stats, out.dirty):
            t.fill_(-7)
        out.success.fill_(True)
        out.ctx.linked.fill_(True)
        return out

    @staticmethod
    def out_tensors(out):
        return (out.value, out.success, *out.ctx, out.okw, out.stats,
                out.dirty)

    def flag(self, value):
        return self.torch.tensor(value, device=self.dev)

    # -- phase 2 -------------------------------------------------------------

    @staticmethod
    def sort_batch(rng, n, p, spectrum):
        """(kind, slot) of p lanes for the sort: uniform slots in [0, n),
        Zipf 0.99, one slot, every lane IDLE, active lanes on negative
        slots and slots >= n among uniform ones, or any int32; a quarter
        of the lanes IDLE (all_idle: all)."""
        kind = rng.integers(0, 7, p).astype(np.int32)
        kind[rng.random(p) < 0.25] = 3
        if spectrum == "zipf":
            slot = (rng.zipf(1.01, p) - 1) % n
        elif spectrum == "all_same":
            slot = np.full(p, rng.integers(0, n))
        elif spectrum == "int32":
            slot = rng.integers(-2 ** 31, 2 ** 31, p)
        else:
            slot = rng.integers(0, n, p)
        if spectrum == "all_idle":
            kind[:] = 3
        if spectrum == "out_of_range":
            bad = rng.random(p) < 0.2
            slot[bad] = rng.choice(np.array([-1, -2 ** 31, n, n + 1,
                                             2 ** 31 - 1]), int(bad.sum()))
            kind[bad] = rng.integers(0, 7, int(bad.sum()))
        return kind, slot.astype(np.int32)

    def sort_vs_torch(self, n, p, spectrum, seed):
        """The prologue's sort against `torch.sort(stable=True)` of the same
        keys (`sort_slots`), order and sorted slots bit for bit; returns the
        passes it ran (the digits that vary, left in its scratch)."""
        er, torch = self.er, self.torch
        rng = np.random.default_rng(seed)
        kind, slot = self.sort_batch(rng, n, p, spectrum)
        zeros = np.zeros((p, K), np.uint32)
        ops = self.convert.op_batch((kind, slot, zeros, zeros), self.dev)
        ctx = self.convert.link_ctx((slot, np.zeros(p, np.uint32), zeros,
                                     np.ones(p, bool)), self.dev)
        got = er.round_prologue(n, ops, ctx)
        want = er.sort_slots(n, ops)
        torch.cuda.synchronize()
        self.compare("round_prologue", (got.s_slot, got.order), want)
        return bin(int(got.scratch[1])).count("1")

    def kernel_vs_plain(self, n, k, p, spectrum, seed):
        """Each kernel against its plain version: `round_prologue` on the
        batch and on its collision-free or read-only form; with its branch
        taken and not taken, `slow_round` on the batch, `fast_round` on the
        other form, and `round_epilogue` after each."""
        er, torch = self.er, self.torch
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
        ops, ctx = self.spectrum_batch(rng, n, k, p, spectrum, data, ver)
        d, v = self.words(data), self.words(ver)
        # the fast kernel's contract: collision-free, or else read-only
        kind = ops[0]
        read_only = np.where(np.isin(kind, [1, 2, 5]), 0, kind)
        fast_ops = ops if spectrum == "none" else \
            (read_only.astype(np.int32), *ops[1:])

        r = self.round_args(n, ops, ctx)
        rf = self.round_args(n, fast_ops, ctx)
        for rr in (r, rf):
            got = er.round_prologue(n, rr.ops, rr.ctx)
            torch.cuda.synchronize()
            self.compare("round_prologue", got[:7], rr.prologue[:7])
        for taken in (False, True):           # the slow branch taken
            fast = self.flag(not taken)
            got = er.slow_round(d.clone(), v.clone(), *r.slow, fast=fast)
            want = er.slow_round_plain(d.clone(), v.clone(), *r.slow,
                                       fast=fast)
            torch.cuda.synchronize()
            self.compare("slow_round", got if taken else got[:2],
                         want if taken else (d, v))
        slow_ver, slow_out = want[1], want[2:]

        if not bool(rf.fast):
            raise SystemExit(f"{spectrum}: the fast batch fails the predicate")
        for taken in (False, True):
            fast = self.flag(taken)
            dk, vk, dp, vp = d.clone(), v.clone(), d.clone(), v.clone()
            got = er.fast_round(fast, dk, vk, rf.ctx, rf.ops,
                                self.round_out(p, k))
            want = er.fast_round_plain(fast, dp, vp, rf.ctx, rf.ops,
                                       self.round_out(p, k))
            torch.cuda.synchronize()
            self.compare("fast_round", (dk, vk, *self.out_tensors(got)),
                         (dp, vp, *self.out_tensors(want)))
            if not taken:
                self.compare("fast_round", (dk, vk, *self.out_tensors(got)),
                             (d, v, *self.out_tensors(self.round_out(p, k))))

        # the epilogue after either branch; after the fast one it must
        # leave the fast round's lane outputs alone
        for rr, fast, out, version, outs in (
                (r, self.flag(False), self.round_out(p, k), slow_ver,
                 slow_out),
                (rf, rf.fast, want, vp, None)):
            if outs is None:
                outs = er.slow_round(dp.clone(), vp.clone(), *rr.slow,
                                     fast=fast)[2:]
            got, mine = (er.RoundOut(*(clone(x) if isinstance(x, tuple)
                                       else x.clone() for x in out))
                         for _ in range(2))
            args = (fast, n, rr.ctx, rr.order, rr.s_slot, rr.s_kind, *outs,
                    version)
            er.round_epilogue(*args, got, er.round_scratch(p, self.dev))
            er.round_epilogue_plain(*args, mine)
            torch.cuda.synchronize()
            self.compare("round_epilogue", self.out_tensors(got),
                         self.out_tensors(mine))
            if bool(fast):
                self.compare("round_epilogue", self.out_tensors(got)[:7],
                             self.out_tensors(out)[:7])

    def round_vs_plain_round(self, n, k, p, spectrum, seed):
        """The round's four kernels as `make_round` runs them against the
        plain round (`make_round(mode="xla")`) on the same table and batch:
        table, links, results, stats and dirty list bit for bit.  Returns
        the branch taken."""
        er, torch = self.er, self.torch
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        ver = (rng.integers(0, 8, n) * 2).astype(np.uint32)
        ops_np, ctx_np = self.spectrum_batch(rng, n, k, p, spectrum, data,
                                             ver)
        ops = self.convert.op_batch(ops_np, self.dev)
        ctx = self.convert.link_ctx(ctx_np, self.dev)
        d, v = self.words(data), self.words(ver)
        got, want = (er.make_round(n, k, mode=mode)(d.clone(), v.clone(),
                                                    ctx, ops)
                     for mode in ("pallas", "xla"))
        torch.cuda.synchronize()

        def flat(out):
            return [x for part in out for x in
                    (part if isinstance(part, tuple) else (part,))]

        self.compare("round_epilogue", flat(got), flat(want))
        return self.branch(ops)

    # -- phase 3 -------------------------------------------------------------

    @staticmethod
    def update_mix(rng, slot, p, k, current):
        u = rng.random(p) < 0.2
        kind = np.where(u, np.where(rng.random(p) < 0.5, 2, 1), 0)
        expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        expected[take] = current[slot[take]]
        return (kind.astype(np.int32), slot.astype(np.int32), expected,
                rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))

    def main_batch(self, name, rng, current, ctx_slot):
        n, k, p = N, K, P
        words = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        zeros = np.zeros((p, k), np.uint32)
        if name == "a_distinct_all_kinds":
            slot = rng.choice(n, p, replace=False).astype(np.int32)
            expected = np.where((rng.random(p) < 0.5)[:, None],
                                current[slot], words)
            return (rng.integers(0, 7, p).astype(np.int32), slot, expected,
                    rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))
        if name == "b_read_only_dup":
            kind = rng.choice([0, 3, 4, 6], p).astype(np.int32)
            return (kind, rng.integers(0, 1024, p).astype(np.int32), zeros,
                    zeros)
        if name == "c_uniform_u20":
            return self.update_mix(rng, rng.integers(0, n, p), p, k, current)
        if name == "d_zipf099_u20":
            slot = (rng.zipf(1.01, size=p) - 1) % n   # as bench_atomics
            return self.update_mix(rng, slot, p, k, current)
        if name == "e1_ll":
            return (np.full(p, 4, np.int32),
                    rng.integers(0, n, p).astype(np.int32), zeros, zeros)
        kind = np.where(rng.random(p) < 0.7, 5, 6).astype(np.int32)
        return kind, ctx_slot.astype(np.int32), zeros, words

    def branch(self, ops):
        """The branch the round takes for `ops`: its predicate, read back."""
        return "fast" if bool(self.er.fast_path_ok(N, ops)) else "slow"

    def main_path(self, strategy, seed):
        """Drive `atomics.apply` through batches (a)-(e); returns the
        recorded batches and outputs, plus per-batch branches."""
        atomics, torch = self.atomics, self.torch
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        state = atomics.init(spec, initial, device=self.dev)
        ctx = atomics.init_ctx(P, K, device=self.dev)
        record = []
        names = ["a_distinct_all_kinds", "b_read_only_dup", "c_uniform_u20",
                 "d_zipf099_u20", "e1_ll", "e2_sc_validate"]
        torch.cuda.synchronize()
        self.tk.reset_launch_counts()
        t0 = time.perf_counter()
        for name in names:
            current = self.np_words(atomics.logical(spec, state))
            ops = self.main_batch(name, rng, current,
                                  ctx.slot.cpu().numpy())
            batch = self.convert.op_batch(ops, self.dev)
            state, ctx, res, stats, traffic = atomics.apply(
                spec, state, batch, ctx, donate=True)
            record.append((name, ops, self.branch(batch),
                           self.convert.to_numpy(res),
                           self.convert.to_numpy(ctx),
                           {f: int(x) for f, x in zip(stats._fields, stats)}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: self.tk.WRAPPERS[name].launches
                    for name in ROUND_KERNELS}
        final = (self.np_words(atomics.logical(spec, state)),
                 self.np_words(state.version))
        vals, ok = atomics.read(spec, state, np.arange(N))
        return (spec, state, initial, record, launches, final,
                (self.np_words(vals), ok.cpu().numpy()), wall)

    def check_main_path(self, strategy, initial, record, launches, final,
                        read):
        engine = self.engine
        expect = {"a_distinct_all_kinds": "fast", "b_read_only_dup": "fast",
                  "c_uniform_u20": "slow", "d_zipf099_u20": "slow",
                  "e1_ll": "fast"}
        data, ver = initial.copy(), np.zeros(N, np.uint32)
        ctx = (np.full(P, -1, np.int32), np.zeros(P, np.uint32),
               np.zeros((P, K), np.uint32), np.zeros(P, bool))
        for name, ops, branch, res, got_ctx, stats in record:
            if name in expect and branch != expect[name]:
                raise SystemExit(f"{strategy}/{name}: took the {branch} "
                                 f"branch, expected {expect[name]}")
            moved = None
            data, ver_next, ctx, ref = engine.apply_ops_reference(
                data, ver, ctx, ops)
            moved = int((ver_next != ver).sum())
            ver = ver_next
            if stats["n_dirty_cells"] != moved:
                raise SystemExit(f"{strategy}/{name}: n_dirty_cells "
                                 f"{stats['n_dirty_cells']}, oracle {moved}")
            for what, a, b in (("value", res[0], ref.value),
                               ("success", res[1], ref.success),
                               *((f"ctx.{f}", x, y) for f, x, y in zip(
                                   engine.LinkCtx._fields, got_ctx, ctx))):
                if not np.array_equal(a, b):
                    raise SystemExit(f"{strategy}/{name}: {what} differs "
                                     "from the sequential oracle")
        if not (np.array_equal(final[0], data)
                and np.array_equal(final[1], ver)):
            raise SystemExit(f"{strategy}: final table differs from oracle")
        vals, ok = read
        if not ok.all() or not np.array_equal(vals, data):
            raise SystemExit(f"{strategy}: read() differs from logical")
        for name, count in launches.items():
            if count <= 0:
                raise SystemExit(f"{strategy}: {name} never launched on the "
                                 "main path")

    # -- phase 4 -------------------------------------------------------------

    def captured_apply(self, spec, state, ops, ctx, ops_np):
        """One `apply` (donate) of `ops` captured in a CUDA graph on a copy
        of `state` and replayed once: it must equal the eager `apply` on
        another copy, field by field, and the numpy oracle.  Returns the
        graph (replaying it again re-runs the batch on its copy)."""
        atomics, torch, engine = self.atomics, self.torch, self.engine
        eager = atomics.apply(spec, clone(state), ops, ctx, donate=True)
        mine = clone(state)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = atomics.apply(spec, mine, ops, ctx, donate=True)
            graph.replay()
            torch.cuda.synchronize()
        except Exception as err:           # a failed capture fails the phase
            raise SystemExit(f"{spec.strategy}: capturing apply in a CUDA "
                             f"graph failed: {err!r}") from err
        graph.operands = (mine, out)       # the replays read and write them
        for part, (a, b) in enumerate(zip(out, eager)):
            for i, (x, y) in enumerate(zip(a, b)):
                if not torch.equal(x, y):
                    raise SystemExit(f"{spec.strategy}: the replayed apply "
                                     f"differs from the eager one (output "
                                     f"{part}.{i})")
        data, ver, o_ctx, ref = engine.apply_ops_reference(
            self.np_words(atomics.logical(spec, state)),
            self.np_words(state.version), self.convert.to_numpy(ctx), ops_np)
        got = (self.np_words(atomics.logical(spec, out[0])),
               self.np_words(out[0].version),
               *self.convert.to_numpy(out[1]),
               *self.convert.to_numpy(out[2]))
        for i, (x, y) in enumerate(zip(got, (data, ver, *o_ctx, *ref))):
            if not np.array_equal(x, y):
                raise SystemExit(f"{spec.strategy}: the replayed apply "
                                 f"differs from the oracle (output {i})")
        return graph

    def timing(self, strategy, spec, state, rng):
        """Per batch (a), (c), (d): the captured apply checked, then the
        median ms per apply eager and replayed, their device operations and
        time, the branch, the kernels alone, their plain versions, and the
        host-side steps around them."""
        atomics, engine, er, torch = (self.atomics, self.engine, self.er,
                                      self.torch)
        impl = atomics.get_strategy(strategy)
        ctx = atomics.init_ctx(P, K, device=self.dev)
        out = {}
        for name in ("a_distinct_all_kinds", "c_uniform_u20",
                     "d_zipf099_u20"):
            current = self.np_words(atomics.logical(spec, state))
            ops_np = self.main_batch(name, rng, current, None)
            ops = self.convert.op_batch(ops_np, self.dev)
            graph = self.captured_apply(spec, state, ops, ctx, ops_np)
            row = {}
            host = []
            # the table the batch was made for, for the kernels alone
            d = impl.engine_view(state).clone()
            v = state.version.clone()

            def run():
                nonlocal state
                t = time.perf_counter()
                state, *_ = atomics.apply(spec, state, ops, ctx, donate=True)
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t)

            def replay():
                graph.replay()
                torch.cuda.synchronize()

            row["apply_ms"] = self.time_ms(run)
            row["apply_host_clock_ms"] = statistics.median(host) * 1e3
            row["ops_per_s"] = P / (row["apply_ms"] * 1e-3)
            row["replay_ms"] = self.time_ms(graph.replay)
            row["replay_device_ms"] = self.device_ms(graph.replay)
            row["branch"] = self.branch(ops)
            r = self.round_args(N, ops_np, self.convert.to_numpy(ctx))
            fast = r.fast

            def fresh():
                return d.clone(), v.clone()

            def fast_kernel(dd, vv, plain=False):
                fn = er.fast_round_plain if plain else er.fast_round
                return fn(fast, dd, vv, r.ctx, r.ops, out_buf)

            def slow_kernel(dd, vv, plain=False):
                fn = er.slow_round_plain if plain else er.slow_round
                return fn(dd, vv, *r.slow, fast=fast)

            out_buf = self.round_out(P, K)
            dd, vv = fresh()                 # the round's table, as it runs
            fast_kernel(dd, vv)
            slow_out = slow_kernel(dd, vv)[2:]

            def epilogue(scratch, plain=False):
                fn = er.round_epilogue_plain if plain else er.round_epilogue
                return fn(fast, N, r.ctx, r.order, r.s_slot, r.s_kind,
                          *slow_out, vv, out_buf, scratch)

            def prologue(plain=False):
                fn = er.round_prologue_plain if plain else er.round_prologue
                return fn(N, r.ops, r.ctx)

            def scratch():                   # as a prologue leaves it
                return (er.round_scratch(P, self.dev),)

            kernels = {}
            for kname, call, setup in (("round_prologue", prologue, None),
                                       ("fast_round", fast_kernel, fresh),
                                       ("slow_round", slow_kernel, fresh),
                                       ("round_epilogue", epilogue,
                                        scratch)):
                kernels[kname] = {
                    "ms": self.device_ms(call, setup=setup),
                    "with_launch_ms": self.time_ms(call, setup=setup),
                    "plain_ms": self.time_ms(
                        lambda *a: call(*a, plain=True), reps=5, warmup=1,
                        setup=setup)}
            row["kernels"] = kernels
            key = er.sort_key(N, r.ops)
            kernels["round_prologue"]["library_ms"] = self.device_ms(
                lambda: torch.sort(key, stable=True))
            steps = {
                "check_kinds": lambda: engine.check_kinds(
                    ops.kind, engine.TABLE_KINDS, "table"),
                "sort": lambda: er.sort_slots(N, ops),
            }
            scratch = clone(state)
            stats = engine.ApplyStats(*(torch.full(
                (), P, dtype=torch.int32, device=self.dev) for _ in range(6)))
            dirty = torch.arange(P, dtype=torch.int32, device=self.dev) * 7
            steps["commit"] = lambda: impl.commit(
                scratch, scratch.data, scratch.version, stats, dirty, P)
            steps["traffic"] = lambda: impl.traffic(stats, K, P)
            row["host_steps_ms"] = {k: self.time_ms(fn, reps=10)
                                    for k, fn in steps.items()}
            row["host_side_ms"] = row["apply_ms"] - sum(
                kern["ms"] for kern in kernels.values())
            row["longest_segment"] = longest_segment(torch, r.s_slot, N)
            for kname, tier in (("fast_round", "fast"),
                                ("slow_round", "slow")):
                # a kernel whose branch is not taken reads the flag alone
                kernels[kname]["bytes"] = self.round_bytes(
                    N, K, r, tier, d, v) if tier == row["branch"] else 1
            kernels["round_prologue"]["bytes"] = self.prologue_bytes(K, P)
            live = r.s_slot[(r.s_slot >= 0) & (r.s_slot < N)]
            kernels["round_epilogue"]["bytes"] = self.epilogue_bytes(
                K, P, row["branch"], int(torch.unique(live).numel()))
            for kern in kernels.values():
                kern["bound_ms"] = kern["bytes"] / HBM_BYTES_PER_S * 1e3
            trace = (ROOT / "chiprun_out" / f"apply_trace_{strategy}_{name}"
                     ".json") if strategy == "cached_me" else None
            row["profile"] = self.device_busy(run, trace=trace, tries=3)
            row["replay_profile"] = self.device_busy(replay)
            self.check_device_ops(strategy, name, row["profile"])
            out[name] = row
            del graph
        return state, out

    @staticmethod
    def check_device_ops(strategy, name, prof):
        """Fail unless the profiled eager `apply` ran at most
        DEVICE_OPS_LIMIT device operations, none of the old sort's, and no
        memset right before a round kernel."""
        where = f"{strategy}/{name}"
        if "device_ops" not in prof:
            raise SystemExit(f"{where}: device operations not measured "
                             f"({prof.get('error')})")
        count = prof["device_ops_per_apply"]
        if count is None:
            raise SystemExit(f"{where}: no call left all its device "
                             f"operations in the trace "
                             f"({prof['device_ops_by_call']})")
        if count > DEVICE_OPS_LIMIT[strategy]:
            raise SystemExit(f"{where}: {count} device operations per apply,"
                             f" more than {DEVICE_OPS_LIMIT[strategy]}")
        ops = prof["device_ops"]
        old = [nm for _, nm in ops if any(o in nm for o in OLD_SORT_OPS)]
        if old:
            raise SystemExit(f"{where}: the apply still runs {old[0]}")
        for (cat, _), (_, nm) in zip(ops, ops[1:]):
            if cat == "gpu_memset" and any(k in nm for k in
                                           ROUND_FIRST_KERNELS):
                raise SystemExit(f"{where}: a memset runs before {nm}")

    def slow_spectra(self):
        """`slow_round` alone on one cell, a long segment (60 % of the
        lanes on one cell), Zipf 0.99, and Zipf 0.99 at k = 20 (a thread
        per segment): device ms (each rep on a fresh copy of the table),
        bound and longest segment."""
        torch, er = self.torch, self.er
        out = {}
        for i, (spectrum, k) in enumerate((("all_same", K), ("long", K),
                                           ("zipf", K), ("zipf", 20))):
            rng = np.random.default_rng(7 + i)
            data = rng.integers(0, 2 ** 32, (N, k), dtype=np.uint32)
            ver = np.zeros(N, np.uint32)
            ops, ctx = self.spectrum_batch(rng, N, k, P, spectrum, data, ver)
            r = self.round_args(N, ops, ctx)
            d, v = self.words(data), self.words(ver)
            row = {"k": k,
                   "longest_segment": longest_segment(torch, r.s_slot, N),
                   "ms": self.device_ms(
                       lambda dd, vv: er.slow_round(dd, vv, *r.slow), reps=5,
                       setup=lambda: (d.clone(), v.clone())),
                   "bytes": self.round_bytes(N, k, r, "slow", d, v)}
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            out[f"{spectrum}_k{k}"] = row
        return out

    def round_bytes(self, n, k, r, tier, data, version):
        """Bytes the round's kernel of `tier` must move on these inputs
        (its branch taken): every lane operand read once, every output
        written once, each distinct live row (and its version) read once,
        each written row written once."""
        torch, er = self.torch, self.er
        p = r.s_slot.shape[0]
        live = r.s_slot[r.s_slot < n]
        rows = int(torch.unique(live[live >= 0]).numel())
        d0, v0 = data.clone(), version.clone()
        if tier == "fast":
            er.fast_round(self.flag(True), d0, v0, r.ctx, r.ops,
                          self.round_out(p, k))
            # slot, kind, expected, desired, the link; value, success, the
            # new link, okw
            lane_in = p * (4 + 4 + 8 * k + (4 + 4 + 4 * k + 1))
            lane_out = p * (4 * k + 1 + (4 + 4 + 4 * k + 1) + 4)
        else:
            er.slow_round(d0, v0, *r.slow)
            lane_in = p * (4 + 4 + 4 + 8 * k)
            lane_out = p * (4 * k + 4 + 4)
        written = int(((d0 != data).any(1) | (v0 != version)).sum())
        return lane_in + lane_out + (rows + written) * (4 * k + 4)

    @staticmethod
    def prologue_bytes(k, p):
        """Bytes `round_prologue` must move: each lane's slot, kind, rows
        and link in; the sorted order and slots, and each lane's kind, link
        version and rows in the sorted order out (and the flag)."""
        lane_in = p * (4 + 4 + 8 * k + (4 + 4 + 1))
        lane_out = p * (4 + 4 + 4 + 4 + 8 * k)
        return lane_in + lane_out + 1

    @staticmethod
    def epilogue_bytes(k, p, branch, cells):
        """Bytes `round_epilogue` must move on `branch`: the sorted order,
        slots and kinds and each lane's success in; on the slow branch the
        replay's outputs, the links and the version of each of the `cells`
        in, the lanes' results and new links out; the stats and the dirty
        list out."""
        sorted_in = p * (4 + 4 + 4 + 4)
        link = p * (4 + 4 + 4 * k + 1)
        lanes = (p * (4 * k + 4) + link + 4 * cells) \
            + (p * (4 * k + 1) + link) if branch == "slow" else 0
        return sorted_in + lanes + 6 * 4 + p * 4


# ---------------------------------------------------------------------------
# Phase 3b: the raw-table kernel layer (kernels/ops.py, llsc_commit).
# ---------------------------------------------------------------------------

def np_hash(keys, m):
    """`ops.hash_keys` in numpy uint32 arithmetic (its oracle)."""
    h = np.zeros(keys.shape[0], np.uint32)
    for j in range(keys.shape[1]):
        h = (h ^ keys[:, j]) * np.uint32(0x9E3779B1)
        h = h ^ (h >> np.uint32(15))
    return (h % np.uint32(m)).astype(np.int32)


def ref_find(ref, find_args):
    """The find's plain version on the path's operands."""
    return ref.cachehash_find_ref(*find_args, kw=KW, vw=VW,
                                  max_chain=MAX_CHAIN)


def find_walk(cells, pool, qk):
    """The find's walk in numpy: (distinct buckets, distinct chain nodes
    read, chain steps in all, the most steps of a lane), for the bound
    and the report."""
    bidx = np_hash(qk, cells.shape[0])
    row = cells[bidx]
    hit = (row[:, KW + VW + 1] == FULL) & (row[:, :KW] == qk).all(1)
    cur = row[:, KW + VW].view(np.int32).copy()
    walking = (row[:, KW + VW + 1] == FULL) & ~hit & (cur >= 0)
    read, most = [], 0
    for step in range(MAX_CHAIN):
        lanes = np.flatnonzero(walking)
        if not lanes.size:
            break
        most = step + 1
        node = np.minimum(cur[lanes], len(pool) - 1)
        read.append(node)
        rows = pool[node]
        nxt = rows[:, KW + VW].view(np.int32)
        stop = (rows[:, :KW] == qk[lanes]).all(1) | (nxt < 0)
        cur[lanes] = nxt
        walking[lanes[stop]] = False
    read = np.concatenate(read) if read else np.zeros(0, np.int64)
    return (len(np.unique(bidx)), len(np.unique(read)), len(read), most)


def longest_segment(torch, slot, n):
    """The most lanes on one cell among the lanes with a slot in [0, n)."""
    live = slot[(slot >= 0) & (slot < n)]
    return int(torch.unique(live, return_counts=True)[1].max()) \
        if live.numel() else 0


def clone(tensors):
    """A copy of a tuple (or named tuple) of tensors."""
    copies = [x.clone() for x in tensors]
    return (type(tensors)(*copies) if hasattr(tensors, "_fields")
            else tuple(copies))


def seg_rank(sorted_ids):
    """Each entry's rank among the equal ids before it (ids sorted)."""
    idx = np.arange(len(sorted_ids))
    start = np.r_[True, sorted_ids[1:] != sorted_ids[:-1]]
    return (idx - np.maximum.accumulate(np.where(start, idx, 0))).astype(
        np.int32)


def update_batch(rng, p, n, k, slots, current, update_frac=1.0, chain=0.0):
    """A STORE/CAS batch as the reference's `random_batch` (LOAD lanes where
    update_frac < 1), half the comparands current and a share `chain` of
    the lanes expecting the row the lane before on their cell wrote; sorted
    by slot, with each op's round (its rank on its cell).  slots: uniform,
    zipf (Zipf 0.99, as bench_atomics) or hot (one cell)."""
    if slots == "zipf":
        slot = (rng.zipf(1.01, p) - 1) % n
    elif slots == "hot":
        slot = np.full(p, rng.integers(0, n))
    else:
        slot = rng.integers(0, n, p)
    kind = np.where(rng.random(p) < 0.5, CAS, STORE).astype(np.int32)
    if update_frac < 1.0:
        kind[rng.random(p) >= update_frac] = 0
    desired = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
    use_cur = rng.random(p) < 0.5
    expected = np.where(use_cur[:, None], current[slot], expected)
    order = np.argsort(slot, kind="stable")
    s_slot = slot[order].astype(np.int32)
    kind, expected, desired = kind[order], expected[order], desired[order]
    if chain:
        follow = np.flatnonzero((rng.random(p - 1) < chain)
                                & (s_slot[1:] == s_slot[:-1])) + 1
        expected[follow] = desired[follow - 1]
    return (kind, s_slot, expected, desired), seg_rank(s_slot)


def rounds_loop(tk, data, meta, slot, kind, expected, desired, rounds,
                upd_rank):
    """`ops.bigatomic_update_rounds` as it was before `cas_apply_rounds`:
    the `cas_apply_round` kernel once per round, as the reference drives its
    Pallas kernel; timed here beside the one-launch kernel."""
    import torch
    n1 = data.shape[0]
    p, k = expected.shape
    success = torch.zeros((p,), dtype=torch.int32, device=data.device)
    witness = torch.zeros((p, k), dtype=data.dtype, device=data.device)
    for t in range(rounds):
        live = upd_rank == t
        data, meta, succ, wit = tk.cas_apply_round(
            data, meta, torch.where(live, slot, n1 - 1),
            torch.where(live, kind, 0), expected, desired)
        success = torch.where(live, succ[:, 0], success)
        witness = torch.where(live[:, None], wit, witness)
    return data, meta, success, witness


def build_cachehash(rng, m, n_keys):
    """A CacheHash table of `n_keys` distinct 2-word keys placed by the
    hash: a bucket's first key inline in `cells`, the rest chained in
    `chain_pool` (at most MAX_CHAIN deep; deeper keys are left out).
    Returns (cells, chain_pool, placed keys as uint64, their values, their
    chain depth (0 = inline), every key drawn as uint64)."""
    cw = KW + VW + 3                     # [key | value | next | flags | ver]
    drawn = np.unique(rng.integers(1, 2 ** 64, int(n_keys * 1.01),
                                   dtype=np.uint64))
    drawn = drawn[rng.permutation(len(drawn))[:n_keys]]
    keys = drawn.view(np.uint32).reshape(-1, KW)
    vals = rng.integers(0, 2 ** 32, (len(keys), VW), dtype=np.uint32)
    bucket = np_hash(keys, m)
    order = np.argsort(bucket, kind="stable")
    k64, vals, bucket = drawn[order], vals[order], bucket[order]
    depth = seg_rank(bucket)
    keep = depth <= MAX_CHAIN
    k64, vals, bucket, depth = k64[keep], vals[keep], bucket[keep], \
        depth[keep]
    rows = np.zeros((len(k64), cw), np.uint32)
    rows[:, :KW] = k64.view(np.uint32).reshape(-1, KW)
    rows[:, KW:KW + VW] = vals
    rows[:, KW + VW + 1] = FULL
    chained = depth > 0
    node = np.cumsum(chained) - 1                     # chain-pool index
    has_next = np.r_[bucket[1:] == bucket[:-1], False]
    rows[:, KW + VW] = np.where(has_next, np.r_[node[1:], 0], NEXT_END)
    cells = np.zeros((m, cw), np.uint32)
    cells[bucket[~chained]] = rows[~chained]
    return cells, rows[chained], k64, vals, depth, drawn


class TableOps:
    """Phase 3b: the raw-table layer's kernels against their plain
    versions, its entry points at full width against numpy oracles, and
    their times."""

    def __init__(self, smoke, tk, ops, llsc, ref):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        self.tk, self.ops, self.llsc, self.ref = tk, ops, llsc, ref
        self.w = smoke.words

    def ints(self, arr):
        return self.s.convert.tensor(np.asarray(arr, np.int32), self.dev)

    def fail(self, what):
        raise SystemExit(f"table ops: {what}")

    def same(self, what, got, want):
        """Exact equality of a port result (words as uint32) and numpy."""
        if isinstance(got, self.torch.Tensor):
            word = got.dtype == self.torch.int32 and want.dtype == np.uint32
            got = self.s.convert.array(got, word=word)
        if got.shape != want.shape or not np.array_equal(got, want):
            self.fail(f"{what} differs from the numpy oracle")

    # -- inputs ----------------------------------------------------------------

    @staticmethod
    def table(rng, n1, k, locked=0.05, marked=0.05):
        """data[n1, k] and meta[n1, 2]: even versions, a share odd (locked),
        a share of rows marked, and row 0's version about to wrap."""
        data = rng.integers(0, 2 ** 32, (n1, k), dtype=np.uint32)
        meta = np.zeros((n1, 2), np.uint32)
        meta[:, 0] = (rng.integers(0, 2 ** 30, n1) * 2
                      + (rng.random(n1) < locked)).astype(np.uint32)
        meta[:, 1] = rng.random(n1) < marked
        meta[0, 0] = 2 ** 32 - 2
        return data, meta

    @staticmethod
    def lanes(rng, n, p, live_frac=0.9):
        """Distinct real slots for a share of p lanes, the dummy row n for
        the rest, interleaved."""
        n_real = min(int(p * live_frac), n)
        slot = np.full(p, n, np.int32)
        slot[:n_real] = rng.choice(n, n_real, replace=False)
        perm = rng.permutation(p)
        return slot[perm], (np.arange(p) < n_real)[perm]

    def cas_lanes(self, rng, data, n, k, p):
        slot, real = self.lanes(rng, n, p)
        kind = np.where(real, rng.choice([STORE, CAS], p), 0).astype(np.int32)
        kind[real & (rng.random(p) < 0.1)] = 0       # read-and-fail lanes
        expected = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        take = rng.random(p) < 0.5
        expected[take] = data[slot[take]]
        return (slot, kind, expected,
                rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))

    def llsc_lanes(self, rng, meta, n, k, p):
        slot, real = self.lanes(rng, n, p)
        cur = meta[slot, 0]
        link = np.where(rng.random(p) < 0.5, cur, cur + np.uint32(2))
        return (slot, real.astype(np.int32), link.astype(np.uint32),
                rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))

    @staticmethod
    def probe_inputs(rng, m, kw, vw, q):
        cw = kw + vw + 3
        cells = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
        cells[:, kw + vw] = np.where(rng.random(m) < 0.5, NEXT_END,
                                     rng.integers(0, 64, m))
        cells[:, kw + vw + 1] = np.where(rng.random(m) < 0.6, FULL,
                                         rng.choice([0, 2], m))
        bidx = rng.integers(0, m, q).astype(np.int32)
        keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
        take = rng.random(q) < 0.5
        keys[take] = cells[bidx[take], :kw]
        return cells, bidx, keys

    @staticmethod
    def chain_inputs(rng, m, kw, vw, q):
        """A bucket array, a chain pool of m nodes and q queries for the find:
        buckets full (80 %) or empty with flags 0 or 2, nodes whose next
        ends the chain, links to a random node (cycles included) or points
        past the pool's end; a third of the queries inline in their hashed
        bucket, a third placed 1 to 14 steps down its chain, the rest
        absent."""
        cw = kw + vw + 3
        cells = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
        cells[:, kw + vw] = np.where(rng.random(m) < 0.3, NEXT_END,
                                     rng.integers(0, m, m))
        cells[:, kw + vw + 1] = np.where(rng.random(m) < 0.8, FULL,
                                         rng.choice([0, 2], m))
        pool = rng.integers(0, 2 ** 32, (m, cw), dtype=np.uint32)
        pool[:, kw + vw] = rng.choice(
            np.array([NEXT_END, 0, m, m + 9], np.uint32), m,
            p=[0.08, 0.8, 0.06, 0.06])
        link = pool[:, kw + vw] == 0
        pool[link, kw + vw] = rng.integers(0, m, int(link.sum()))
        keys = rng.integers(0, 2 ** 32, (q, kw), dtype=np.uint32)
        bucket = np_hash(keys, m)
        for i in range(q):
            b, place = bucket[i], i % 3
            if place == 0:
                cells[b, :kw], cells[b, kw + vw + 1] = keys[i], FULL
            elif place == 1 and cells[b, kw + vw] != NEXT_END:
                cur = int(cells[b, kw + vw])
                for _ in range(int(rng.integers(0, 14))):
                    nxt = pool[min(cur, m - 1), kw + vw]
                    if nxt == NEXT_END:
                        break
                    cur = int(nxt)
                pool[min(cur, m - 1), :kw] = keys[i]
        return cells, pool, keys

    # -- kernels against their plain versions -----------------------------------

    def shifted(self, t, off):
        """A copy of t on the card starting `off` words past a 16-byte
        boundary."""
        buf = self.torch.empty(t.numel() + 4, dtype=t.dtype, device=self.dev)
        out = buf[off:off + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    def kernel_vs_plain(self):
        """Bit for bit on every output and on the updated tables: k = 1, 3,
        4, 5, 16 at q = p = 1003 (not a multiple of 8), locked / marked /
        wrapping rows, dead lanes on row n and out of range, three CacheHash
        layouts, and the full-width shapes; the gather also at k = 2 and 8,
        and at k = 4 and 16 with data and meta one word off 16 bytes (its
        word path); the find on five layouts at max_chain 8, 0 and 40
        (cycles, nexts past the pool's end).
        Returns the case count."""
        tk, ref, w, ints = self.tk, self.ref, self.w, self.ints
        rng = np.random.default_rng(2000)
        cases = 0
        for n, k, p in [(4096, k, 1003) for k in (1, 3, 4, 5, 16)] + \
                [(N, K, P)]:
            data, meta = self.table(rng, n + 1, k)
            d, m = w(data), w(meta)
            idx = rng.integers(0, n, p).astype(np.int32)
            idx[:2] = [-1, n + 1]                     # dead lanes
            self.s.compare("seqlock_gather", tk.seqlock_gather(d, m, ints(idx)),
                           ref.seqlock_gather_ref(d, m, ints(idx)))
            for name, lanes, kern, plain in (
                    ("cas_apply_round", self.cas_lanes(rng, data, n, k, p),
                     tk.cas_apply_round, ref.cas_apply_round_ref),
                    ("llsc_commit_round", self.llsc_lanes(rng, meta, n, k, p),
                     tk.llsc_commit_round, ref.llsc_commit_round_ref)):
                args = (ints(lanes[0]), ints(lanes[1]), w(lanes[2]),
                        w(lanes[3]))
                got = kern(d.clone(), m.clone(), *args)
                want = plain(d.clone(), m.clone(), *args)
                self.s.compare(name, got, want)
            cases += 3
        for k, off in ((2, 0), (8, 0), (4, 1), (16, 1)):
            data, meta = self.table(rng, 4097, k)
            d, m = (self.shifted(w(a), off) for a in (data, meta))
            idx = rng.integers(0, 4096, 1003).astype(np.int32)
            idx[:2] = [-1, 4097]
            self.s.compare("seqlock_gather", tk.seqlock_gather(d, m, ints(idx)),
                           ref.seqlock_gather_ref(d, m, ints(idx)))
            cases += 1
        for m_, kw, vw, q in [(4096, 1, 1, 1003), (4096, 2, 2, 1003),
                              (4096, 4, 2, 1003), (M, KW, VW, P)]:
            cells, bidx, keys = self.probe_inputs(rng, m_, kw, vw, q)
            args = (w(cells), ints(bidx), w(keys))
            self.s.compare("cachehash_probe",
                           tk.cachehash_probe(*args, kw=kw, vw=vw),
                           ref.cachehash_probe_ref(*args, kw=kw, vw=vw))
            cases += 1
        # the find at the shapes it is instantiated for and one it runs at
        # run-time widths (3 / 1); the full width is held in main_path
        for kw, vw in [(1, 1), (2, 2), (4, 2), (1, 3), (3, 1)]:
            args = tuple(map(w, self.chain_inputs(rng, 4099, kw, vw, 1003)))
            for max_chain in (MAX_CHAIN, 0, 40):
                self.s.compare(
                    "cachehash_find",
                    tk.cachehash_find(*args, kw=kw, vw=vw,
                                      max_chain=max_chain),
                    ref.cachehash_find_ref(*args, kw=kw, vw=vw,
                                           max_chain=max_chain))
            cases += 1
        self.torch.cuda.synchronize()
        return cases

    # (n, k, p, slots, update_frac, chain, share of the rounds run,
    #  negative ranks)
    ROUNDS_CASES = [(4096, k, 1003, "zipf", 0.8, 0.3, 1.0, False)
                    for k in (1, 3, 4, 5, 16)] + [
        (4096, 3, 1003, "hot", 0.9, 0.3, 0.6, False),
        (4096, 5, 1003, "zipf", 1.0, 0.3, 1.0, True),
        (N, K, P, "uniform", 1.0, 0.0, 1.0, False),
        (N, K, P, "zipf", 1.0, 0.0, 1.0, False),
        (N, K, P, "hot", 1.0, 0.3, 1.0, False),
        (N, K, P, "zipf", 0.8, 0.3, 1.0, False),
        (N, K, P, "zipf", 1.0, 0.3, 0.7, False)]

    def rounds_vs_plain(self):
        """`cas_apply_rounds` against its plain version (the round loop),
        bit for bit on success, witness, table and meta: k = 1, 3, 4, 5, 16
        at p = 1003 (Zipf, LOAD lanes, CAS lanes expecting an earlier
        lane's row), truncated rounds, negative ranks, and at full width
        uniform, Zipf 0.99, one hot cell, LOAD lanes and truncated rounds.
        Returns each case's (name, longest segment, rounds)."""
        tk, ref, w, ints = self.tk, self.ref, self.w, self.ints
        rng = np.random.default_rng(2500)
        out = []
        for n, k, p, slots, frac, chain, share, neg in self.ROUNDS_CASES:
            data, meta = self.table(rng, n + 1, k)
            batch, rank = update_batch(rng, p, n, k, slots, data[:n], frac,
                                       chain)
            longest = int(rank.max()) + 1
            rounds = max(1, int(longest * share))
            if neg:
                rank[rng.random(p) < 0.2] = -1
            kind, slot, expected, desired = batch
            args = (ints(slot), ints(kind), w(expected), w(desired), rounds,
                    ints(rank))
            d, m = w(data), w(meta)
            got = tk.cas_apply_rounds(d.clone(), m.clone(), *args)
            want = ref.cas_apply_rounds_ref(d.clone(), m.clone(), *args)
            self.s.compare("cas_apply_rounds", got, want)
            out.append((f"n={n} k={k} {slots} u={frac} chain={chain}"
                         + (" neg" if neg else ""), longest, rounds))
        self.torch.cuda.synchronize()
        return out

    # -- the path through the ops layer ------------------------------------------

    def main_path(self, atomics, engine, convert):
        """Drive the layer's entry points once at full width, with the
        launch counts reset just before; check each against numpy.
        Returns the launch counts, the branch the engine round took under
        `commit_round`, and the operands for the timing: each call's
        inputs, with a copy (`pre_*`) of each table or state as it was
        before the call that updated it."""
        torch, tk, ops, llsc, w, ints = (self.torch, self.tk, self.ops,
                                         self.llsc, self.w, self.ints)
        rng = np.random.default_rng(3000)
        n, k, p = N, K, P
        data, meta = self.table(rng, n + 1, k)
        d, m = convert.raw_table(data, meta, self.dev)
        op = {}
        torch.cuda.synchronize()
        tk.reset_launch_counts()

        # bigatomic_load: uniform slots over locked and marked rows
        idx = rng.integers(0, n, p).astype(np.int32)
        op["idx"] = ints(idx)
        vals, ok = ops.bigatomic_load(d, m, op["idx"])
        self.same("bigatomic_load values", vals, data[idx])
        self.same("bigatomic_load ok", ok, (meta[idx, 0] % 2 == 0)
                  & (meta[idx, 1] == 0))

        # bigatomic_update_rounds: uniform, Zipf 0.99 and one hot cell; one
        # cas_apply_rounds launch per call, whatever the rounds
        ctx0 = (np.full(p, -1, np.int32), np.zeros(p, np.uint32),
                np.zeros((p, k), np.uint32), np.zeros(p, bool))
        op["rounds"] = {}
        for name in ("uniform", "zipf099", "hot"):
            slots = "zipf" if name == "zipf099" else name
            batch, rank = update_batch(rng, p, n, k, slots, data[:n])
            rounds = int(rank.max()) + 1
            kind, slot, expected, desired = batch
            args = (ints(slot), ints(kind), w(expected), w(desired), rounds,
                    ints(rank))
            op["pre_update_" + name] = (d.clone(), m.clone())
            before = tk.cas_apply_rounds.launches
            _, _, succ, wit = ops.bigatomic_update_rounds(d, m, *args)
            if tk.cas_apply_rounds.launches - before != 1:
                self.fail(f"update rounds ({name}): "
                          f"{tk.cas_apply_rounds.launches - before} "
                          "cas_apply_rounds launches, expected 1")
            new_data, new_ver, _, res = engine.apply_ops_reference(
                data[:n], meta[:n, 0], ctx0, batch)
            data[:n], meta[:n, 0] = new_data, new_ver
            self.same(f"update rounds ({name}) success", succ,
                      res.success.astype(np.int32))
            self.same(f"update rounds ({name}) witness", wit, res.value)
            self.same(f"update rounds ({name}) table", d, data)
            self.same(f"update rounds ({name}) meta", m, meta)
            op["update_" + name] = args
            op["rounds"][name] = rounds       # = the longest segment
            if name == "uniform":                  # round 0, for the kernel
                live = rank == 0
                op["cas_round0"] = (
                    ints(np.where(live, slot, n)),
                    ints(np.where(live, kind, 0)), w(expected), w(desired))

        # llsc_commit_round: distinct live slots, half the links stale
        slot, live, link, desired = self.llsc_lanes(rng, meta, n, k, p)
        op["llsc"] = (ints(slot), ints(live), w(link), w(desired))
        op["pre_llsc"] = (d.clone(), m.clone())
        _, _, succ, wit = tk.llsc_commit_round(d, m, *op["llsc"])
        win = live.astype(bool) & (meta[slot, 0] == link)
        self.same("llsc_commit_round witness", wit, data[slot])
        data[slot[win]] = desired[win]
        meta[slot[win], 0] += np.uint32(2)
        self.same("llsc_commit_round success", succ,
                  win.astype(np.int32)[:, None])
        self.same("llsc_commit_round table", d, data)
        self.same("llsc_commit_round meta", m, meta)
        if not 0.3 < win.mean() < 0.6:
            self.fail(f"llsc_commit_round: {win.mean():.2f} of lanes won")

        # commit_round on cached_me: LL, a STORE to some linked cells, SC
        spec = atomics.AtomicSpec(n, k, "cached_me", p_max=p)
        initial = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
        state = atomics.init(spec, initial, device=self.dev)
        ctx = atomics.init_ctx(p, k, device=self.dev)
        cells_ll = rng.choice(n, p, replace=False).astype(np.int32)
        zeros = np.zeros((p, k), np.uint32)
        batches = [
            (np.full(p, engine.LL, np.int32), cells_ll, zeros, zeros),
            (np.where(rng.random(p) < 0.25, STORE, engine.IDLE).astype(
                np.int32), cells_ll, zeros,
             rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32))]
        for batch in batches:
            state, ctx, *_ = atomics.apply(
                spec, state, convert.op_batch(batch, self.dev), ctx,
                donate=True)
        sc_slots = np.where(rng.random(p) < 0.9, cells_ll, n).astype(np.int32)
        sc_des = rng.integers(0, 2 ** 32, (p, k), dtype=np.uint32)
        op["commit"] = (spec, ints(sc_slots), w(sc_des))
        op["pre_commit"] = (clone(state), clone(ctx))
        state, ctx, succ, wit = llsc.commit_round(
            spec, state, ctx, *op["commit"][1:], donate=True)
        # the branch the engine round took: its predicate on the batch
        fast_in_commit = self.s.branch(engine.OpBatch(
            torch.where(op["commit"][1] < n, engine.SC, engine.IDLE).to(
                torch.int32), op["commit"][1], op["commit"][2],
            op["commit"][2]))
        o_data, o_ver, o_ctx = initial, np.zeros(n, np.uint32), ctx0
        batches.append((np.where(sc_slots < n, engine.SC, engine.IDLE).astype(
            np.int32), sc_slots, zeros, sc_des))
        for batch in batches:
            o_data, o_ver, o_ctx, o_res = engine.apply_ops_reference(
                o_data, o_ver, o_ctx, batch)
        self.same("commit_round success", succ, o_res.success)
        self.same("commit_round witness", wit, o_res.value)
        self.same("commit_round logical", atomics.logical(spec, state),
                  o_data)
        self.same("commit_round versions", state.version, o_ver)
        for f, got, want in zip(engine.LinkCtx._fields, ctx, o_ctx):
            self.same(f"commit_round ctx.{f}", got, np.asarray(want))
        op["commit_wins"] = float(o_res.success.mean())

        # cachehash_find: 2**21 keys in 2**22 buckets; a third of the
        # queries inline hits, a third chain hits, a third absent
        t0 = time.perf_counter()
        cells, pool, k64, vals, depth, drawn = build_cachehash(rng, M, M // 2)
        third = p // 3
        absent = rng.integers(1, 2 ** 64, 2 * third, dtype=np.uint64)
        absent = absent[~np.isin(absent, drawn)][:p - 2 * third]
        q64 = np.concatenate([rng.choice(k64[depth == 0], third),
                              rng.choice(k64[depth > 0], third), absent])
        q64 = q64[rng.permutation(p)]
        qk = q64.view(np.uint32).reshape(-1, KW)
        op["build_cachehash_s"] = time.perf_counter() - t0
        op["max_depth"] = int(depth.max())
        cells_t, pool_t = convert.cachehash_tables(cells, pool, self.dev)
        op["find"] = (cells_t, pool_t, w(qk))
        bidx = np_hash(qk, M)
        self.same("hash_keys", ops.hash_keys(op["find"][2], M), bidx)
        before = tk.cachehash_find.launches
        found, val = ops.cachehash_find(*op["find"], kw=KW, vw=VW,
                                        max_chain=MAX_CHAIN)
        if tk.cachehash_find.launches - before != 1:
            self.fail(f"cachehash_find: {tk.cachehash_find.launches - before}"
                      " find kernel launches, expected 1")
        sorted_k = np.argsort(k64)
        pos = np.minimum(np.searchsorted(k64[sorted_k], q64), len(k64) - 1)
        hit = k64[sorted_k][pos] == q64
        want = np.where(hit[:, None], vals[sorted_k][pos],
                        cells[bidx, KW:KW + VW])
        self.same("cachehash_find found", found, hit)
        self.same("cachehash_find value", val, want)
        op["probe"] = (cells_t, ints(bidx), op["find"][2])
        op["find_mix"] = [int(hit.sum()), int((~hit).sum())]
        op["find_walk"] = find_walk(cells, pool, qk)

        torch.cuda.synchronize()
        counts = tk.launch_counts()
        for name in TABLE_PATH_KERNELS:
            if counts[name] <= 0:
                self.fail(f"{name} never launched on the table-ops path")
        if counts["cas_apply_round"] != 0:
            self.fail("bigatomic_update_rounds launched cas_apply_round")
        if counts["cachehash_probe"] != 0:
            self.fail("cachehash_find launched the bare probe")
        if fast_in_commit != "fast":
            self.fail("commit_round did not take the fast branch")
        # the find kernel at full width against its plain version (after
        # the counts: a comparison is not the path)
        self.s.compare("cachehash_find",
                       tk.cachehash_find(*op["find"], kw=KW, vw=VW,
                                         max_chain=MAX_CHAIN),
                       ref_find(self.ref, op["find"]))
        return counts, fast_in_commit, op

    # -- timing ------------------------------------------------------------------

    def timing(self, op):
        """Median ms of each entry point (CUDA events, launch included) and
        its device-busy share; each kernel's device time, its plain
        version's time and its bound in bytes.  Every call that updates its
        table, and every kernel rep, runs on a fresh copy of the table (or
        state and links) that the checked call saw, so each rep does the
        checked call's work."""
        torch, tk, ops, llsc, ref = (self.torch, self.tk, self.ops, self.llsc,
                                     self.ref)
        s = self.s

        def fresh(key):
            return lambda: clone(op[key])

        d0, m0 = op["pre_update_uniform"]         # the table the load read
        spec, sc_slots, sc_des = op["commit"]
        entry = {
            "bigatomic_load": (
                lambda: ops.bigatomic_load(d0, m0, op["idx"]), None),
            "bigatomic_update_rounds_uniform": (
                lambda d, m: ops.bigatomic_update_rounds(
                    d, m, *op["update_uniform"]),
                fresh("pre_update_uniform")),
            "bigatomic_update_rounds_zipf099": (
                lambda d, m: ops.bigatomic_update_rounds(
                    d, m, *op["update_zipf099"]),
                fresh("pre_update_zipf099")),
            "bigatomic_update_rounds_hot": (
                lambda d, m: ops.bigatomic_update_rounds(
                    d, m, *op["update_hot"]),
                fresh("pre_update_hot")),
            "llsc_commit_round": (
                lambda d, m: tk.llsc_commit_round(d, m, *op["llsc"]),
                fresh("pre_llsc")),
            "commit_round": (
                lambda state, ctx: llsc.commit_round(
                    spec, state, ctx, sc_slots, sc_des, donate=True),
                lambda: tuple(map(clone, op["pre_commit"]))),
            "cachehash_find": (
                lambda: ops.cachehash_find(*op["find"], kw=KW, vw=VW,
                                           max_chain=MAX_CHAIN), None),
        }
        entries = {}
        for name, (fn, setup) in entry.items():
            def run(*args, fn=fn):
                fn(*args)
                torch.cuda.synchronize()
            entries[name] = {"ms": s.time_ms(fn, setup=setup),
                             "profile": s.device_busy(run, setup=setup,
                                                      tries=3)}
        # a find is one launch of the find kernel and nothing else
        find_ops = entries["cachehash_find"]["profile"].get(
            "device_ops_per_apply")
        if find_ops != 1:
            self.fail(f"a cachehash_find call made {find_ops} device "
                      "operations, expected 1")
        # `bigatomic_update_rounds` as it was (a launch per round), for the
        # comparison in this run; the hot cell's 16384 rounds once
        for name, reps in (("uniform", 20), ("zipf099", 5), ("hot", 1)):
            entries["rounds_loop_" + name] = {"ms": s.time_ms(
                lambda d, m, a=op["update_" + name]: rounds_loop(
                    tk, d, m, *a), reps=reps, warmup=1,
                setup=fresh("pre_update_" + name))}
        # every kernel rep, read-only ones too, gets its own copy of the
        # table: rows left in L2 by the rep before would halve its time
        kernels = {
            "seqlock_gather": (
                lambda d, m: tk.seqlock_gather(d, m, op["idx"]),
                lambda d, m: ref.seqlock_gather_ref(d, m, op["idx"]),
                fresh("pre_update_uniform"), 5),
            "cas_apply_round": (
                lambda d, m: tk.cas_apply_round(d, m, *op["cas_round0"]),
                lambda d, m: ref.cas_apply_round_ref(d, m, *op["cas_round0"]),
                fresh("pre_update_uniform"), 5),
            "llsc_commit_round": (
                lambda d, m: tk.llsc_commit_round(d, m, *op["llsc"]),
                lambda d, m: ref.llsc_commit_round_ref(d, m, *op["llsc"]),
                fresh("pre_llsc"), 5),
            "cachehash_probe": (
                lambda cells: tk.cachehash_probe(cells, *op["probe"][1:],
                                                 kw=KW, vw=VW),
                lambda cells: ref.cachehash_probe_ref(cells, *op["probe"][1:],
                                                      kw=KW, vw=VW),
                lambda: (op["probe"][0].clone(),), 5),
            "cachehash_find": (
                lambda pool, cells: tk.cachehash_find(
                    cells, pool, op["find"][2], kw=KW, vw=VW,
                    max_chain=MAX_CHAIN),
                lambda pool, cells: ref_find(ref, (cells, pool,
                                                   op["find"][2])),
                lambda: (op["find"][1].clone(), op["find"][0].clone()), 5),
        }
        for key, name, reps in (("zipf099", "cas_apply_rounds", 5),
                                ("uniform", "cas_apply_rounds_uniform", 5),
                                ("hot", "cas_apply_rounds_hot", 1)):
            kernels[name] = (
                lambda d, m, a=op["update_" + key]: tk.cas_apply_rounds(
                    d, m, *a),
                lambda d, m, a=op["update_" + key]: ref.cas_apply_rounds_ref(
                    d, m, *a),
                fresh("pre_update_" + key), reps)
        rows = {}
        for name, (fn, plain, setup, reps) in kernels.items():
            nbytes, written = self.kernel_bytes(name, op)
            rows[name] = {
                "ms": s.device_ms(fn, setup=setup),
                "with_launch_ms": s.time_ms(fn, setup=setup),
                "plain_ms": s.time_ms(plain, reps=reps, warmup=1, setup=setup),
                "bytes": nbytes, "written_rows": written,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        idx64 = op["idx"].to(torch.int64)
        rows["seqlock_gather"]["index_select_ms"] = s.device_ms(
            lambda d, m: d.index_select(0, idx64),
            setup=fresh("pre_update_uniform"))
        return entries, rows

    def kernel_bytes(self, name, op):
        """Bytes the kernel must move on the timed inputs, and the rows it
        writes: each lane operand read once and each output written once;
        each distinct row it reads (data words, and the meta words it
        reads) once; each row it writes (data and version) once."""
        torch, tk = self.torch, self.tk
        k = op["pre_llsc"][0].shape[1]

        def distinct(idx):
            return int(torch.unique(idx).numel())

        if name == "seqlock_gather":
            q = op["idx"].shape[0]
            return (q * 4 + distinct(op["idx"]) * (4 * k + 8)
                    + q * (4 * k + 4)), 0
        if name == "cachehash_probe":
            cells, bidx, _ = op["probe"]
            q = bidx.shape[0]
            return (q * (4 + 4 * KW) + q * (12 + 4 * VW)
                    + distinct(bidx) * 4 * (KW + VW + 2)), 0
        if name == "cachehash_find":
            # the query words; found (a byte) and the value; each bucket
            # row probed (key, value, next, flags) and each chain node
            # read (key, value, next) once
            q = op["find"][2].shape[0]
            buckets, nodes = op["find_walk"][:2]
            return (q * 4 * KW + q * (1 + 4 * VW)
                    + buckets * 4 * (KW + VW + 2)
                    + nodes * 4 * (KW + VW + 1)), 0
        if name.startswith("cas_apply_rounds"):
            key = {"cas_apply_rounds": "zipf099"}.get(
                name, name.rsplit("_", 1)[-1])
            args, table = op["update_" + key], op["pre_update_" + key]
            slot, rounds, rank = args[0], args[4], args[5]
            p = slot.shape[0]
            d, m = clone(table)
            tk.cas_apply_rounds(d, m, *args)
            written = int(((d != table[0]).any(1) | (m != table[1]).any(1))
                          .sum())
            live = (rank >= 0) & (rank < rounds)
            # slot, kind, rank, expected, desired; success, witness; each
            # row a live lane reads (data and version) once; each row written
            return (p * (12 + 8 * k) + p * (4 + 4 * k)
                    + distinct(slot[live]) * (4 * k + 4)
                    + written * (4 * k + 4)), written
        if name == "cas_apply_round":
            args, table = op["cas_round0"], op["pre_update_uniform"]
        else:
            args, table = op["llsc"], op["pre_llsc"]
        p = args[0].shape[0]
        succ = getattr(tk, name)(*clone(table), *args)[2]
        written = int(succ.sum())
        if name == "cas_apply_round":   # slot, kind, expected, desired
            return (p * (8 + 8 * k) + p * (4 + 4 * k)
                    + distinct(args[0]) * 4 * k
                    + written * (4 * k + 8)), written
        return (p * (12 + 4 * k) + p * (4 + 4 * k)   # slot, live, link, des.
                + distinct(args[0]) * (4 * k + 4)
                + written * (4 * k + 4)), written


# ---------------------------------------------------------------------------
# Phase 5: the integrity-scrub path (guard, runtime.LocalTarget).
# ---------------------------------------------------------------------------

def np_digest(logical, versions):
    """The FNV-1a cell digest in numpy uint32 arithmetic (its oracle)."""
    h = np.full(versions.shape, 2166136261, np.uint32)
    with np.errstate(over="ignore"):
        for j in range(logical.shape[1]):
            h = (h ^ logical[:, j]) * np.uint32(16777619)
        return (h ^ versions) * np.uint32(16777619)


class GuardPhase:
    """Phase 5: the digest kernel against its plain version and numpy, then
    per layout the scrub path at n = 2**22 (checkpoint, a STORE batch,
    baseline, 64 seeded faults, `Scrubber.scrub`, `mask_ops`, a second
    scrub), each step checked; then its times."""

    def __init__(self, smoke, guard, inject, runtime, digest):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        self.guard, self.inject = guard, inject
        self.runtime, self.digest = runtime, digest

    def fail(self, what):
        raise SystemExit(f"guard: {what}")

    def kernel_vs_plain(self):
        """Bit for bit at k = 1, 3, 4, 5, 16 with n = 1003, and at full
        width against `np_digest` too.  Returns the case count."""
        rng = np.random.default_rng(5000)
        w, dg = self.s.words, self.digest
        cases = 0
        for n, k in [(1003, k) for k in (1, 3, 4, 5, 16)] + [(N, K)]:
            vals = rng.integers(0, 2 ** 32, (n, k), dtype=np.uint32)
            ver = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
            got = dg.digest_rows(w(vals), w(ver))
            self.s.compare("digest_rows", (got,),
                           (dg.digest_rows_plain(w(vals), w(ver)),))
            if n == N and not np.array_equal(self.s.np_words(got),
                                              np_digest(vals, ver)):
                self.fail("digest_rows differs from the numpy oracle")
            cases += 1
        self.torch.cuda.synchronize()
        return cases

    def layout(self, strategy, seed):
        """Drive the scrub path for one layout and check it.  Returns the
        operands of the timing: the spec, the checkpoint, the STORE batch
        and its success, the faulted state and the baseline."""
        s, torch, dev = self.s, self.torch, self.dev
        atomics, convert = s.atomics, s.convert
        Fault = self.runtime.Fault
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        target = self.runtime.LocalTarget(spec, initial, device=dev)
        ctx = atomics.init_ctx(P, K, device=dev)
        batch_a = s.main_batch("a_distinct_all_kinds", rng, initial, None)
        target.issue(s.engine.OpBatch(*batch_a), ctx)
        scrubber = self.guard.Scrubber(spec, device=dev)
        ckpt = target.snapshot()
        scrubber.set_checkpoint(ckpt)
        ckpt_np = {f: s.np_words(x) for f, x in ckpt.items()}

        # a STORE batch to distinct cells
        dirty = rng.choice(N, GUARD_STORES, replace=False).astype(np.int32)
        stores = s.engine.OpBatch(*convert.to_numpy(atomics.stores(
            dirty, rng.integers(0, 2 ** 32, (GUARD_STORES, K),
                                dtype=np.uint32), k=K, device="cpu")))
        store_success = target.issue(stores, None).wait().host_result()[1]
        scrubber.note_results(stores, store_success)
        baseline = scrubber.digest_of(target)
        snap = target.snapshot()
        if not np.array_equal(s.np_words(baseline), np_digest(
                s.np_words(snap["logical"]), s.np_words(snap["versions"]))):
            self.fail(f"{strategy}: baseline digest differs from numpy")

        # faults on distinct cells, half of them dirty
        half = GUARD_FAULTS // 2
        clean = np.setdiff1d(np.arange(N), dirty)
        victims = np.concatenate([rng.choice(dirty, half, replace=False),
                                  rng.choice(clean, half, replace=False)])
        named = {"indirect": ("pointer_range", dict(field="bptr", bit=30)),
                 "cached_wf": ("pointer_range", dict(field="bptr", bit=30)),
                 "cached_me": ("tagged_null", dict(field="version", bit=1))}
        for i, slot in enumerate(victims):
            kind = "bit_flip" if i % 2 == 0 else "torn_write"
            extra = named[strategy][1] if i == 0 and strategy in named \
                else {}
            target.state, _ = self.inject.inject_table_fault(
                spec, target.state, Fault(1, kind, slot=int(slot), **extra),
                np.random.default_rng([seed, i]))
        faulted = clone(target.state)

        report = scrubber.scrub(target, round_idx=1, baseline=baseline)
        dirty_v, clean_v = sorted(victims[:half].tolist()), \
            sorted(victims[half:].tolist())
        if report.detected != sorted(victims.tolist()):
            self.fail(f"{strategy}: detected {len(report.detected)} cells, "
                      f"not exactly the {GUARD_FAULTS} injected")
        if report.repaired != clean_v or report.quarantined != dirty_v:
            self.fail(f"{strategy}: repaired/quarantined are not the clean/"
                      "dirty victims")
        if strategy in named:
            name = named[strategy][0]
            if int(victims[0]) not in report.invariant_violations.get(name,
                                                                      []):
                self.fail(f"{strategy}: {name} does not name the fault")
        snap = target.snapshot()
        logical, versions = (s.np_words(snap["logical"]),
                             s.np_words(snap["versions"]))
        if not (np.array_equal(logical[clean_v], ckpt_np["logical"][clean_v])
                and np.array_equal(versions[clean_v],
                                   ckpt_np["versions"][clean_v])):
            self.fail(f"{strategy}: repaired cells differ from the "
                      "checkpoint")

        # a batch through mask_ops, half its updates aimed at the
        # quarantined cells, against the numpy oracle
        slot = np.concatenate([dirty_v, rng.choice(N, P - half)])
        slot = slot[rng.permutation(P)].astype(np.int32)
        ops = s.update_mix(rng, slot, P, K, logical)
        masked, bad = scrubber.mask_ops(s.engine.OpBatch(*ops))
        want_bad = np.isin(slot, dirty_v) & (ops[0] != 3)
        if bad is None or not np.array_equal(bad, want_bad):
            self.fail(f"{strategy}: mask_ops masked the wrong lanes")
        h = target.issue(masked, None)
        masked_np = (np.where(want_bad, 3, ops[0]).astype(np.int32),
                     *ops[1:])
        ctx0 = (np.full(P, -1, np.int32), np.zeros(P, np.uint32),
                np.zeros((P, K), np.uint32), np.zeros(P, bool))
        o_data, o_ver, _, o_res = s.engine.apply_ops_reference(
            logical, versions, ctx0, masked_np)
        value, success = h.wait().host_result()
        if success[want_bad].any():
            self.fail(f"{strategy}: a poisoned lane reported success")
        if not (np.array_equal(success, o_res.success)
                and np.array_equal(value, o_res.value)):
            self.fail(f"{strategy}: mask_ops batch differs from the oracle")
        snap = target.snapshot()
        if not (np.array_equal(s.np_words(snap["logical"]), o_data)
                and np.array_equal(s.np_words(snap["versions"]), o_ver)):
            self.fail(f"{strategy}: table after the batch differs from the "
                      "oracle")
        scrubber.note_results(masked, success)
        second = scrubber.scrub(target, round_idx=2,
                                baseline=scrubber.digest_of(target))
        if not second.clean or second.poisoned_total != half:
            self.fail(f"{strategy}: the second scrub found "
                      f"{len(second.detected)} new cells")
        torch.cuda.synchronize()
        return {"spec": spec, "ckpt": ckpt, "stores": (stores,
                store_success), "faulted": faulted, "baseline": baseline,
                "report": report.to_json(), "second": second.to_json()}

    def timing(self, op):
        """Median ms (CUDA events) of `cell_digest`, the digest kernel
        alone (device time), its plain version, `check_invariants` and
        `Scrubber.scrub` on a clean table and with the 64 faults, each rep
        on a fresh copy of the state and scrubber the checked run saw."""
        s, torch = self.s, self.torch
        spec, faulted, baseline = op["spec"], op["faulted"], op["baseline"]
        impl = s.atomics.get_strategy(spec.strategy)
        dg, guard = self.digest, self.guard
        vals = impl.logical(faulted).contiguous()
        ver = faulted.version

        def fresh_vals():
            return vals.clone(), ver.clone()

        def fresh_scrub(state):
            def setup():
                target = self.runtime.LocalTarget(spec, device=self.dev)
                target.state = clone(state)
                sc = guard.Scrubber(spec, device=self.dev)
                sc.set_checkpoint(op["ckpt"])
                sc.note_results(*op["stores"])
                return sc, target
            return setup

        def scrub(sc, target):
            sc.scrub(target, round_idx=1, baseline=baseline)

        row = {
            "cell_digest_ms": s.time_ms(lambda: guard.cell_digest(spec,
                                                                  faulted)),
            "digest_kernel_ms": s.device_ms(dg.digest_rows,
                                            setup=fresh_vals),
            "digest_plain_ms": s.time_ms(dg.digest_rows_plain, reps=5,
                                         warmup=1, setup=fresh_vals),
            "check_invariants_ms": s.time_ms(
                lambda: guard.check_invariants(spec, faulted)),
            "scrub_faulted_ms": s.time_ms(scrub, reps=10, warmup=2,
                                          setup=fresh_scrub(faulted)),
        }
        # the clean table: the scrub of the repaired, reloaded state
        sc, target = fresh_scrub(faulted)()
        scrub(sc, target)
        clean_state = clone(target.state)
        clean_base = guard.cell_digest(spec, clean_state)

        def clean_scrub(sc, target):
            sc.scrub(target, round_idx=2, baseline=clean_base)
        row["scrub_clean_ms"] = s.time_ms(clean_scrub, reps=10, warmup=2,
                                          setup=fresh_scrub(clean_state))

        def run(sc, target):
            scrub(sc, target)
            torch.cuda.synchronize()
        row["scrub_faulted_profile"] = s.device_busy(
            run, setup=fresh_scrub(faulted))
        nbytes = vals.numel() * 4 + ver.numel() * 4 + ver.numel() * 4
        row["digest_bytes"] = nbytes
        row["digest_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        return row

    def row_gather(self, layout):
        """Device ms of the whole-table row gather that indirect's
        `logical` and the node-pool invariants run: PyTorch's `table[idx]`
        against `layout.gather_rows`, for N rows of K words, with an
        identity and a random permutation index; the two must agree."""
        s, torch = self.s, self.torch
        gen = torch.Generator(device=self.dev).manual_seed(7100)
        table = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, K), generator=gen,
                              device=self.dev, dtype=torch.int32)
        out = {}
        for name, idx in (("identity", torch.arange(N, device=self.dev)),
                          ("permutation", torch.randperm(
                              N, generator=gen, device=self.dev))):
            if not torch.equal(layout.gather_rows(table, idx), table[idx]):
                self.fail(f"gather_rows differs from table[idx] ({name})")
            out[name] = {
                "index_ms": s.device_ms(lambda: table[idx]),
                "gather_rows_ms": s.device_ms(
                    lambda: layout.gather_rows(table, idx))}
        return out


# ---------------------------------------------------------------------------
# Phase 6: attention (kernels/flash_attention.py).
# ---------------------------------------------------------------------------

# H100 SXM dense peaks of the bf16 and TF32 tensor cores
BF16_FLOPS, TF32_FLOPS = 989e12, 495e12
# bf16: both sides compute in fp32 and round to bf16, so they may differ by
# one bf16 ulp, at most 2^-7 of the value (rtol 1e-2), or by atol 1e-3 near
# 0.  fp32: the summation order differs from the plain version's.
BF16_TOL, FP32_TOL = (1e-3, 1e-2), (1e-4, 1e-4)
WGMMA, TF32X3 = "flash_attention_wgmma", "flash_attention_tf32x3"
# (peak, passes) of an attention case's bound, by dtype, whatever kernel
# ran: the card's fastest route for the type, bf16 on the tensor cores, fp32
# to fp32 accuracy as three TF32 products (3xTF32)
DTYPE_PEAK = {"bfloat16": (BF16_FLOPS, 1), "float32": (TF32_FLOPS, 3)}


class AttnCase(NamedTuple):
    b: int
    tq: int
    tkv: int
    h: int
    kvh: int
    hd: int
    causal: bool
    window: int
    dtype: str
    tol: tuple            # (atol, rtol)
    kernel: str           # the kernel the case must launch


ATTENTION_CASES = {
    "glm4_9b_t4096": AttnCase(1, 4096, 4096, 32, 2, 128, True, 0,
                              "bfloat16", BF16_TOL, WGMMA),
    "mixtral_8x7b_t8192_w4096": AttnCase(1, 8192, 8192, 32, 8, 128, True,
                                         4096, "bfloat16", BF16_TOL, WGMMA),
    "glm4_9b_t1000_fp32": AttnCase(1, 1000, 1000, 32, 2, 128, True, 0,
                                   "float32", FP32_TOL, TF32X3),
    # the window mask and the tiles it skips, held at the fp32 tolerance
    "mixtral_8x7b_t8192_w4096_fp32": AttnCase(1, 8192, 8192, 32, 8, 128,
                                              True, 4096, "float32",
                                              FP32_TOL, TF32X3),
    # the wgmma kernel's other head dims: an encoder (hd 80) and local
    # attention with one kv head (hd 256)
    "hubert_xlarge_t4096": AttnCase(1, 4096, 4096, 16, 16, 80, False, 0,
                                    "bfloat16", BF16_TOL, WGMMA),
    "recurrentgemma_9b_t4096_w2048": AttnCase(1, 4096, 4096, 16, 1, 256,
                                              True, 2048, "bfloat16",
                                              BF16_TOL, WGMMA),
    # mixtral_8x7b's heads at hd 64, the wgmma kernel's single-chunk width
    "hd64_h32_kv8_t4096": AttnCase(1, 4096, 4096, 32, 8, 64, True, 0,
                                   "bfloat16", BF16_TOL, WGMMA),
    # the tiny configs' head dim (d_model 64, 4 heads) at b = 2 and ragged
    # ends, in each dtype: hd 16 reads 48 (bf16) or 16 (fp32) zero columns
    # past hd through TMA's out-of-bounds fill
    "hd16_b2_q1000_kv1200": AttnCase(2, 1000, 1200, 32, 8, 16, True, 0,
                                     "bfloat16", BF16_TOL, WGMMA),
    "hd16_b2_q1000_kv1200_fp32": AttnCase(2, 1000, 1200, 32, 8, 16, True, 0,
                                          "float32", FP32_TOL, TF32X3),
    # head dims the tensor-core kernels run at a padded width W, the
    # columns past hd zeros: hd 100 (W 112; rows of 200 bytes, which no TMA
    # map takes, so the wrapper pads q, k and v to 104); more below
    "hd100_t1000": AttnCase(1, 1000, 1000, 32, 8, 100, True, 0, "bfloat16",
                            BF16_TOL, WGMMA),
    # b = 2 and ends that are no multiple of a tile, one per wgmma head
    # dim: the kernel's ragged-key mask, its store cut-off at tq and the
    # batch coordinate of its TMA maps; tq != tkv in the last two, and in
    # the last one rows 899-999 have no live key (`fill_dead_rows`)
    "glm4_9b_b2_t1000": AttnCase(2, 1000, 1000, 32, 2, 128, True, 0,
                                 "bfloat16", BF16_TOL, WGMMA),
    "hubert_xlarge_b2_q1000_kv1200": AttnCase(2, 1000, 1200, 16, 16, 80,
                                              False, 0, "bfloat16",
                                              BF16_TOL, WGMMA),
    "recurrentgemma_9b_b2_q1000_kv700_w200": AttnCase(
        2, 1000, 700, 16, 1, 256, True, 200, "bfloat16", BF16_TOL, WGMMA),
    # more head dims at a padded width: as they come, at Phi-3-mini's hd 96
    # (W 96), hd 200 (W 224, 64-key tiles), hd 184 (W 192) and fp32 hd 100
    # (W 112); padded by the wrapper to rows of 16 bytes, bf16 hd 7 (to 8,
    # W 16, ragged), hd 50 (56, W 64), hd 129 (136, W 160), hd 250 (256, W
    # 256) and fp32 hd 7 (8, W 16), hd 50 (52, W 64), hd 95 (96, W 96)
    "phi3_mini_t4096": AttnCase(1, 4096, 4096, 32, 32, 96, True, 0,
                                "bfloat16", BF16_TOL, WGMMA),
    "hd7_b2_q1000_kv1200": AttnCase(2, 1000, 1200, 32, 8, 7, True, 0,
                                    "bfloat16", BF16_TOL, WGMMA),
    "hd200_t4096_w2048": AttnCase(1, 4096, 4096, 16, 1, 200, True, 2048,
                                  "bfloat16", BF16_TOL, WGMMA),
    "hd100_t1000_fp32": AttnCase(1, 1000, 1000, 32, 8, 100, True, 0,
                                 "float32", FP32_TOL, TF32X3),
    "hd50_b2_q1000_kv1200_fp32": AttnCase(2, 1000, 1200, 32, 8, 50, True, 0,
                                          "float32", FP32_TOL, TF32X3),
    "hd50_b2_q1000_kv1200": AttnCase(2, 1000, 1200, 32, 8, 50, True, 0,
                                     "bfloat16", BF16_TOL, WGMMA),
    "hd7_b2_q1000_kv1200_fp32": AttnCase(2, 1000, 1200, 32, 8, 7, True, 0,
                                         "float32", FP32_TOL, TF32X3),
    "hd95_t1000_fp32": AttnCase(1, 1000, 1000, 32, 8, 95, True, 0,
                                "float32", FP32_TOL, TF32X3),
    "hd129_t1000": AttnCase(1, 1000, 1000, 32, 8, 129, True, 0, "bfloat16",
                            BF16_TOL, WGMMA),
    "hd184_t1000": AttnCase(1, 1000, 1000, 32, 8, 184, True, 0, "bfloat16",
                            BF16_TOL, WGMMA),
    "hd250_t1000": AttnCase(1, 1000, 1000, 32, 8, 250, True, 0, "bfloat16",
                            BF16_TOL, WGMMA),
    # fp32 past hd 128, where the 3xTF32 kernel's block takes 64 query rows
    # and its two consumers split O by columns: recurrentgemma_9b in fp32
    # (W 256), then one case per new width: hd 129 (padded to 132, W 160),
    # hd 184 (W 192), hd 200 with a window (W 224), hd 250 (252, W 256),
    # and recurrentgemma_9b's ragged b = 2 case with dead rows
    "recurrentgemma_9b_t4096_w2048_fp32": AttnCase(
        1, 4096, 4096, 16, 1, 256, True, 2048, "float32", FP32_TOL, TF32X3),
    "hd129_t1000_fp32": AttnCase(1, 1000, 1000, 32, 8, 129, True, 0,
                                 "float32", FP32_TOL, TF32X3),
    "hd184_t1000_fp32": AttnCase(1, 1000, 1000, 32, 8, 184, True, 0,
                                 "float32", FP32_TOL, TF32X3),
    "hd200_t4096_w2048_fp32": AttnCase(1, 4096, 4096, 16, 1, 200, True,
                                       2048, "float32", FP32_TOL, TF32X3),
    "hd250_t1000_fp32": AttnCase(1, 1000, 1000, 32, 8, 250, True, 0,
                                 "float32", FP32_TOL, TF32X3),
    "recurrentgemma_9b_b2_q1000_kv700_w200_fp32": AttnCase(
        2, 1000, 700, 16, 1, 256, True, 200, "float32", FP32_TOL, TF32X3),
}
# the case each attention kernel's entry in the kernels line reports
ATTENTION_ROW = {WGMMA: "glm4_9b_t4096",
                 TF32X3: "mixtral_8x7b_t8192_w4096_fp32"}


def live_pairs(tq, tkv, causal, window):
    """(query, key) pairs the masks leave live, for tq queries and tkv
    keys."""
    q = np.arange(tq, dtype=np.int64)
    hi = np.minimum(q + 1, tkv) if causal else np.full(tq, tkv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(tq, int)
    return int(np.maximum(hi - lo, 0).sum())


class AttentionPhase:
    """Phase 6: `flash_attention` against `flash_attention_plain` on the
    card at the attention widths of the cases in `ATTENTION_CASES`; then
    the kernel's, the plain version's and `scaled_dot_product_attention`'s
    times."""

    def __init__(self, smoke, fa):
        self.s, self.torch, self.dev, self.fa = smoke, smoke.torch, \
            smoke.dev, fa

    def inputs(self, name, seed):
        c = ATTENTION_CASES[name]
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        dt = getattr(torch, c.dtype)
        return tuple(torch.randn(shape, generator=gen, device=self.dev,
                                 dtype=torch.float32).to(dt)
                     for shape in ((c.b, c.tq, c.h, c.hd),
                                   (c.b, c.tkv, c.kvh, c.hd),
                                   (c.b, c.tkv, c.kvh, c.hd)))

    def path(self):
        """Every case once through `flash_attention`, with the launch counts
        reset just before; each case must launch one kernel, the one it
        names, and its output be finite and within tolerance of the plain
        version.  Returns the
        launches per kernel, the kernel of each case and the largest
        errors."""
        torch, fa, tk = self.torch, self.fa, self.s.tk
        outs, ran = {}, {}
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        for i, (name, c) in enumerate(ATTENTION_CASES.items()):
            before = tk.launch_counts()
            outs[name] = fa.flash_attention(*self.inputs(name, 6000 + i),
                                            causal=c.causal, window=c.window)
            after = tk.launch_counts()
            ran[name] = [k for k in fa.KERNELS if after[k] != before[k]]
        torch.cuda.synchronize()
        launches = {k: tk.launch_counts()[k] for k in fa.KERNELS}
        for name, kernels in ran.items():
            want = ATTENTION_CASES[name].kernel
            if kernels != [want]:
                raise SystemExit(f"attention {name}: launched {kernels}, "
                                 f"expected [{want}]")
        if any(n <= 0 for n in launches.values()):
            raise SystemExit(f"attention: a kernel never launched "
                             f"({launches})")
        errs = {}
        for i, (name, out) in enumerate(outs.items()):
            c = ATTENTION_CASES[name]
            atol, rtol = c.tol
            want = fa.flash_attention_plain(*self.inputs(name, 6000 + i),
                                            causal=c.causal, window=c.window)
            got, want = out.float(), want.float()
            if out.shape != (c.b, c.tq, c.h, c.hd) or \
                    not torch.isfinite(got).all():
                raise SystemExit(f"attention {name}: output not finite or of "
                                 "the wrong shape")
            err = (got - want).abs()
            errs[name] = float(err.max())
            if bool((err > atol + rtol * want.abs()).any()):
                raise SystemExit(f"attention {name}: differs from the plain "
                                 f"version (max abs err {errs[name]})")
        return launches, {n: k[0] for n, k in ran.items()}, errs

    def timing(self, name, seed):
        torch, fa, s = self.torch, self.fa, self.s
        c = ATTENTION_CASES[name]
        causal, window = c.causal, c.window
        q, k, v = self.inputs(name, seed)
        row = {"kernel": fa.kernel_for(q.dtype, c.hd),
            "ms": s.device_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window), reps=10),
            "plain_ms": s.time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), reps=3, warmup=1)}
        # the library yardstick: SDPA on [b, h, t, hd] views, with a mask
        # where there is a window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window > 0:
            qpos = torch.arange(c.tq, device=self.dev)[:, None]
            kpos = torch.arange(c.tkv, device=self.dev)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
        try:                          # a yardstick, not part of the port
            row["library_ms"] = s.device_ms(lambda: sdpa(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True), reps=10)
        except RuntimeError as err:
            row["library_ms"] = None
            row["library_error"] = f"not measured: {err!r}"[:300]
        if mask is not None:
            # SDPA's causal path without the window (more live pairs, no
            # mask to read): what SDPA takes where it is not held to the
            # masked path
            row["library_causal_ms"] = s.device_ms(lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
        # read q, k and v once, write o once
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * c.b * c.h * c.hd * live_pairs(c.tq, c.tkv, causal,
                                                  window)
        peak, passes = DTYPE_PEAK[c.dtype]
        row.update(bytes=nbytes, flops=flops, passes=passes,
                   bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   flops_ms=passes * flops / peak * 1e3)
        row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
        row["bound_by"] = "bytes" if row["bytes_ms"] > row["flops_ms"] \
            else "operations"
        return row


# ---------------------------------------------------------------------------
# Phases 7-9: the first clients of `atomics.apply` — telemetry counters,
# LL/SC sync (llsc, atomic copy, the MPMC queue) and CacheHash.
# ---------------------------------------------------------------------------

OBS_BATCHES = ("a_distinct_all_kinds", "c_uniform_u20", "d_zipf099_u20")
OBS_REPLAYS = 5
N_KINDS, N_HIST = 10, 16
KIND_NAMES = ("load", "store", "cas", "idle", "ll", "sc", "validate",
              "find", "insert", "delete")
QUEUE_CAPACITY, QUEUE_K, QUEUE_LANES = 4096, 2, 64
COPY_Q = 1024
HASH_NB, HASH_VW, HASH_Q = 2 ** 22, 2, 16384
HASH_VARIANTS = (("seqlock", True), ("indirect", True), ("cached_wf", True),
                 ("cached_me", True), ("cached_me", False))
FIND, INSERT, DELETE, IDLE = 7, 8, 9, 3
# A batch of more rounds is timed by its checked call alone and not
# profiled: each round is several hundred device operations, and the Zipf
# batch runs hundreds of rounds (PERF.md §5).
HASH_TIMED_ROUNDS = 16


def np_suffix_any(flags, seg_start):
    """Per sorted lane: is any lane at or after it within its segment
    flagged?"""
    p = flags.shape[0]
    idx = np.arange(p)
    seg_end = np.ones(p, bool)
    seg_end[:-1] = seg_start[1:]
    end = np.minimum.accumulate(np.where(seg_end, idx, p)[::-1])[::-1]
    nxt = np.minimum.accumulate(np.where(flags, idx, p)[::-1])[::-1]
    return nxt <= end


class NpTelemetry:
    """A numpy recount of the engine counters from each batch and the
    per-lane success it delivered: the counting rules of
    `repro_torch.obs.telemetry` written out anew (kind counts, the
    fast-path predicate, `ApplyStats`' rounds / raced loads / dirty cells
    from the (slot, lane)-sorted order, failed CAS / SC lanes, the log2
    contention histogram)."""

    def __init__(self, n):
        self.n = n
        self.c = {}

    def add(self, name, v):
        self.c[name] = self.c.get(name, 0) + int(v)

    def batch(self, ops, success, *, fused=True):
        n = self.n
        kind, slot = ops[0], ops[1]
        p = kind.shape[0]
        self.add("engine.batches", 1)
        for j, name in enumerate(KIND_NAMES):
            self.add(f"engine.ops.{name}", (kind == j).sum())
        active = kind != 3
        in_range = (slot >= 0) & (slot < n)
        writes = active & np.isin(kind, (1, 2, 5))
        cslot = np.where(active & in_range, slot, n).astype(np.int64)
        counts = np.bincount(cslot, minlength=n + 1)[:n]
        eligible = not (active & ~in_range).any() and (
            not writes.any() or counts.max(initial=0) <= 1)
        taken = eligible and fused
        self.add("engine.fast.eligible", eligible)
        self.add("engine.fast.taken", taken)
        aslot = np.where(active, slot, n)
        order = np.argsort(aslot, kind="stable")
        s_slot, s_kind, succ = aslot[order], kind[order], success[order]
        seg_start = np.ones(p, bool)
        seg_start[1:] = s_slot[1:] != s_slot[:-1]
        start = np.maximum.accumulate(np.where(seg_start, np.arange(p), 0))
        is_valcas = (s_kind == 1) | (s_kind == 2)
        is_sc = (s_kind == 5) & (s_slot < n)
        is_upd = is_valcas | is_sc
        excl = np.cumsum(is_upd) - is_upd
        rank = excl - excl[start]
        rounds = (int(rank[is_upd].max()) + 1 if is_valcas.any()
                  else int(is_sc.any()))
        self.add("engine.rounds.total", rounds)
        self.add("engine.rounds.slow", 0 if taken else rounds)
        self.add("engine.fail.cas", (active & (kind == 2) & ~success).sum())
        self.add("engine.fail.sc", (active & (kind == 5) & ~success).sum())
        is_read = (s_kind == 0) | (s_kind == 4)
        wrote = is_valcas | (is_sc & succ)
        self.add("engine.loads.raced",
                 (is_read & np_suffix_any(wrote, seg_start)).sum())
        self.add("engine.cells.dirty",
                 (seg_start & np_suffix_any(succ & is_upd, seg_start)
                  & (s_slot < n)).sum())
        c = counts[counts > 0]
        bucket = (c[:, None] >= 2 ** np.arange(1, N_HIST)[None, :]).sum(1)
        hist = np.bincount(bucket, minlength=N_HIST)
        for b in range(N_HIST):
            self.add(f"engine.contention.log2_{b:02d}", hist[b])


class ObsPhase:
    """Telemetry counters on the main path: `apply` with BIGATOMIC_OBS=
    counters on every layout and batch (a), (c), (d), eager and as a
    captured graph replayed OBS_REPLAYS times, counted against the numpy
    recount; device operations and times per `apply`, counters off and
    on."""

    def __init__(self, smoke, obs, tk):
        self.smoke, self.obs, self.tk = smoke, obs, tk
        self.torch, self.atomics = smoke.torch, smoke.atomics

    def layout(self, strategy, seed):
        smoke, torch, atomics = self.smoke, self.torch, self.atomics
        rng = np.random.default_rng(seed)
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        state = atomics.init(spec, initial, device=smoke.dev)
        ctx = atomics.init_ctx(P, K, device=smoke.dev)
        recount = NpTelemetry(N)
        rows = {}
        os.environ["BIGATOMIC_OBS"] = "counters"
        try:
            self.obs.reset()
            torch.cuda.synchronize()
            self.tk.reset_launch_counts()
            for name in OBS_BATCHES:
                current = smoke.np_words(atomics.logical(spec, state))
                ops_np = smoke.main_batch(name, rng, current, None)
                ops = smoke.convert.op_batch(ops_np, smoke.dev)
                graph_state = clone(state)
                state, _, res, _, _ = atomics.apply(spec, state, ops, ctx,
                                                    donate=True)
                recount.batch(ops_np, res.success.cpu().numpy())
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph):
                        out = atomics.apply(spec, graph_state, ops, ctx,
                                            donate=True)
                except Exception as err:
                    raise SystemExit(f"obs/{strategy}/{name}: capturing a "
                                     f"counted apply failed: {err!r}")
                graph.operands = (graph_state, out)   # kept for the replays
                for _ in range(OBS_REPLAYS):      # each replay counts again
                    graph.replay()
                    torch.cuda.synchronize()
                    recount.batch(ops_np, out[2].success.cpu().numpy())
                rows[name] = {"graph": graph, "ops": ops}
            snap = self.obs.snapshot()
            want = {key: recount.c.get(key, 0) for key in snap}
            if snap != want:
                bad = {k: (snap[k], want[k]) for k in snap
                       if snap[k] != want[k]}
                raise SystemExit(f"obs/{strategy}: counters differ from the "
                                 f"numpy recount (counter, recount): {bad}")
            launches = {k: v for k, v in self.tk.launch_counts().items()
                        if v}
            batches = snap["engine.batches"]
            if batches != len(OBS_BATCHES) * (1 + OBS_REPLAYS):
                raise SystemExit(f"obs/{strategy}: {batches} batches counted")
            for kname in ROUND_KERNELS:
                if not launches.get(kname):
                    raise SystemExit(f"obs/{strategy}: {kname} never "
                                     "launched")
            out = {"snapshot": snap, "launches": launches, "timing": {}}
            for name, row in rows.items():
                out["timing"][name] = self.timing(spec, state, ctx, row)
            return out
        finally:
            os.environ.pop("BIGATOMIC_OBS", None)
            self.obs.reset()

    def timing(self, spec, state, ctx, row):
        """Per batch: ms per eager `apply` and per replay, device
        operations per eager `apply`, counters off and on (CUDA events,
        torch.profiler), all on one table in turns."""
        smoke, torch, atomics = self.smoke, self.torch, self.atomics
        ops, graph = row["ops"], row["graph"]
        holder = [state]

        def run():
            holder[0], *_ = atomics.apply(spec, holder[0], ops, ctx,
                                          donate=True)
            torch.cuda.synchronize()

        out = {}
        for mode in ("off", "counters", "off", "counters"):
            os.environ["BIGATOMIC_OBS"] = mode
            out.setdefault(mode, {"apply_ms": [], "replay_ms": []})
            out[mode]["apply_ms"].append(smoke.time_ms(run, reps=10))
            if mode == "counters":
                out[mode]["replay_ms"].append(smoke.time_ms(graph.replay,
                                                            reps=10))
        for mode in ("off", "counters"):
            os.environ["BIGATOMIC_OBS"] = mode
            prof = smoke.device_busy(run, tries=3)
            out[mode]["device_ops_per_apply"] = prof.get(
                "device_ops_per_apply")
            out[mode]["device_us_per_apply"] = prof.get("device_us_per_apply")
        os.environ["BIGATOMIC_OBS"] = "counters"
        if out["off"]["device_ops_per_apply"] is None or \
                out["counters"]["device_ops_per_apply"] is None:
            raise SystemExit(f"obs/{spec.strategy}: device operations not "
                             "measured")
        if out["off"]["device_ops_per_apply"] > \
                DEVICE_OPS_LIMIT[spec.strategy]:
            raise SystemExit(f"obs/{spec.strategy}: counters off, "
                             f"{out['off']['device_ops_per_apply']} device "
                             f"operations per apply, more than "
                             f"{DEVICE_OPS_LIMIT[spec.strategy]}")
        return out


class SyncPhase:
    """LL/SC, atomic copy and the MPMC queue (`repro_torch.sync`) at the
    main path's table size, each against its numpy oracle."""

    def __init__(self, smoke, sync_mods):
        self.smoke = smoke
        self.llsc, self.ac, self.queue = sync_mods
        self.torch, self.atomics = smoke.torch, smoke.atomics

    def llsc_layout(self, strategy, seed):
        """`ll` on P random slots, `sc` on them (desired values, every
        third lane re-aimed at another cell, so its link cannot validate)
        and `validate`, each against `apply_sync_reference` on the same
        table; returns ms per call."""
        smoke, torch, atomics, llsc = (self.smoke, self.torch, self.atomics,
                                       self.llsc)
        rng = np.random.default_rng(seed)
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        data = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        state = atomics.init(spec, data, device=smoke.dev)
        ver = np.zeros(N, np.uint32)
        ctx = llsc.init_ctx(P, K, device=smoke.dev)
        rctx = (np.full(P, -1, np.int32), np.zeros(P, np.uint32),
                np.zeros((P, K), np.uint32), np.zeros(P, bool))
        slots = rng.integers(0, N, P).astype(np.int32)
        other = slots.copy()
        other[::3] = rng.integers(0, N, len(other[::3]))
        desired = rng.integers(0, 2 ** 32, (P, K), dtype=np.uint32)
        zeros = np.zeros((P, K), np.uint32)
        ms = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t) * 1e3
            return out

        ctx, vals = timed("ll", lambda: llsc.ll(state, ctx, slots,
                                                strategy=strategy, k=K))
        data, ver, rctx, ref = llsc.apply_sync_reference(
            data, ver, rctx, (np.full(P, llsc.LL, np.int32), slots, zeros))
        self.same(f"llsc/{strategy} ll values", vals, ref.value)
        state, ctx, ok = timed("sc", lambda: llsc.sc(
            state, ctx, other, desired, strategy=strategy, k=K))
        data, ver, rctx, ref = llsc.apply_sync_reference(
            data, ver, rctx, (np.full(P, llsc.SC, np.int32), other, desired))
        self.same(f"llsc/{strategy} sc success", ok, ref.success)
        ok = timed("validate", lambda: llsc.validate(
            state, ctx, slots, strategy=strategy, k=K))
        _, _, _, ref2 = llsc.apply_sync_reference(
            data, ver, rctx, (np.full(P, llsc.VL, np.int32), slots, zeros))
        self.same(f"llsc/{strategy} validate", ok, ref2.success)
        for f, a, b in zip(("slot", "version", "value", "linked"), ctx,
                           rctx):
            self.same(f"llsc/{strategy} ctx.{f}", a, b)
        self.same(f"llsc/{strategy} table",
                  atomics.logical(spec, state), data)
        self.same(f"llsc/{strategy} versions", state.version, ver)
        wins = int(ref.success.sum())
        if not 0.3 * P < wins < 0.9 * P:
            raise SystemExit(f"llsc/{strategy}: {wins} SC lanes won")
        return {"ms": ms, "sc_wins": wins}

    def copy_layout(self, strategy, seed):
        """`copy_batch` of COPY_Q random (src, dst) pairs over N cells
        against `copy_batch_reference`, then a chained batch (each lane's
        source the last lane's destination) to force several waves."""
        smoke, torch, atomics, ac = (self.smoke, self.torch, self.atomics,
                                     self.ac)
        rng = np.random.default_rng(seed)
        spec = atomics.AtomicSpec(N, K, strategy, p_max=2 * COPY_Q)
        data = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        state = atomics.init(spec, data, device=smoke.dev)
        ver = np.zeros(N, np.uint32)
        out = {}
        for name in ("random", "chained"):
            src = rng.integers(0, N, COPY_Q)
            dst = rng.integers(0, N, COPY_Q)
            if name == "chained":
                src[1::2] = dst[0:-1:2]
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, waves = ac.copy_batch(spec, state, src, dst)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            data, ver = ac.copy_batch_reference(data, ver, src, dst)
            self.same(f"copy/{strategy}/{name} table",
                      atomics.logical(spec, state), data)
            self.same(f"copy/{strategy}/{name} versions", state.version,
                      ver)
            t = time.perf_counter()
            want = len(ac._waves(src, dst))
            waves_ms = (time.perf_counter() - t) * 1e3
            if waves != want:
                raise SystemExit(f"copy/{strategy}: {waves} waves, "
                                 f"_waves gives {want}")
            out[name] = {"waves": waves, "ms": wall,
                         "wave_schedule_ms": waves_ms}
        if out["chained"]["waves"] < 2:
            raise SystemExit(f"copy/{strategy}: the chained batch ran in "
                             "one wave")
        return out

    def queue_cell(self, strategy, policy, seed):
        """`BigQueue(QUEUE_CAPACITY, k=QUEUE_K, p_max=QUEUE_LANES)`: an
        `enqueue_batch` of QUEUE_LANES lanes, a `dequeue_batch`, then
        `run_batch` of QUEUE_LANES lanes, half ENQ and half DEQ, twice;
        every dequeued payload equal to a sequential FIFO replay of the
        commit log, tickets dense."""
        from collections import deque
        queue = self.queue
        rng = np.random.default_rng(seed)
        pol = {"none": queue.BackoffPolicy("none"),
               "exp": queue.BackoffPolicy("exp", 1, 8)}[policy]
        q = queue.BigQueue(QUEUE_CAPACITY, k=QUEUE_K, strategy=strategy,
                           policy=pol, p_max=QUEUE_LANES, device=self.smoke.dev)
        fifo = deque()
        calls = []
        serial = 0
        plans = [("enqueue_batch", np.full(QUEUE_LANES, queue.ENQ)),
                 ("dequeue_batch", np.full(QUEUE_LANES // 2, queue.DEQ))]
        plans += [("run_batch", rng.permutation(np.repeat(
            [queue.ENQ, queue.DEQ], QUEUE_LANES // 2))) for _ in range(2)]
        for name, kinds in plans:
            vals = (np.arange(len(kinds), dtype=np.uint32)
                    + serial)[:, None]
            serial += len(kinds)
            start = len(q.commit_log)
            t = time.perf_counter()
            if name == "enqueue_batch":
                succ = q.enqueue_batch(vals)
                out, rounds = None, None
            elif name == "dequeue_batch":
                out, succ = q.dequeue_batch(len(kinds))
                rounds = None
            else:
                out, succ, rounds = q.run_batch(kinds, vals)
            self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            for kind, lane, _ in q.commit_log[start:]:
                if kind == "enq":
                    fifo.append(int(vals[lane, 0]))
                elif int(out[lane, 0]) != fifo.popleft():
                    raise SystemExit(f"queue/{strategy}/{policy}: lane "
                                     f"{lane} dequeued out of FIFO order")
            if int(np.asarray(succ).sum()) != len(q.commit_log) - start:
                raise SystemExit(f"queue/{strategy}/{policy}: successes "
                                 "differ from the commit log")
            if not np.asarray(succ).all():
                raise SystemExit(f"queue/{strategy}/{policy}: {name} had "
                                 "failed lanes")
            calls.append({"call": name, "lanes": len(kinds), "ms": ms,
                          "rounds": rounds,
                          "commits": len(q.commit_log) - start})
        for kind in ("enq", "deq"):
            tickets = [t for k, _, t in q.commit_log if k == kind]
            if tickets != list(range(len(tickets))):
                raise SystemExit(f"queue/{strategy}/{policy}: {kind} "
                                 "tickets not dense")
        if len(q) != len(fifo):
            raise SystemExit(f"queue/{strategy}/{policy}: len {len(q)}, "
                             f"replay {len(fifo)}")
        return calls

    def same(self, what, got, want):
        got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
        want = np.asarray(want)
        if got.dtype in (np.int32, np.uint32):
            got = got.view(np.uint32)
        if want.dtype in (np.int32, np.uint32):
            want = want.view(np.uint32)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise SystemExit(f"{what} differs from the numpy oracle")


class HashDict:
    """The Python-dict oracle of `cachehash.apply_reference`, fed plain
    lists: ops in lane order, add-if-absent INSERT."""

    def __init__(self):
        self.model = {}

    def step(self, kind, keys, vals):
        model = self.model
        found = np.zeros(len(kind), bool)
        out = np.zeros((len(kind), vals.shape[1]), np.uint32)
        rows = vals.tolist()
        for i, (kd, key) in enumerate(zip(kind.tolist(), keys.tolist())):
            if kd == FIND:
                v = model.get(key)
                if v is not None:
                    found[i] = True
                    out[i] = v
            elif kd == INSERT:
                if key not in model:
                    model[key] = rows[i]
                    found[i] = True
            elif kd == DELETE:
                if model.pop(key, None) is not None:
                    found[i] = True
        return found, out


class HashPhase:
    """CacheHash at nb = 2**22, vw = 2, p = 16384 (PERF.md's cachehash_find
    scale): inline on the four layouts and the chaining baseline on
    cached_me; a prefill to load 0.5, then a FIND-only batch, the 90/5/5
    FIND/INSERT/DELETE mix (u = 0.1, as bench_cachehash) on uniform and on
    Zipf 0.99 keys, each against the dict oracle, the final contents
    against it as sorted arrays."""

    def __init__(self, smoke, ch):
        self.smoke, self.ch = smoke, ch
        self.torch = smoke.torch

    def batches(self, seed):
        """The prefill (2**21 distinct keys over [0, 2**32) in batches of
        HASH_Q) and the three measured batches: keys half drawn from the
        inserted ones (hits), half uniform (misses); Zipf 0.99 over the
        inserted keys by rank."""
        rng = np.random.default_rng(seed)
        keys = rng.choice(2 ** 32, HASH_NB // 2, replace=False).astype(
            np.uint32)
        prefill = [(np.full(HASH_Q, INSERT, np.int32), keys[i:i + HASH_Q],
                    rng.integers(0, 2 ** 32, (HASH_Q, HASH_VW),
                                 dtype=np.uint32))
                   for i in range(0, len(keys), HASH_Q)]

        def mixed(kinds, zipf=False):
            if zipf:
                k = keys[(rng.zipf(1.01, HASH_Q) - 1) % len(keys)]
            else:
                k = np.where(rng.random(HASH_Q) < 0.5,
                             keys[rng.integers(0, len(keys), HASH_Q)],
                             rng.integers(0, 2 ** 32, HASH_Q,
                                          dtype=np.uint32))
            return kinds, k.astype(np.uint32), rng.integers(
                0, 2 ** 32, (HASH_Q, HASH_VW), dtype=np.uint32)

        def mix90():
            upd = rng.random(HASH_Q) < 0.1
            ins = rng.random(HASH_Q) < 0.5
            return np.where(upd, np.where(ins, INSERT, DELETE),
                            FIND).astype(np.int32)

        runs = {"find_only_uniform": mixed(np.full(HASH_Q, FIND, np.int32)),
                "mix_90_5_5_uniform": mixed(mix90()),
                "mix_90_5_5_zipf099": mixed(mix90(), zipf=True)}
        return prefill, runs

    def variant(self, strategy, inline, prefill, runs, oracle_steps):
        smoke, torch, ch = self.smoke, self.torch, self.ch
        spec = ch.HashSpec(HASH_NB, HASH_VW, strategy, p_max=HASH_Q,
                           inline=inline)
        state = ch.init_hash(spec, device=smoke.dev)
        dev = smoke.dev
        t0 = time.perf_counter()
        for (kind, keys, vals), (found, _) in zip(prefill, oracle_steps):
            ops = ch.make_hash_ops(kind, keys, vals, vw=HASH_VW, device=dev)
            state, res, _ = ch.apply_hash(spec, state, ops, donate=True)
            if not np.array_equal(res.found.cpu().numpy(), found):
                raise SystemExit(f"cachehash/{strategy}/{inline}: a prefill "
                                 "batch differs from the dict oracle")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = {"prefill_s": prefill_s, "runs": {}}
        for i, (name, (kind, keys, vals)) in enumerate(runs.items()):
            found, value = oracle_steps[len(prefill) + i]
            ops = ch.make_hash_ops(kind, keys, vals, vw=HASH_VW, device=dev)
            before = clone_hash(state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, res, stats = ch.apply_hash(spec, state, ops,
                                                      donate=True)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                syncs = [w for w in caught if "called a synchronizing"
                         in str(w.message)]
            torch.cuda.synchronize()
            checked_ms = (time.perf_counter() - t) * 1e3
            got_found = res.found.cpu().numpy()
            got_value = res.value.cpu().numpy().view(np.uint32)
            if not (np.array_equal(got_found, found)
                    and np.array_equal(got_value, value)):
                raise SystemExit(f"cachehash/{strategy}/{inline}/{name}: "
                                 "results differ from the dict oracle")
            if len(syncs) != 1:
                raise SystemExit(f"cachehash/{strategy}/{inline}/{name}: "
                                 f"{len(syncs)} host syncs in apply_hash, "
                                 f"not 1: {[str(w.message) for w in syncs]}")
            row = {"rounds": int(stats.rounds),
                   "chain_steps": int(stats.chain_steps),
                   "inline_hits": int(stats.inline_hits),
                   "allocs": int(stats.allocs) & 0xFFFFFFFF,
                   "frees": int(stats.frees) & 0xFFFFFFFF,
                   "host_syncs": len(syncs)}
            if row["rounds"] <= HASH_TIMED_ROUNDS:
                row.update(self.timing(spec, before, ops))
            else:                   # hundreds of rounds: the checked call
                row.update(ms=checked_ms, device_ops_per_call=None,
                           device_us_per_call=None)
            row["ops_per_s"] = HASH_Q / (row["ms"] * 1e-3)
            out["runs"][name] = row
            del before
        return state, out

    def timing(self, spec, state, ops):
        """Median ms per eager `apply_hash` (each call on a fresh copy of
        the table it was made for), device operations and device time per
        call (torch.profiler)."""
        smoke, ch = self.smoke, self.ch

        def call(st):
            ch.apply_hash(spec, st, ops, donate=True)
            smoke.torch.cuda.synchronize()

        def fresh():
            return (clone_hash(state),)

        ms = smoke.time_ms(call, reps=5, warmup=1, setup=fresh)
        prof = smoke.device_busy(call, reps=3, setup=fresh)
        return {"ms": ms, "device_ops_per_call": prof.get(
                    "device_ops_per_apply"),
                "device_us_per_call": prof.get("device_us_per_apply"),
                "device_busy_share": prof.get("device_busy_share")}

    def contents_equal(self, state, inline, model, what):
        keys, values = self.ch.contents(state, inline=inline, vw=HASH_VW)
        order = np.argsort(keys, kind="stable")
        want_k = np.fromiter(model.keys(), np.uint32, len(model))
        want_v = np.asarray(list(model.values()), np.uint32).reshape(
            -1, HASH_VW)
        w_order = np.argsort(want_k, kind="stable")
        if not (np.array_equal(keys[order], want_k[w_order])
                and np.array_equal(values[order], want_v[w_order])):
            raise SystemExit(f"cachehash/{what}: the table's contents "
                             f"differ from the dict oracle ({len(keys)} "
                             f"entries, oracle {len(model)})")
        return len(keys)


def clone_hash(state):
    return type(state)(clone(state.table), *(x.clone() for x in state[1:]))



# -- 10. txn -----------------------------------------------------------------

TXN_T, TXN_W, TXN_HOT_T, TXN_HOT_N = 4096, 4, 128, 8   # bench_txn.py shapes
TXN_MATCH = 0.8                     # txns expecting the live values
VL_DEPTH, VL_PUBLISHES = 4, 6
TS_BASE = 2 ** 31 - 3               # version-list publishes cross 2**31
MV_SLOTS, MV_PUBLISHES = 2, 4
MAP_T, MAP_HOT_T = 4096, 64
MV_STATE = {"w1": ((4096, 8192), "float32"),    # ~256 MiB of train state
            "w2": ((8192, 4096), "bfloat16"),
            "b": ((2 ** 24,), "float32")}
TXN_TIMING_REPS = 3


def txn_slots(rng, t, w, n, zipf=False):
    """int32[t, w] slots, distinct within each txn: uniform over n, or
    Zipf 0.99 ranks `(zipf(1.01) - 1) % n` as batch (d); rows with a
    repeat are drawn again (`bench_txn.py` draws without replacement)."""
    def draw(rows):
        if zipf:
            return (rng.zipf(1.01, (rows, w)) - 1) % n
        return rng.integers(0, n, (rows, w))

    slot = draw(t)
    while True:
        s = np.sort(slot, 1)
        dup = (s[:, 1:] == s[:, :-1]).any(1)
        if not dup.any():
            return slot.astype(np.int32)
        slot[dup] = draw(int(dup.sum()))


class VersionModel:
    """Numpy model of per-slot version lists: each slot's (ts, value)
    history; a read at ts answers the newest version with ts <= it, ok
    only while that version is among the `depth` newest."""

    def __init__(self, initial, ts0, depth):
        self.initial, self.ts0, self.depth = initial, ts0, depth
        self.hist = {}

    def publish(self, slots, values, ts):
        for s, v in zip(slots.tolist(), values):
            self.hist.setdefault(s, []).append((ts, v))

    def read(self, slots, ts):
        k = self.initial.shape[1]
        vals = np.zeros((len(slots), k), np.uint32)
        fts = np.zeros(len(slots), np.uint32)
        ok = np.zeros(len(slots), bool)
        for i, (s, q) in enumerate(zip(slots.tolist(), ts.tolist())):
            h = [(self.ts0, self.initial[s])] + self.hist.get(s, [])
            at = [j for j, (t, _) in enumerate(h) if t <= q]
            if at and len(h) - at[-1] <= self.depth:
                fts[i], vals[i], ok[i] = h[at[-1]][0], h[at[-1]][1], True
        return vals, fts, ok


class TxnPhase:
    """The transaction layer at the main path's table size: k-word MCAS on
    the four layouts (`AtomicSpec(2**22, 4, p_max=16384)`), the version
    lists, the versioned store, the transactional map on the cachehash
    phase's table, and the wait-free writable cell, each against the
    port's own numpy references."""

    def __init__(self, smoke, mods):
        self.smoke, self.torch = smoke, smoke.torch
        (self.mcas, self.vl, self.mv, self.tmap, self.wf, self.ch,
         self.invariants, self.queue) = mods
        self.dev = smoke.dev

    def fail(self, what):
        raise SystemExit(f"txn: {what}")

    same = SyncPhase.same      # bit-equality of a result and numpy words

    # -- MCAS ----------------------------------------------------------------

    @staticmethod
    def mcas_cases(seed):
        """(name, n, policy, slot, expected, desired, initial) per case:
        (i) T = 4096, W = 4 uniform over n = 2**22; (ii) the same, Zipf
        0.99 slots; (iii) T = 128, W = 4 over 8 cells, with no backoff
        and exp(1, 4).  `TXN_MATCH` of the txns expect the live values,
        the rest random comparands (`bench_txn.py:50-55, 167`)."""
        rng = np.random.default_rng(seed)
        big = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        hot = rng.integers(0, 2 ** 32, (TXN_HOT_N, K), dtype=np.uint32)
        cases = []
        for name, t, n, zipf, init in (
                ("uniform", TXN_T, N, False, big),
                ("zipf099", TXN_T, N, True, big),
                ("hot", TXN_HOT_T, TXN_HOT_N, False, hot)):
            slot = txn_slots(rng, t, TXN_W, n, zipf)
            expected = rng.integers(0, 2 ** 32, (t, TXN_W, K),
                                    dtype=np.uint32)
            fresh = rng.random(t) < TXN_MATCH
            expected[fresh] = init[slot[fresh]]
            desired = rng.integers(0, 2 ** 32, (t, TXN_W, K),
                                   dtype=np.uint32)
            cases.append((name, n, "none", slot, expected, desired, init))
        cases.append(("hot_exp",) + cases[2][1:2] + ("exp",)
                     + cases[2][3:])
        return cases

    def policy(self, name):
        return {"none": self.queue.BackoffPolicy("none"),
                "exp": self.queue.BackoffPolicy("exp", 1, 4)}[name]

    def mcas_layout(self, strategy, cases):
        """Each case once, checked: `mcas` against `mcas_reference` in
        `linearization_order` (success, witnesses, logical values,
        versions, `read()`), its host reads counted (one per round, the
        loop condition), and the hot cases' `mcas_round` driven to drain
        bit for bit against `mcas`.  Returns per case the inputs the
        timing needs and the checked numbers."""
        smoke, torch, m = self.smoke, self.torch, self.mcas
        atomics = smoke.atomics
        out = {}
        tables = {}
        for name, n, pol, slot, expected, desired, init in cases:
            if strategy != "cached_me" and name == "hot_exp":
                continue
            spec = atomics.AtomicSpec(n, K, strategy, p_max=P)
            if n not in tables:
                tables[n] = atomics.init(spec, init, device=self.dev)
            state = tables[n]
            txns = m.make_txns(slot, expected, desired, k=K, device=self.dev)
            policy = self.policy(pol)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    new_state, res = m.mcas(spec, state, txns, policy=policy)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                syncs = [w for w in caught
                         if "called a synchronizing" in str(w.message)]
            self.torch.cuda.synchronize()
            checked_ms = (time.perf_counter() - t0) * 1e3
            rounds = int(res.rounds)
            what = f"mcas/{strategy}/{name}"
            if len(syncs) != rounds:
                self.fail(f"{what}: {len(syncs)} host syncs for {rounds} "
                          f"rounds: {[str(w.message) for w in syncs][:4]}")
            if not (res.round > 0).all():
                self.fail(f"{what}: txns left unresolved")
            order = m.linearization_order(res)
            data, ver, succ, wit = m.mcas_reference(
                init, np.zeros(n, np.uint32),
                m.TxnBatch(slot, expected, desired), order)
            self.same(f"{what} success", res.success, succ)
            self.same(f"{what} witness", res.witness, wit)
            self.same(f"{what} logical", atomics.logical(spec, new_state),
                      data)
            self.same(f"{what} versions", new_state.version, ver)
            vals, ok = atomics.read(spec, new_state, torch.arange(
                n, dtype=torch.int32, device=self.dev))
            self.same(f"{what} read()", vals, data)
            if not bool(ok.all()):
                self.fail(f"{what}: read() not ok")
            row = {"t": len(slot), "w": TXN_W, "n": n, "policy": pol,
                   "rounds": rounds, "host_syncs": len(syncs),
                   "commit_rate": float(succ.mean()),
                   "attempts_per_txn": float(res.attempts.float().mean()),
                   "checked_ms": checked_ms}
            if name.startswith("hot"):
                self.drain_equals(spec, state, txns, policy, new_state, res,
                                  what)
                row["mcas_round_drain"] = "equal"
            out[name] = (row, spec, state, txns, policy)
            del new_state
        return out

    def drain_equals(self, spec, state, txns, policy, want_state, want, what):
        m = self.mcas
        st = clone(state)
        carry = m.mcas_begin(txns)
        while bool(carry.pending.any()):
            st, carry = m.mcas_round(spec, st, txns, carry, policy=policy,
                                     donate=True)
        got = m.mcas_finish(txns, carry)
        for f, a, b in zip(got._fields, got, want):
            if not self.torch.equal(a, b):
                self.fail(f"{what}: mcas_round driven to drain differs from "
                          f"mcas ({f})")
        for i, (a, b) in enumerate(zip(st, want_state)):
            if not self.torch.equal(a, b):
                self.fail(f"{what}: mcas_round's table differs (field {i})")

    def mcas_timing(self, strategy, runs):
        """Per case: median ms per `mcas` call (host clock, synchronised,
        the call's state copy included), ktxn/s; one round's device
        operations and device us (profiled, on fresh copies); and, on
        case (i), one `mcas_round` captured in a CUDA graph and replayed:
        it must equal the eager round (a failed capture fails the run),
        eager and replayed ms per round."""
        smoke, torch, m = self.smoke, self.torch, self.mcas
        out = {}
        for name, (row, spec, state, txns, policy) in runs.items():
            times = []
            for _ in range(TXN_TIMING_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.mcas(spec, state, txns, policy=policy)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            row = dict(row, ms=statistics.median(times))
            row["ktxn_per_s"] = row["t"] / row["ms"]
            carry = m.mcas_begin(txns)

            def one_round(st):
                m.mcas_round(spec, st, txns, carry, policy=policy,
                             donate=True)
                torch.cuda.synchronize()

            prof = smoke.device_busy(one_round, reps=3,
                                     setup=lambda: (clone(state),))
            row["round_device_ops"] = prof.get("device_ops_per_apply")
            row["round_device_us"] = prof.get("device_us_per_apply")
            row["round_top_device_us"] = prof.get("top_device_us_per_apply")
            if name == "uniform":
                row.update(self.captured_round(spec, state, txns, policy,
                                               f"mcas/{strategy}"))
                row["arbitrate_ms"] = self.arbitrate_ms(spec, txns)
            out[name] = row
        return out

    def arbitrate_ms(self, spec, txns):
        """Device ms of one `engine.arbitrate_groups` at the round's
        shapes, every lane eligible: its (n + 1)-sized fill and
        scatter-min, the lane gather and the (T + 1)-sized AND."""
        torch = self.torch
        p = txns.t * txns.w
        slot = txns.slot.reshape(p)
        group = (torch.arange(p, device=self.dev) // txns.w).to(torch.int32)
        live = torch.ones((p,), dtype=torch.bool, device=self.dev)
        return self.smoke.device_ms(
            lambda: self.smoke.engine.arbitrate_groups(
                slot, group, live, n=spec.n, n_groups=txns.t), reps=20)

    def captured_round(self, spec, state, txns, policy, what):
        torch, m = self.torch, self.mcas
        carry = m.mcas_begin(txns)
        eager = m.mcas_round(spec, clone(state), txns, carry, policy=policy,
                             donate=True)
        mine = clone(state)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = m.mcas_round(spec, mine, txns, carry, policy=policy,
                                   donate=True)
            graph.replay()
            torch.cuda.synchronize()
        except Exception as err:        # a failed capture fails the run
            raise SystemExit(f"{what}: capturing mcas_round in a CUDA graph "
                             f"failed: {err!r}") from err
        for part, (a, b) in enumerate(zip(out, eager)):
            for i, (x, y) in enumerate(zip(a, b)):
                if not torch.equal(x, y):
                    self.fail(f"{what}: the replayed mcas_round differs from "
                              f"the eager one (output {part}.{i})")
        replay_ms = self.smoke.time_ms(graph.replay, reps=10, warmup=2)
        scratch = clone(state)
        eager_ms = self.smoke.time_ms(lambda: m.mcas_round(
            spec, scratch, txns, carry, policy=policy, donate=True), reps=5,
            warmup=1)
        del graph, out, mine
        return {"round_replay_ms": replay_ms, "round_eager_ms": eager_ms,
                "captured_round": "equal"}

    # -- version lists -------------------------------------------------------

    def versionlist(self, seed):
        """`VersionSpec(2**22, 4, depth=4, p_max=16384)`: six publishes of
        P distinct slots (a hot quarter in every publish, so its rings
        lap), timestamps TS_BASE .. TS_BASE + 5 across 2**31; then
        `snapshot_read` of P slots at nine timestamps and `latest`
        against `VersionModel`, `check_version_list` clean.  Returns the
        state, the spec and the last publish's inputs for the timing."""
        vl, torch = self.vl, self.torch
        rng = np.random.default_rng(seed)
        spec = self.smoke.atomics.VersionSpec(N, K, depth=VL_DEPTH, p_max=P)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        ts0 = TS_BASE - 10
        st = vl.init(spec, initial, ts0=ts0, device=self.dev)
        model = VersionModel(initial, ts0, VL_DEPTH)
        hot = rng.choice(N, P // 4, replace=False)
        last = None
        for i in range(VL_PUBLISHES):
            cold = rng.integers(0, N, 2 * P)
            cold = rng.permutation(np.setdiff1d(cold, hot))[:P - len(hot)]
            slots = rng.permutation(np.concatenate([hot, cold])).astype(
                np.int32)
            vals = rng.integers(0, 2 ** 32, (P, K), dtype=np.uint32)
            ts = np.full(P, TS_BASE + i, np.uint32)
            st = vl.publish(spec, st, slots, vals, ts)
            model.publish(slots, vals, TS_BASE + i)
            last = (slots, vals, ts)
        q_slots = np.concatenate([hot[:P // 4], last[0][:P // 4],
                                  rng.integers(0, N, P // 2)]).astype(
                                      np.int32)
        reads = 0
        for q in (ts0 - 1, ts0, TS_BASE - 1, *range(TS_BASE,
                                                     TS_BASE + VL_PUBLISHES)):
            ts = np.full(P, q, np.uint32)
            vals, fts, ok = vl.snapshot_read(spec, st, q_slots, ts)
            want = model.read(q_slots, ts)
            for f, a, b in zip(("values", "ts", "ok"), (vals, fts, ok),
                               want):
                self.same(f"versionlist read at ts {q} {f}", a, b)
            reads += 1
        lv, lts, lok = vl.latest(spec, st, q_slots)
        want = model.read(q_slots, np.full(P, 2 ** 32 - 1, np.uint32))
        self.same("versionlist latest values", lv, want[0])
        self.same("versionlist latest ts", lts, want[1])
        for name, mask in self.invariants.check_version_list(spec,
                                                             st).items():
            if bool(mask.any()):
                self.fail(f"versionlist: check_version_list {name} flags "
                          f"{int(mask.sum())} healthy slots")
        laps = sum(len(h) > VL_DEPTH for h in model.hist.values())
        return st, spec, last, q_slots, {"publishes": VL_PUBLISHES,
                                         "reads": reads, "lapped_slots": laps}

    def versionlist_timing(self, st, spec, last, q_slots):
        vl, torch = self.vl, self.torch
        slots, vals, ts = last
        ts = (ts.astype(np.int64) + VL_PUBLISHES).astype(np.uint32)
        d_slots = torch.from_numpy(slots).to(self.dev)
        d_vals = self.smoke.words(vals)
        d_ts = self.smoke.words(ts)

        publish_ms = self.smoke.time_ms(
            lambda: vl.publish(spec, st, d_slots, d_vals, d_ts), reps=5,
            warmup=1)
        q = torch.from_numpy(q_slots).to(self.dev)
        q_ts = self.smoke.words(np.full(P, TS_BASE + 2, np.uint32))
        read_ms = self.smoke.time_ms(
            lambda: vl.snapshot_read(spec, st, q, q_ts), reps=10, warmup=2)
        return {"publish_ms": publish_ms, "snapshot_read_ms": read_ms,
                "pool_bytes": st.pool.numel() * 4}

    # -- the versioned store -------------------------------------------------

    def versioned_store(self, seed):
        """`core.multiversion` over a dict of ~256 MB of tensors (made on
        the card from a seed), two ring slots: four publishes, each read
        back by `snapshot_with_validation` and `step_at` of every publish
        time against the model; then `begin_publish` (the torn negative
        control): readers still get the last state, the torn slot fails
        `validate` and holds half of each leaf new."""
        mv, torch = self.mv, self.torch
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        state = {name: torch.randn(shape, generator=gen, device=self.dev)
                 .to(getattr(torch, dtype))
                 for name, (shape, dtype) in MV_STATE.items()}
        state["step"] = torch.zeros((), dtype=torch.int32, device=self.dev)
        nbytes = sum(x.numel() * x.element_size() for x in state.values())
        store = mv.init_store(state, n_slots=MV_SLOTS)
        times = []
        for i in range(1, MV_PUBLISHES + 1):
            new = mv.tree_map(lambda x, i=i: x + i, state)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            store = mv.publish(store, new, i)
            self.torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            snap = mv.snapshot_with_validation(store)
            if int(snap.step) != i or int(snap.version) % 2:
                self.fail(f"store publish {i}: step {int(snap.step)}, "
                          f"version {int(snap.version)}")
            for name, leaf in new.items():
                if not torch.equal(snap.state[name], leaf):
                    self.fail(f"store publish {i}: snapshot leaf {name}")
            for ts in range(0, i + 1):
                steps, ok = mv.step_at(store, ts)
                for s in range(MV_SLOTS):
                    # slot s: the initial state (ts 0, step 0), then the
                    # publishes t = s mod 2 (ts t, step t); two kept
                    mine = [0] + [t for t in range(1, i + 1)
                                  if t % MV_SLOTS == s]
                    older = [t for t in mine if t <= ts]
                    want_ok = bool(older) and older[-1] in mine[-2:]
                    if bool(ok[s]) != want_ok or (
                            want_ok and int(steps[s]) != older[-1]):
                        self.fail(f"store step_at({ts}) slot {s} after "
                                  f"publish {i}")
            last = new
        torn_state = mv.tree_map(lambda x: x + 1000, last)
        torn = mv.begin_publish(store, torn_state)
        snap = mv.snapshot_with_validation(torn)
        for name, leaf in last.items():
            if not torch.equal(snap.state[name], leaf):
                self.fail(f"store: a reader of the torn store got a torn "
                          f"leaf {name}")
        bad = (int(torn.head) + 1) % MV_SLOTS
        idx = torch.tensor(bad, device=self.dev)
        bad_snap = mv.Snapshot(mv.tree_map(lambda b: b[bad], torn.slots),
                               torn.step[bad], idx, torn.version[bad])
        if bool(mv.validate(torn, bad_snap)):
            self.fail("store: the torn slot validated")
        for name, leaf in torn_state.items():
            flat = torn.slots[name][bad].reshape(-1)
            half = leaf.numel() // 2
            if not (torch.equal(flat[:half], leaf.reshape(-1)[:half])
                    and (half == 0 or not torch.equal(
                        flat[half:], leaf.reshape(-1)[half:]))):
                self.fail(f"store: the torn slot's leaf {name} is not half "
                          f"written")
        return {"state_bytes": nbytes, "publishes": MV_PUBLISHES,
                "publish_ms": times}

    # -- the transactional map -----------------------------------------------

    def txn_map(self, prefill, seed):
        """`transact` on `HashSpec(2**22, vw=2, p_max=16384)` (cached_me)
        prefilled to load 0.5 with the cachehash phase's batches: T = 4096
        read-modify-write txns on disjoint keys (R = W = 2), then one hot
        counter key (T = 64, `bench_txn.py:175-177`); each against
        `transact_reference` on the touched keys, the table's contents
        against the prefill updated by the model."""
        ch, tmap, torch = self.ch, self.tmap, self.torch
        rng = np.random.default_rng(seed)
        spec = ch.HashSpec(HASH_NB, HASH_VW, "cached_me", p_max=HASH_Q)
        state = ch.init_hash(spec, device=self.dev)
        for kind, keys, vals in prefill:
            state, _, _ = ch.apply_hash(spec, state, ch.make_hash_ops(
                kind, keys, vals, vw=HASH_VW, device=self.dev), donate=True)
        pk = np.concatenate([b[1] for b in prefill])
        pv = np.concatenate([b[2] for b in prefill])
        order = np.argsort(pk)
        pk, pv = pk[order], pv[order]
        chosen = rng.choice(len(pk), 2 * MAP_T, replace=False)
        rmw_keys = pk[chosen].reshape(MAP_T, 2)
        hot_key = np.uint32(rng.integers(0, 2 ** 32))
        while np.isin(hot_key, pk):         # a key the prefill left out
            hot_key = np.uint32(rng.integers(0, 2 ** 32))
        model = {int(k): v for k, v in zip(pk[chosen], pv[chosen])}
        runs = {}
        for name, keys, fn in (
                ("disjoint_rmw", rmw_keys, map_fn_increment),
                ("hot_counter", np.full((MAP_HOT_T, 1), hot_key, np.uint32),
                 map_fn_sum_plus_one)):
            txns = tmap.make_map_txns(keys, keys, vw=HASH_VW,
                                      device=self.dev)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_state, res = tmap.transact(spec, state, txns, fn)
            self.torch.cuda.synchronize()
            checked_ms = (time.perf_counter() - t0) * 1e3
            model, rv, rf = tmap.transact_reference(
                model, txns, fn, tmap.linearization_order(res), HASH_VW)
            self.same(f"map/{name} read_value", res.read_value, rv)
            self.same(f"map/{name} read_found", res.read_found, rf)
            state = new_state
            runs[name] = {"t": len(keys), "rounds": int(res.rounds),
                          "checked_ms": checked_ms, "txns": txns, "fn": fn,
                          "attempts_per_txn":
                              float(res.attempts.float().mean())}
        if runs["hot_counter"]["rounds"] != MAP_HOT_T:
            self.fail(f"map/hot_counter: {runs['hot_counter']['rounds']} "
                      f"rounds, not {MAP_HOT_T}")
        if list(model[int(hot_key)]) != [MAP_HOT_T] * HASH_VW:
            self.fail(f"map/hot_counter: the counter reads "
                      f"{model[int(hot_key)]}")
        keys, values = ch.contents(state, inline=True, vw=HASH_VW)
        o = np.argsort(keys)
        keys, values = keys[o], values[o]
        want_k = np.union1d(pk, np.fromiter(model, np.uint32, len(model)))
        want_v = np.zeros((len(want_k), HASH_VW), np.uint32)
        want_v[np.searchsorted(want_k, pk)] = pv
        mk = np.fromiter(model, np.uint32, len(model))
        want_v[np.searchsorted(want_k, mk)] = np.stack(list(model.values()))
        self.same("map contents keys", keys, want_k)
        self.same("map contents values", values, want_v)
        return spec, state, runs

    def map_timing(self, spec, state, runs):
        smoke, tmap = self.smoke, self.tmap
        out = {}
        for name, run in runs.items():
            txns, fn = run.pop("txns"), run.pop("fn")

            def call():
                tmap.transact(spec, state, txns, fn)
                self.torch.cuda.synchronize()
            ms = smoke.time_ms(call, reps=TXN_TIMING_REPS, warmup=1)
            out[name] = dict(run, ms=ms, ktxn_per_s=run["t"] / ms)
        return out

    # -- the wait-free writable cell -----------------------------------------

    def wf_writable(self, seed):
        """`core.wf_writable` at n = 2**22, k = 4 (p_max = P): one
        `store_batch` of P lanes, half on 1024 hot slots (duplicates: the
        last lane per slot wins), then one `cas_batch` of P lanes, half
        expecting the live values, against `oracle_apply` on the same
        script."""
        wf, torch = self.wf, self.torch
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        st = wf.init(N, K, p_max=P, initial=initial, device=self.dev)
        hot = rng.integers(0, N, 1024)
        slots = np.where(rng.random(P) < 0.5, hot[rng.integers(0, 1024, P)],
                         rng.integers(0, N, P)).astype(np.int32)
        vals = rng.integers(0, 2 ** 32, (P, K), dtype=np.uint32)
        d_slots = torch.from_numpy(slots).to(self.dev)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        st2 = wf.store_batch(st, d_slots, vals)
        self.torch.cuda.synchronize()
        store_ms = (time.perf_counter() - t0) * 1e3
        model, _ = wf.oracle_apply(initial, [
            ("store", int(s), v) for s, v in zip(slots, vals)])
        self.same("wf store_batch values", st2.z_value, model)
        if bool(wf.pending(st2).any()):
            self.fail("wf: a store is left pending after store_batch")
        c_slots = np.where(rng.random(P) < 0.5, hot[rng.integers(0, 1024, P)],
                           rng.integers(0, N, P)).astype(np.int32)
        expected = np.where((rng.random(P) < 0.5)[:, None], model[c_slots],
                            rng.integers(0, 2 ** 32, (P, K),
                                         dtype=np.uint32))
        desired = rng.integers(0, 2 ** 32, (P, K), dtype=np.uint32)
        d_c = torch.from_numpy(c_slots).to(self.dev)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        st3, ok = wf.cas_batch(st2, d_c, expected, desired)
        self.torch.cuda.synchronize()
        cas_ms = (time.perf_counter() - t0) * 1e3
        model, oks = wf.oracle_apply(model, [
            ("cas", int(s), e, d) for s, e, d in zip(c_slots, expected,
                                                     desired)])
        self.same("wf cas_batch success", ok, np.asarray(oks))
        self.same("wf cas_batch values", st3.z_value, model)
        return {"duplicate_lanes": int(P - len(np.unique(slots))),
                "cas_successes": int(np.sum(oks)),
                "store_batch_ms": store_ms, "cas_batch_ms": cas_ms}


def map_fn_increment(rv, rf):
    """Each written key gets its read value + 1 (R == W)."""
    return rv + 1


def map_fn_sum_plus_one(rv, rf):
    """The counter: the read set's sum + 1 (W == 1)."""
    return rv.sum(axis=1, keepdims=True) + 1


def txn_phase(smoke, tk, prefill, launches_main):
    """The txn phase (`TxnPhase`): the checked path with the launch
    counts reset just before it and read just after (the four round
    kernels must have run; their counts join `launches_main`), then the
    timings.  `prefill` is the cachehash phase's prefill batches."""
    torch = smoke.torch
    from repro_torch.core import cachehash, multiversion, wf_writable
    from repro_torch.guard import invariants
    from repro_torch.sync import queue
    from repro_torch.txn import map as txn_map
    from repro_torch.txn import mcas as txn_mcas
    from repro_torch.txn import versionlist
    t0 = time.perf_counter()
    xp = TxnPhase(smoke, (txn_mcas, versionlist, multiversion, txn_map,
                          wf_writable, cachehash, invariants, queue))
    cases = xp.mcas_cases(9400)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    mcas_runs = {}
    for strategy in STRATEGIES:
        mcas_runs[strategy] = xp.mcas_layout(strategy, cases)
        log(f"[txn] mcas {strategy}: " + "; ".join(
            f"{name} T={r[0]['t']} rounds {r[0]['rounds']} (host syncs "
            f"{r[0]['host_syncs']}), commit rate {r[0]['commit_rate']:.3f}"
            + (", mcas_round drain equal" if "mcas_round_drain" in r[0]
               else "") for name, r in mcas_runs[strategy].items())
            + "; equal to mcas_reference")
    vl_state, vl_spec, vl_last, vl_q, vl_row = xp.versionlist(9500)
    log(f"[txn] versionlist n = 2**22, k = {K}, depth {VL_DEPTH}: "
        f"{VL_PUBLISHES} publishes of {P} slots (ts {TS_BASE} .. "
        f"{TS_BASE + VL_PUBLISHES - 1}), {vl_row['lapped_slots']} rings "
        f"lapped; {vl_row['reads']} snapshot_reads and latest equal to "
        f"the model; check_version_list clean")
    store_row = xp.versioned_store(9600)
    log(f"[txn] versioned store: {store_row['state_bytes'] / 2 ** 20:.0f} "
        f"MiB state, {MV_PUBLISHES} publishes read back and step_at equal "
        f"to the model; begin_publish: readers keep the last state, the "
        f"torn slot fails validate")
    map_spec, map_state, map_runs = xp.txn_map(prefill, 9700)
    log(f"[txn] map on HashSpec(2**22, vw={HASH_VW}) at load 0.5: " +
        "; ".join(f"{name} T={r['t']} rounds {r['rounds']}"
                  for name, r in map_runs.items())
        + "; equal to transact_reference, contents equal")
    wf_row = xp.wf_writable(9800)
    log(f"[txn] wf_writable n = 2**22: store_batch of {P} lanes "
        f"({wf_row['duplicate_lanes']} on repeated slots) and cas_batch "
        f"({wf_row['cas_successes']} succeeded) equal to oracle_apply")
    txn_launches = {k: v for k, v in tk.launch_counts().items() if v}
    for kname in ROUND_KERNELS:
        if not txn_launches.get(kname):
            raise SystemExit(f"txn: {kname} never launched on the path")
        launches_main[kname] += txn_launches[kname]
    txn_path_s = time.perf_counter() - t0
    log(f"[txn] path in {txn_path_s:.1f} s, launches {txn_launches}")
    txn_out = {"path_s": txn_path_s, "launches": txn_launches, "mcas": {}}
    for strategy in STRATEGIES:
        txn_out["mcas"][strategy] = rows = xp.mcas_timing(
            strategy, mcas_runs.pop(strategy))
        for name, r in rows.items():
            log(f"[txn-timing] mcas {strategy:9s} {name:8s} {r['ms']:.2f} "
                f"ms ({r['ktxn_per_s']:.1f} ktxn/s), {r['rounds']} rounds, "
                f"host reads {r['host_syncs']}; one round "
                f"{r['round_device_ops']} device operations, "
                f"{r['round_device_us']} device us"
                + (f"; a captured round replays equal, "
                   f"{r['round_replay_ms']:.4f} ms (eager "
                   f"{r['round_eager_ms']:.4f}); arbitrate_groups "
                   f"{r['arbitrate_ms'] * 1e3:.1f} us device"
                   if "round_replay_ms" in r else ""))
        torch.cuda.empty_cache()
    txn_out["versionlist"] = dict(vl_row, **xp.versionlist_timing(
        vl_state, vl_spec, vl_last, vl_q))
    del vl_state
    txn_out["store"] = store_row
    txn_out["map"] = xp.map_timing(map_spec, map_state, map_runs)
    del map_state
    txn_out["wf"] = wf_row
    txn_s = time.perf_counter() - t0
    txn_out["phase_s"] = txn_s
    vt = txn_out["versionlist"]
    log(f"[txn-timing] versionlist publish {vt['publish_ms']:.3f} ms, "
        f"snapshot_read {vt['snapshot_read_ms']:.3f} ms; store "
        f"publish ms {[round(x, 3) for x in store_row['publish_ms']]}; "
        + "; ".join(f"map {name} {r['ms']:.1f} ms ({r['ktxn_per_s']:.2f} "
                    f"ktxn/s, {r['rounds']} rounds)"
                    for name, r in txn_out["map"].items())
        + f"; wf store_batch {wf_row['store_batch_ms']:.2f} ms, cas_batch "
        f"{wf_row['cas_batch_ms']:.2f} ms")
    log(f"[txn] phase in {txn_s:.1f} s")
    torch.cuda.empty_cache()
    return txn_out


# ---------------------------------------------------------------------------
# Phase 10b: the sharded table on one NCCL rank (core/distributed.py).
# ---------------------------------------------------------------------------

DIST_BATCHES = ("a_distinct_all_kinds", "c_uniform_u20", "d_zipf099_u20",
                "e1_ll", "e2_sc_validate")
DIST_TIMED = ("a_distinct_all_kinds", "c_uniform_u20", "d_zipf099_u20")
DIST_LEVERS = {"flat": {}, "dedup_interleave": {"dedup_loads": True,
                                                "interleave": True}}
DIST_TIMING_REPS = 20
DIST_PROFILE_TRIES = 3


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kernel_counts(events):
    """Launches of the round's four kernels in a profiler trace's kernel
    events (the slow round runs `segment_replay.cuh`'s replay kernels)."""
    out = dict.fromkeys(ROUND_KERNELS, 0)
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        name = ev.get("name", "")
        for role, key in (("round_prologue", "round_prologue_kernel"),
                          ("fast_round", "fast_round"),
                          ("slow_round", "replay_"),
                          ("round_epilogue", "round_epilogue_kernel")):
            if key in name:
                out[role] += 1
    return out


def spans_ops(events, label):
    """The device operations (kernels, copies, memsets) each host span
    annotated `label` launched, by correlation id: a list, per span in
    time order, of the operations' names."""
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events
                   if ev.get("cat") == "user_annotation"
                   and ev.get("name") == label)
    launch_span = {}
    for ev in events:
        corr = ev.get("args", {}).get("correlation")
        if corr is None or not ev.get("name", "").startswith(LAUNCH_CALLS):
            continue
        for i, (a, b) in enumerate(spans):
            if a <= ev["ts"] <= b:
                launch_span[corr] = i
    out = [[] for _ in spans]
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            i = launch_span.get(ev.get("args", {}).get("correlation"))
            if i is not None:
                out[i].append(ev.get("name", "?"))
    return out


class DistPhase:
    """`core.distributed` on a one-rank NCCL world (`make_mesh((1,),
    ("shard",))` on the card: every route and return is an all_to_all to
    self): the main path's table, batches (a), (c), (d), (e) with the ctx
    carried, flat and with `dedup_loads` + `interleave`, each batch equal
    to `atomics.apply` on the same state and to the numpy oracle replaying
    `linearization_order`; `apply_hash` at the cachehash phase's scale
    against the dict oracle; `mcas` at the txn phase's against
    `mcas_reference`."""

    def __init__(self, smoke, dsb, ch, txn_mcas, queue):
        self.smoke, self.torch = smoke, smoke.torch
        self.dsb, self.ch, self.m, self.queue = dsb, ch, txn_mcas, queue
        self.atomics, self.engine = smoke.atomics, smoke.engine
        self.dev = smoke.dev
        self.mesh = dsb.make_mesh((1,), ("shard",))

    def fail(self, what):
        raise SystemExit(f"dist: {what}")

    same = SyncPhase.same

    def oracle_step(self, data, ver, ctx, ops, order):
        """`TableOracle.step` on the port's numpy oracle: the ops replayed
        in the claimed order, the links merged back by lane."""
        sub = tuple(np.asarray(x)[order] for x in ops)
        sub_ctx = tuple(np.asarray(x)[order] for x in ctx)
        data, ver, nctx, res = self.engine.apply_ops_reference(
            data, ver, sub_ctx, sub, copy=False)
        ctx = tuple(np.array(x, copy=True) for x in ctx)
        for field, rows in zip(ctx, nctx):
            field[order] = rows
        p, k = ops[3].shape
        value = np.zeros((p, k), np.uint32)
        success = np.zeros(p, bool)
        value[order], success[order] = res.value, res.success
        return data, ver, ctx, value, success

    def table(self, strategy, lever, seed, launches):
        """The five batches, each checked; returns the ops for timing."""
        smoke, torch, dsb, atomics = self.smoke, self.torch, self.dsb, \
            self.atomics
        spec = atomics.AtomicSpec(N, K, strategy, p_max=P)
        dspec = dsb.DistSpec(spec, "shard", 1, P, **DIST_LEVERS[lever])
        rng = np.random.default_rng(seed)
        initial = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        st = dsb.init_dist(self.mesh, dspec, initial)
        plain = atomics.init(spec, initial, device=self.dev)
        ctx = dsb.init_dist_ctx(self.mesh, dspec)
        pctx = atomics.init_ctx(P, K, device=self.dev)
        data, ver = initial.copy(), np.zeros(N, np.uint32)
        o_ctx = (np.full(P, -1, np.int32), np.zeros(P, np.uint32),
                 np.zeros((P, K), np.uint32), np.zeros(P, bool))
        kept = {}
        what = f"{strategy}/{lever}"
        for name in DIST_BATCHES:
            ops_np = smoke.main_batch(name, rng, data, o_ctx[0])
            ops = smoke.convert.op_batch(ops_np, self.dev)
            if name in DIST_TIMED:
                kept[name] = (st.local, ctx, ops)
                st = dsb.DistState(clone(st.local), self.mesh)
            torch.cuda.synchronize()
            smoke.tk.reset_launch_counts()
            st, ctx, res, ovf = dsb.apply(self.mesh, dspec, st, ops, ctx,
                                          donate=True)
            got = {kn: smoke.tk.WRAPPERS[kn].launches for kn in ROUND_KERNELS}
            if set(got.values()) != {1}:
                self.fail(f"{what}/{name}: round launches {got}, not one "
                          "of each (the branch is taken on the device)")
            for kn in ROUND_KERNELS:
                launches[kn] += got[kn]
            plain, pctx, pres, _, _ = atomics.apply(spec, plain, ops, pctx,
                                                    donate=True)
            order, ovf_ref = dsb.linearization_order(
                dspec, self.engine.OpBatch(*ops_np))
            data, ver, o_ctx, value, success = self.oracle_step(
                data, ver, o_ctx, ops_np, order)
            lg, vs = dsb.logical(dspec, st), dsb.versions(dspec, st)
            for field, a, b in (
                    ("value", res.value, pres.value),
                    ("success", res.success, pres.success),
                    *((f"ctx.{f}", x, y) for f, x, y in
                      zip(self.engine.LinkCtx._fields, ctx, pctx)),
                    ("logical", lg, atomics.logical(spec, plain)),
                    ("versions", vs, plain.version)):
                if not torch.equal(a, b):
                    self.fail(f"{what}/{name}: {field} differs from "
                              "atomics.apply")
            for field, a, b in (("value", res.value, value),
                                ("success", res.success, success),
                                ("overflow", ovf, ovf_ref),
                                *((f"ctx.{f}", x, y) for f, x, y in
                                  zip(self.engine.LinkCtx._fields, ctx,
                                      o_ctx)),
                                ("logical", lg, data), ("versions", vs, ver)):
                self.same(f"dist: {what}/{name}: {field}", a, b)
            del lg, vs
        return dspec, kept

    def executor(self, strategy, si, runtime, tk, launches):
        """`runtime.DistTarget` over `DistSpec(AtomicSpec(2**22, 4,
        layout), "shard", 1, 2048)` beside `LocalTarget` on the same table
        and the same streams (phase 12's factor-4 hot: S = 8, 96 batches
        of 2048 lanes): each history replayed equal to its own table, the
        two tables equal; wall ms and Mops/s of each.  The counts are
        reset just before the `DistTarget` run and read just after it;
        its round launches join `launches`."""
        torch = self.torch
        rng = np.random.default_rng(12000 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        spec = self.atomics.AtomicSpec(N, K, strategy, p_max=RT_P)
        factor = 4
        n_streams = RT_SLOTS * factor
        hot_cells, hot_frac = RT_MIXES["hot"]
        out, tables = {}, {}
        for name in ("dist", "local"):
            target = (runtime.DistTarget(
                self.mesh, self.dsb.DistSpec(spec, "shard", 1, RT_P), init)
                if name == "dist" else
                runtime.LocalTarget(spec, init, device=self.dev))
            ex = runtime.Executor(
                target, [runtime.SyntheticStream(
                    f"s{i}", seed=100 * si + 10 * factor + i, n=N, k=K,
                    width=RT_P, n_batches=RT_BATCHES // n_streams,
                    hot_cells=hot_cells, hot_frac=hot_frac)
                    for i in range(n_streams)],
                slots=RT_SLOTS, oversubscription=factor)
            torch.cuda.synchronize()
            if name == "dist":
                tk.reset_launch_counts()
            t = time.perf_counter()
            ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if name == "dist":
                for kn, c in tk.launch_counts().items():
                    if kn in launches:
                        launches[kn] += c
            if name == "dist":
                table = (self.dsb.logical(target.dspec, target.state),
                         self.dsb.versions(target.dspec, target.state))
            else:
                table = (self.engine.logical(spec, target.state),
                         target.state.version)
            tables[name] = [x.cpu().numpy().view(np.uint32) for x in table]
            oracle = runtime.replay_history(N, K, [RT_P] * n_streams,
                                            ex.history, initial=init)
            if not (np.array_equal(oracle.data, tables[name][0])
                    and np.array_equal(oracle.version, tables[name][1])):
                self.fail(f"{strategy}: the {name} executor's table differs "
                          "from the replay of its history")
            out[name] = {"wall_ms": wall * 1e3,
                         "mops_s": RT_BATCHES * RT_P / wall / 1e6,
                         "issues": ex.issues}
            del ex, target
        if not all(np.array_equal(a, b) for a, b in zip(tables["dist"],
                                                        tables["local"])):
            self.fail(f"{strategy}: DistTarget and LocalTarget end in other "
                      "tables on the same streams")
        return out

    def profiled(self, dspec, kept):
        """One eager `dist.apply` of each kept batch under the profiler,
        each `all_to_all_single` annotated: the round's four kernels once
        a batch, and two all_to_alls a batch, each of which put at least
        one operation on the card (NCCL's; at one rank a copy to self).
        A trace that lost operations is taken again."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch, dsb = self.torch, self.dsb
        tdist = dsb.dist
        a2a = tdist.all_to_all_single

        def annotated(*args, **kw):
            with record_function("dist_all_to_all"):
                return a2a(*args, **kw)
        want = dict.fromkeys(ROUND_KERNELS, len(kept))
        tdist.all_to_all_single = annotated
        try:
            for attempt in range(1, DIST_PROFILE_TRIES + 1):
                fresh = [(dsb.DistState(clone(local), self.mesh), ctx, ops)
                         for local, ctx, ops in kept.values()]
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for st, ctx, ops in fresh:
                        dsb.apply(self.mesh, dspec, st, ops, ctx,
                                  donate=True)
                    torch.cuda.synchronize()
                path = ROOT / "chiprun_out" / "dist_trace.tmp.json"
                prof.export_chrome_trace(str(path))
                events = json.loads(path.read_text())["traceEvents"]
                path.unlink()
                got = kernel_counts(events)
                a2a_ops = spans_ops(events, "dist_all_to_all")
                if got == want and len(a2a_ops) == 2 * len(kept) and \
                        all(a2a_ops):
                    return got, attempt, sorted({
                        name for ops in a2a_ops for name in ops})
        finally:
            tdist.all_to_all_single = a2a
        self.fail(f"profiled launches {got} over {len(kept)} batches, want "
                  f"{want}; the all_to_alls' device operations {a2a_ops} "
                  f"(want {2 * len(kept)} calls, each >= 1; "
                  f"{DIST_PROFILE_TRIES} traces)")

    def timing(self, dspec, kept):
        """Per kept batch: median ms per eager `dist.apply` and per
        `atomics.apply` (CUDA events, each call on a fresh copy of the
        table), the dist call split at the local round (route: the host
        check, the dedup, the owner ranks, the pack and the all_to_all
        out; round: the engine round; return: the all_to_all back and the
        merge), and the host syncs of one call."""
        smoke, torch, dsb, atomics = self.smoke, self.torch, self.dsb, \
            self.atomics
        spec = dspec.inner
        out = {}
        for name, (local, ctx, ops) in kept.items():
            def fresh():
                return (clone(local),)

            def dist_call(st):
                dsb.apply(self.mesh, dspec, dsb.DistState(st, self.mesh),
                          ops, ctx, donate=True)

            def plain_call(st):
                atomics.apply(spec, st, ops, ctx, donate=True)

            row = {"dist_ms": smoke.time_ms(dist_call, reps=DIST_TIMING_REPS,
                                            setup=fresh),
                   "apply_ms": smoke.time_ms(plain_call,
                                             reps=DIST_TIMING_REPS,
                                             setup=fresh)}
            row.update(self.split(dist_call, fresh))
            st = fresh()[0]
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dist_call(st)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            row["host_syncs"] = len([w for w in caught if "called a "
                                     "synchronizing" in str(w.message)])
            torch.cuda.synchronize()
            out[name] = row
        return out

    def split(self, dist_call, fresh):
        """Median ms of route / round / return: CUDA events recorded before
        the call, around `_local_round`, and after it."""
        torch, dsb = self.torch, self.dsb
        inner = dsb._local_round
        marks = []

        def timed_round(*args):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = inner(*args)
            b.record()
            marks.append((a, b))
            return out

        spans = []
        dsb._local_round = timed_round
        try:
            for _ in range(DIST_TIMING_REPS + 3):
                st = fresh()[0]
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                dist_call(st)
                e.record()
                spans.append((s, *marks.pop(), e))
        finally:
            dsb._local_round = inner
        torch.cuda.synchronize()
        spans = spans[3:]
        return {key: statistics.median(x.elapsed_time(y) for x, y in pairs)
                for key, pairs in (
                    ("route_ms", [(s, a) for s, a, _, _ in spans]),
                    ("round_ms", [(a, b) for _, a, b, _ in spans]),
                    ("return_ms", [(b, e) for _, _, b, e in spans]))}

    def a2a_ms(self):
        """Median ms of one `all_to_all_single` of the route's buffer
        alone (16384 lanes of 2k + 4 words; CUDA events around the call,
        so the host's time to issue it counts)."""
        buf = self.torch.zeros(P * (2 * K + 4), dtype=self.torch.int32,
                               device=self.dev)
        out = self.torch.empty_like(buf)
        group = self.mesh.groups["shard"]
        return self.smoke.time_ms(
            lambda: self.dsb.dist.all_to_all_single(out, buf, group=group),
            reps=DIST_TIMING_REPS)

    def hash(self, strategy, seed):
        """`apply_hash` with `HashSpec(2**22, 2, p_max=16384)` at one shard:
        the cachehash phase's prefill and three batches against the dict
        oracle, then the contents; ms and host syncs of each batch."""
        smoke, torch, dsb, ch = self.smoke, self.torch, self.dsb, self.ch
        hp = HashPhase(smoke, ch)
        prefill, runs = hp.batches(seed)
        oracle = HashDict()
        spec = ch.HashSpec(HASH_NB, HASH_VW, strategy, p_max=HASH_Q)
        dspec = dsb.DistSpec(spec, "shard", 1, HASH_Q)
        st = dsb.init_dist(self.mesh, dspec)
        what = f"hash/{strategy}"
        t0 = time.perf_counter()
        for kind, keys, vals in prefill:
            found, _ = oracle.step(kind, keys, vals)
            ops = ch.make_hash_ops(kind, keys, vals, vw=HASH_VW,
                                   device=self.dev)
            st, res, ovf = dsb.apply_hash(self.mesh, dspec, st, ops,
                                          donate=True)
            if not np.array_equal(res.found.cpu().numpy(), found) or \
                    bool(ovf.any()):
                self.fail(f"{what}: a prefill batch differs from the dict "
                          "oracle")
        torch.cuda.synchronize()
        out = {"prefill_s": time.perf_counter() - t0, "runs": {}}
        for name, (kind, keys, vals) in runs.items():
            found, value = oracle.step(kind, keys, vals)
            ops = ch.make_hash_ops(kind, keys, vals, vw=HASH_VW,
                                   device=self.dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    st, res, ovf = dsb.apply_hash(self.mesh, dspec, st, ops,
                                                  donate=True)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            self.same(f"dist: {what}/{name} found", res.found, found)
            self.same(f"dist: {what}/{name} value", res.value, value)
            if bool(ovf.any()) or bool(res.overflow.any()):
                self.fail(f"{what}/{name}: overflow reported")
            out["runs"][name] = {
                "ms": ms, "host_syncs": len([
                    w for w in caught
                    if "called a synchronizing" in str(w.message)])}
        items = dsb.hash_items(dspec, st)
        if len(items) != len(oracle.model) or any(
                list(np.ravel(v)) != list(oracle.model.get(key, []))
                for key, v in items.items()):
            self.fail(f"{what}: contents differ from the dict oracle")
        out["entries"] = len(items)
        return out

    def mcas(self, strategy, cases, launches):
        """`dist.mcas` at one shard on the txn phase's cases against
        `mcas_reference` in `linearization_order`; rounds, ms (host clock,
        synchronised) and host syncs of each."""
        torch, dsb, m, atomics = self.torch, self.dsb, self.m, self.atomics
        out = {}
        for name, n, pol, slot, expected, desired, init in cases:
            spec = atomics.AtomicSpec(n, K, strategy, p_max=P)
            dspec = dsb.DistSpec(spec, "shard", 1, P)
            st = dsb.init_dist(self.mesh, dspec, init)
            txns = m.make_txns(slot, expected, desired, k=K, device=self.dev)
            policy = {"none": self.queue.BackoffPolicy("none"),
                      "exp": self.queue.BackoffPolicy("exp", 1, 4)}[pol]
            torch.cuda.synchronize()
            self.smoke.tk.reset_launch_counts()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    st, res = dsb.mcas(self.mesh, dspec, st, txns,
                                       policy=policy, donate=True)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            for kn in ROUND_KERNELS:
                launches[kn] += self.smoke.tk.WRAPPERS[kn].launches
            what = f"mcas/{strategy}/{name}"
            if not bool((res.round > 0).all()):
                self.fail(f"{what}: txns left unresolved")
            order = m.linearization_order(res)
            data, ver, succ, wit = m.mcas_reference(
                init, np.zeros(n, np.uint32),
                m.TxnBatch(slot, expected, desired), order)
            self.same(f"dist: {what} success", res.success, succ)
            self.same(f"dist: {what} witness", res.witness, wit)
            self.same(f"dist: {what} logical", dsb.logical(dspec, st), data)
            self.same(f"dist: {what} versions", dsb.versions(dspec, st), ver)
            out[name] = {"t": len(slot), "rounds": int(res.rounds),
                         "ms": ms, "host_syncs": len([
                             w for w in caught
                             if "called a synchronizing" in str(w.message)]),
                         "commit_rate": float(succ.mean())}
        return out


def dist_phase(smoke, tk, launches_main):
    """Phase 10b: a one-rank NCCL world on the card; the checked path with
    the counts reset before each `dist.apply` and read after it (each batch
    must launch each of the four round kernels once; their launches, and
    the rounds' under `dist.mcas`, join
    `launches_main`), the profiled batches, the timings, `apply_hash` and
    `mcas`.  An NCCL init that fails, a mismatch or a missing launch fails
    the run."""
    torch = smoke.torch
    import torch.distributed as tdist
    from repro_torch.core import cachehash
    from repro_torch.core import distributed as dsb
    from repro_torch.sync import queue
    from repro_torch.txn import map as txn_map
    from repro_torch.txn import mcas as txn_mcas
    t0 = time.perf_counter()
    torch.cuda.set_device(smoke.dev)
    tdist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1)
    try:
        dp = DistPhase(smoke, dsb, cachehash, txn_mcas, queue)
        launches = dict.fromkeys(ROUND_KERNELS, 0)
        out = {"layouts": {}}
        for si, strategy in enumerate(STRATEGIES):
            for li, lever in enumerate(DIST_LEVERS):
                dspec, kept = dp.table(strategy, lever, 16000 + 2 * si + li,
                                       launches)
                row = {}
                if lever == "flat":
                    row["profile"], row["profile_traces"], nccl = \
                        dp.profiled(dspec, kept)
                    row["a2a_device_ops"] = nccl
                    row["timing"] = dp.timing(dspec, kept)
                out["layouts"][f"{strategy}/{lever}"] = row
                del kept
                torch.cuda.empty_cache()
            log(f"[dist] {strategy}: {len(DIST_BATCHES)} batches x "
                f"{len(DIST_LEVERS)} levers at n = 2**22, p_local = {P} on "
                "one NCCL rank equal atomics.apply and the oracle; each "
                "round kernel launched once a batch")
        out["a2a_ms"] = dp.a2a_ms()
        txn_cases = TxnPhase.mcas_cases(16100)
        out["hash"] = dp.hash("cached_me", 16200)
        out["mcas"] = dp.mcas("cached_me", txn_cases, launches)
        out["map"] = map_check(torch, dp.mesh, (dsb, cachehash, txn_map), 1,
                               16300, smoke.dev)
        from repro_torch import runtime
        out["executor"] = {strategy: dp.executor(strategy, si, runtime, tk,
                                                 launches)
                           for si, strategy in enumerate(STRATEGIES)}
        if not all(launches.values()):
            raise SystemExit(f"dist: a round kernel never launched: "
                             f"{launches}")
        for kn in ROUND_KERNELS:
            launches_main[kn] += launches[kn]
        out["launches"] = launches
    finally:
        tdist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    for key, row in out["layouts"].items():
        for name, t in row.get("timing", {}).items():
            log(f"[dist-timing] {key:26s} {name:20s} dist.apply "
                f"{t['dist_ms']:.4f} ms (route {t['route_ms']:.4f} / round "
                f"{t['round_ms']:.4f} / return {t['return_ms']:.4f}), "
                f"atomics.apply {t['apply_ms']:.4f} ms, host syncs "
                f"{t['host_syncs']}")
        if "profile" in row:
            log(f"[dist] {key}: profiled launches {row['profile']} "
                f"(traces {row['profile_traces']}), the all_to_alls' "
                f"device operations {row['a2a_device_ops']}")
    log(f"[dist-timing] one all_to_all_single of the route's buffer "
        f"({P} x {2 * K + 4} words, to self) {out['a2a_ms']:.4f} ms")
    h = out["hash"]
    log(f"[dist] apply_hash cached_me at nb = 2**22: prefill "
        f"{h['prefill_s']:.2f} s, {h['entries']} entries equal the dict "
        "oracle; " + "; ".join(f"{name} {r['ms']:.2f} ms, host syncs "
                               f"{r['host_syncs']}"
                               for name, r in h["runs"].items()))
    log("[dist] mcas cached_me: " + "; ".join(
        f"{name} T={r['t']} rounds {r['rounds']} {r['ms']:.1f} ms, host "
        f"syncs {r['host_syncs']}" for name, r in out["mcas"].items())
        + "; equal to mcas_reference")
    m = out["map"]
    log(f"[dist] transact_dist at one shard equal to transact and "
        f"transact_reference (prefill {m['prefill_keys']} keys "
        f"{m['prefill_s']:.1f} s, {m['entries']} entries equal): " + "; ".join(
            f"{name} T={r['t']} rounds {r['rounds']} {r['dist_ms']:.1f} ms "
            f"(transact {r['one_ms']:.1f}), host syncs {r['dist_host_syncs']} "
            f"({r['one_host_syncs']})" for name, r in m["runs"].items()))
    card = card_line()
    for strategy, row in out["executor"].items():
        log(f"[dist] {card} | {strategy} executor, phase 12's f4_hot streams "
            f"(S = 8, 96 x {RT_P} lanes): DistTarget at one NCCL rank "
            f"{row['dist']['wall_ms']:.1f} ms ({row['dist']['mops_s']:.4f} "
            f"Mops/s), LocalTarget {row['local']['wall_ms']:.1f} ms "
            f"({row['local']['mops_s']:.4f} Mops/s); both histories "
            "replayed equal, the tables equal")
    log(f"[dist] phase in {out['phase_s']:.1f} s, launches {launches}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 11: the paged-KV server (serving/engine.py over models/, the
# CacheHash page table, the BigQueue rings and the transactional map).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 12: the oversubscribed executor (runtime, checkpoint, guard.chaos).
# ---------------------------------------------------------------------------

RT_P, RT_SLOTS, RT_BATCHES = 2048, 2, 96     # bench_oversub.py at card scale
RT_FACTORS = (1, 2, 4, 8)                     # S = 2, 4, 8, 16 streams
RT_MIXES = {"uniform": (0, 0.0), "hot": (4, 0.5)}   # baseline.py:120-121
RT_CHAOS_STREAMS, RT_CHAOS_BATCHES = 3, 8
RT_MCAS_OPS_BATCHES = 12                      # each ops stream beside MCAS


class RuntimePhase:
    """Phase 12: `runtime.Executor` over `LocalTarget` at the main path's
    table size, per layout (see `runtime_phase`)."""

    def __init__(self, smoke, mods):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        self.runtime, self.chaos, self.mcas = mods
        # launches of the comparison runs (`mcas` alone), which the
        # phase's count leaves out
        self.uncounted = {}

    def fail(self, what):
        raise SystemExit(f"runtime: {what}")

    def spec(self, strategy):
        return self.s.atomics.AtomicSpec(N, K, strategy, p_max=RT_P)

    def table(self, target):
        """(logical, versions) of a target as numpy uint32."""
        return (self.s.np_words(self.s.engine.logical(target.spec,
                                                      target.state)),
                self.s.np_words(target.state.version))

    def streams(self, factor, mix, seed, **kw):
        hot_cells, hot_frac = RT_MIXES[mix]
        n_streams = RT_SLOTS * factor
        return [self.runtime.SyntheticStream(
            f"s{i}", seed=seed + i, n=N, k=K, width=RT_P,
            n_batches=RT_BATCHES // n_streams, hot_cells=hot_cells,
            hot_frac=hot_frac, **kw) for i in range(n_streams)]

    def executor(self, strategy, init_dev, factor, mix, seed, **kw):
        target = self.runtime.LocalTarget(self.spec(strategy),
                                          init_dev.clone(), device=self.dev)
        return self.runtime.Executor(
            target, self.streams(factor, mix, seed), slots=RT_SLOTS,
            oversubscription=factor, **kw)

    def counted_run(self, ex):
        """`ex.run()` with every host sync the card sees counted
        (`set_sync_debug_mode("warn")`: reads and blocking uploads) and
        every tensor-to-host read (`counting_host_reads`); waits on the
        rounds' own events are neither.  Returns (report, syncs, reads,
        wall s)."""
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught, \
                counting_host_reads(torch) as reads:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rep = ex.run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        return rep, syncs, reads["n"], wall

    # -- 1 and 2: the sweep, its syncs, its replay ---------------------------

    def sweep(self, strategy, si):
        """Every (factor, mix) cell of the layout: a checked run (host syncs
        and reads counted, must be 0; the factor-4 hot run replayed through
        `runtime.replay_history`), two timed runs (the faster counts), a
        profiled run (device-busy share); every run must end in the first
        run's table and versions."""
        rng = np.random.default_rng(12000 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        init_dev = self.s.words(init)
        rows = {}
        for mix in RT_MIXES:
            base = None
            for factor in RT_FACTORS:
                name = f"f{factor}_{mix}"
                seed = 100 * si + 10 * factor
                ex = self.executor(strategy, init_dev, factor, mix, seed)
                rep, syncs, reads, _ = self.counted_run(ex)
                issues = rep["issues"]
                if issues != RT_BATCHES:
                    self.fail(f"{strategy} {name}: {issues} issues, not "
                              f"{RT_BATCHES}")
                if syncs or reads:
                    self.fail(f"{strategy} {name}: {len(syncs)} host syncs "
                              f"and {reads} host reads over {issues} "
                              f"issues, not 0: {syncs[:3]}")
                want = self.table(ex.target)
                replay_s = None
                if factor == 4 and mix == "hot":
                    t = time.perf_counter()
                    oracle = self.runtime.replay_history(
                        N, K, [RT_P] * len(ex.streams), ex.history,
                        initial=init)
                    replay_s = time.perf_counter() - t
                    if not (np.array_equal(oracle.data, want[0])
                            and np.array_equal(oracle.version, want[1])):
                        self.fail(f"{strategy} {name}: the table differs "
                                  "from the replay of its history")
                del ex
                walls = []
                for _ in range(2):
                    ex = self.executor(strategy, init_dev, factor, mix, seed)
                    self.torch.cuda.synchronize()
                    t = time.perf_counter()
                    ex.run()
                    self.torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t)
                    self.same_table(ex, want, f"{strategy} {name} repeat")
                    del ex
                holder = {}

                def setup():
                    holder["ex"] = self.executor(strategy, init_dev, factor,
                                                 mix, seed)
                    return ()

                def run():
                    holder["ex"].run()
                    self.torch.cuda.synchronize()

                prof = self.s.device_busy(
                    run, reps=1, setup=setup,
                    trace=ROOT / "chiprun_out" / "runtime_trace.tmp.json")
                self.same_table(holder.pop("ex"), want,
                                f"{strategy} {name} profiled")
                wall = min(walls)
                mops = RT_BATCHES * RT_P / wall / 1e6
                base = base or mops
                rows[name] = {
                    "factor": factor, "streams": RT_SLOTS * factor,
                    "budget": RT_SLOTS * factor, "mix": mix,
                    "wall_s": wall, "walls_s": walls, "mops_s": mops,
                    "x_of_f1": mops / base,
                    "device_busy_share": prof.get("device_busy_share",
                                                  prof.get("error")),
                    "device_us_per_run": prof.get("device_us_per_apply"),
                    "issues": issues, "host_syncs_per_issue": 0.0,
                    "host_reads_per_issue": 0.0,
                    "replay_s": replay_s}
        del init_dev
        self.torch.cuda.empty_cache()
        return rows

    def same_table(self, ex, want, what):
        got = self.table(ex.target)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            self.fail(f"{what}: the table or versions differ from the "
                      "first run's")

    # -- 3: a round stream beside two ops streams ------------------------------

    def mcas_stream(self, strategy, si):
        """One `McasStream` (T = 4096 txns of W = 4 uniform slots in the
        lower half of the table, `TXN_MATCH` expecting the live values, on
        the txn phase's `AtomicSpec(2**22, 4, p_max=16384)`)
        with two `SyntheticStream`s on the upper half: its result equals
        `mcas` alone on the same txns and table; the lower half equals
        that run's, the upper half the replay of the ops streams."""
        torch, engine = self.torch, self.s.engine
        rng = np.random.default_rng(12100 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        half = N // 2
        slot = txn_slots(rng, TXN_T, TXN_W, half)
        expected = rng.integers(0, 2 ** 32, (TXN_T, TXN_W, K),
                                dtype=np.uint32)
        fresh = rng.random(TXN_T) < TXN_MATCH
        expected[fresh] = init[slot[fresh]]
        desired = rng.integers(0, 2 ** 32, (TXN_T, TXN_W, K),
                               dtype=np.uint32)
        txns = self.mcas.make_txns(slot, expected, desired, k=K,
                                   device=self.dev)
        # the txn phase's table: a round's batch is all T * W lanes
        spec = self.s.atomics.AtomicSpec(N, K, strategy,
                                         p_max=TXN_T * TXN_W)
        before = self.s.tk.launch_counts()
        alone_state, alone = self.mcas.mcas(
            spec, engine.init(spec, init, device=self.dev), txns)
        for name, c in self.s.tk.launch_counts().items():
            self.uncounted[name] = self.uncounted.get(name, 0) \
                + c - before[name]
        alone_logical = self.s.np_words(engine.logical(spec, alone_state))
        del alone_state
        target = self.runtime.LocalTarget(spec, init, device=self.dev)
        ops_streams = [self.runtime.SyntheticStream(
            f"ops{i}", seed=12200 + i, n=N, k=K, width=RT_P,
            n_batches=RT_MCAS_OPS_BATCHES, slot_lo=half) for i in range(2)]
        mc = self.runtime.McasStream("mcas", txns)
        ex = self.runtime.Executor(target, ops_streams + [mc],
                                   slots=RT_SLOTS, oversubscription=4)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rep = ex.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        res = mc.result()
        for field in ("success", "witness", "round", "attempts", "rounds"):
            got, want = getattr(res, field), getattr(alone, field)
            if not torch.equal(got, want):
                self.fail(f"{strategy}: McasStream {field} differs from "
                          "mcas alone")
        logical, versions = self.table(target)
        if not np.array_equal(logical[:half], alone_logical[:half]):
            self.fail(f"{strategy}: the MCAS half differs from mcas alone")
        oracle = self.runtime.replay_history(
            N, K, [RT_P, RT_P], ex.history, initial=init)
        if not (np.array_equal(oracle.data[half:], logical[half:])
                and np.array_equal(oracle.version[half:],
                                   versions[half:])):
            self.fail(f"{strategy}: the ops half differs from the replay")
        return {"wall_s": wall, "issues": rep["issues"],
                "mcas_rounds": mc.rounds_run,
                "committed": int(res.success.sum()),
                "rounds": int(alone.rounds)}

    # -- 4: faults, checkpoints, recovery ----------------------------------------

    def faults(self, strategy, si, tmp):
        """`run_chaos` (BIGATOMIC_GUARD=on) at n = 2**22, k = 4, width
        2048, 3 streams, 8 batches, one checkpoint fault: `verify_chaos`
        ok.  Then a preempt fault, a fresh executor that resumes from the
        disk checkpoint, and a table equal to an uninterrupted run's; the
        times of a disk checkpoint and of a restore."""
        rng = np.random.default_rng(12300 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        ckdir = os.path.join(tmp, f"chaos_{strategy}")
        t = time.perf_counter()
        res = self.chaos.run_chaos(
            si, strategy, n=N, k=K, width=RT_P,
            n_streams=RT_CHAOS_STREAMS, n_batches=RT_CHAOS_BATCHES,
            ckpt_faults=1, checkpoint_dir=ckdir, initial=init,
            device=self.dev)
        self.torch.cuda.synchronize()
        chaos_s = time.perf_counter() - t
        t = time.perf_counter()
        verdict = self.chaos.verify_chaos(res)
        verify_s = time.perf_counter() - t
        if not verdict["ok"]:
            self.fail(f"{strategy}: chaos verdict not ok: " + json.dumps(
                {k: v for k, v in verdict.items()
                 if k != "scrub_reports"}, default=str))
        rep = res["report"]
        scrubs = [s["latency_s"] for s in rep["scrubs"]]
        del res
        init_dev = self.s.words(init)

        def run(ckpt=None, **kw):
            ex = self.executor(strategy, init_dev, 2, "hot", 500 + si,
                               checkpoint_dir=ckpt, **kw)
            return ex, ex.run()

        full, _ = run()
        want = self.table(full.target)
        del full
        pdir = os.path.join(tmp, f"preempt_{strategy}")
        ex1, rep1 = run(pdir, injector=self.runtime.FaultInjector(
            [self.runtime.Fault(round=3, kind="preempt")]))
        if not rep1["stopped"]:
            self.fail(f"{strategy}: the preempted run did not stop")
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        ex1.checkpoint()                 # one more disk write, timed alone
        ckpt_write_s = time.perf_counter() - t
        del ex1
        ex2 = self.executor(strategy, init_dev, 2, "hot", 500 + si,
                            checkpoint_dir=pdir)
        t = time.perf_counter()
        resumed = ex2.resume()
        self.torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        rep2 = ex2.run()
        if rep2["stopped"]:
            self.fail(f"{strategy}: the resumed run stopped")
        self.same_table(ex2, want, f"{strategy} preempt + resume")
        step_bytes = sum(
            os.path.getsize(os.path.join(pdir, f"step_{resumed:08d}", f))
            for f in os.listdir(os.path.join(pdir, f"step_{resumed:08d}")))
        del ex2, init_dev
        self.torch.cuda.empty_cache()
        return {"chaos_s": chaos_s, "verify_s": verify_s,
                "injected_data_faults": verdict["injected_data_faults"],
                "quarantined": verdict["quarantined"],
                "shed_streams": verdict["shed_streams"],
                "erased_injections": len(verdict["erased_injections"]),
                "scrubs": len(scrubs), "scrub_pause_s": scrubs,
                "checkpoints": rep["checkpoints"],
                "data_faults": [d["kind"] for d in rep["data_faults"]],
                "resumed_round": resumed, "checkpoint_write_s": ckpt_write_s,
                "restore_s": restore_s, "checkpoint_bytes": step_bytes}


def runtime_phase(smoke, tk, launches_main):
    """Phase 12, the oversubscribed executor on each lock-free layout at
    `AtomicSpec(2**22, 4, p_max=2048)`: the sweep (slots 2, factor 1 / 2
    / 4 / 8, uniform and hot, 96 batches of 2048 lanes; 0 host syncs per
    issue), the factor-4 hot history replayed, a `McasStream` beside two
    ops streams, then with the guard on the chaos run, preempt and
    resume.  The launch counts are reset just before the checked path and
    read just after, less those of `mcas` run alone for comparison: the
    four round kernels and `digest_rows` must have run in the executor's
    runs; their launches join `launches_main`."""
    torch = smoke.torch
    import tempfile
    from repro_torch import runtime
    from repro_torch.guard import chaos
    from repro_torch.txn import mcas
    rp = RuntimePhase(smoke, (runtime, chaos, mcas))
    t0 = time.perf_counter()
    out = {"sweep": {}, "mcas_stream": {}, "faults": {}}
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="runtime_ck_") as tmp:
        for si, strategy in enumerate(STRATEGIES):
            out["sweep"][strategy] = rows = rp.sweep(strategy, si)
            for name, r in rows.items():
                log(f"[runtime] {strategy:9s} {name:11s} S={r['streams']:2d} "
                    f"budget {r['budget']:2d}: {r['wall_s'] * 1e3:.2f} ms "
                    f"({r['mops_s']:.3f} Mops/s, x_of_f1 "
                    f"{r['x_of_f1']:.3f}), device busy "
                    f"{r['device_busy_share']}, host syncs / reads per "
                    f"issue 0 / 0 over {r['issues']}"
                    + (f"; replayed equal in {r['replay_s']:.1f} s"
                       if r["replay_s"] is not None else ""))
            out["mcas_stream"][strategy] = m = rp.mcas_stream(strategy, si)
            log(f"[runtime] {strategy:9s} McasStream (T={TXN_T}, W={TXN_W}) "
                f"beside 2 ops streams: {m['mcas_rounds']} rounds "
                f"(mcas alone {m['rounds']}), {m['committed']} committed, "
                f"equal to mcas alone; ops half equal to the replay; "
                f"{m['wall_s'] * 1e3:.1f} ms, {m['issues']} issues")
            prev = os.environ.get("BIGATOMIC_GUARD")
            os.environ["BIGATOMIC_GUARD"] = "on"
            try:
                out["faults"][strategy] = f = rp.faults(strategy, si, tmp)
            finally:
                if prev is None:
                    os.environ.pop("BIGATOMIC_GUARD", None)
                else:
                    os.environ["BIGATOMIC_GUARD"] = prev
            log(f"[runtime] {strategy:9s} chaos ok: "
                f"{f['injected_data_faults']} data faults {f['data_faults']}"
                f", {f['quarantined']} quarantined, {f['scrubs']} scrubs "
                f"(pause median {statistics.median(f['scrub_pause_s']) * 1e3:.2f}"
                f" ms, max {max(f['scrub_pause_s']) * 1e3:.2f}), run "
                f"{f['chaos_s']:.2f} s, verified in {f['verify_s']:.2f} s; "
                f"preempt at round 3, resumed from round "
                f"{f['resumed_round']} equal to the uninterrupted run; "
                f"checkpoint write {f['checkpoint_write_s'] * 1e3:.1f} ms, "
                f"restore {f['restore_s'] * 1e3:.1f} ms "
                f"({f['checkpoint_bytes'] / 2 ** 20:.1f} MiB)")
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {k: v - rp.uncounted.get(k, 0)
                for k, v in tk.launch_counts().items()}
    launches = {k: v for k, v in launches.items() if v}
    for kname in ROUND_KERNELS + ("digest_rows",):
        if not launches.get(kname):
            raise SystemExit(f"runtime: {kname} never launched on the path")
        launches_main[kname] += launches[kname]
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    log(f"[runtime] phase in {out['phase_s']:.1f} s, launches {launches}")
    return out


SERVE_ARCH = "glm4_9b"                    # full width and depth, bf16
SERVE_SEED = 11000
SERVE_ENGINE = {"max_batch": 4, "page_size": 16, "n_pages": 256,
                "max_pages_per_seq": 64}
SERVE_PROMPTS = (128, 512, 200, 317, 409, 150)    # six requests
SERVE_NEW = 32
# The paged decode against the dense path on the same weights, teacher-
# forced with the engine's tokens: both round bf16 activations, and the
# engine's batch of up to 4 rows and 1024 gathered positions sums in
# another order than the dense path's batch of 1, so a logit may differ
# by a few bf16 ulps at its scale: |got - want| <= atol + rtol |want|.
# The tokens must agree wherever the dense top-2 margin exceeds twice
# that (the most two logits within it can cross).
SERVE_ATOL, SERVE_RTOL = 0.1, 2 ** -5
# The reduced fp32 deepseek_7b engine on the four lock-free layouts:
# (prompt length, new tokens) per request; tokens must equal the dense
# path's exactly.
SERVE_FP32_REQUESTS = ((20, 6), (12, 3), (17, 8))
SERVE_PROFILED_STEPS = 3


# Device-to-host reads of one decode step, one live row's crossing at
# most: the counts tests/test_torch_serving.py pins on the CPU
# (`DECODE_HOST_READS`).  A crossing with k rows crossing adds a dequeue
# round (6 reads) per further page.
SERVE_HOST_READS = {"decode": 4, "crossing": 15}
# The ways a tensor on the card reaches the host.
READ_METHODS = ("cpu", "tolist", "item", "__bool__", "__int__", "__float__",
                "__index__")


@contextlib.contextmanager
def counting_host_reads(torch):
    """Count every call that copies a tensor on the card to the host (one
    read each) while the block runs; yields the counter."""
    counter = {"n": 0}
    saved = {name: getattr(torch.Tensor, name) for name in READ_METHODS}

    def wrap(orig):
        def read(self, *a, **kw):
            if self.is_cuda:
                counter["n"] += 1
            return orig(self, *a, **kw)
        return read

    for name, orig in saved.items():
        setattr(torch.Tensor, name, wrap(orig))
    try:
        yield counter
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


class PageModel:
    """A numpy model of the page table and the free-page ring, driven by
    the calls the engine makes: the ring is FIFO and starts as pages
    n-1 .. 0; an allocation pops pages in lane order, a retirement pushes
    the retired sequence's pages in page order before the step's
    allocations pop."""

    def __init__(self, n_pages):
        self.free = list(range(n_pages - 1, -1, -1))
        self.map = {}                       # page key -> physical page

    @staticmethod
    def key(seq_id, page_no):
        return (int(seq_id) << 20) | int(page_no)

    def alloc(self, keys):
        if len(keys) > len(self.free):
            return None
        phys, self.free = self.free[:len(keys)], self.free[len(keys):]
        for k, p in zip(keys, phys):
            if k in self.map:
                raise SystemExit(f"serving: page key {k:#x} mapped twice")
            self.map[k] = p
        return phys

    def retire(self, keys):
        self.free += [self.map[k] for k in keys if k in self.map]
        for k in keys:
            self.map.pop(k, None)


class ServingPhase:
    """Phase 11: the paged-KV server at the full width of glm4_9b (see
    `serving_phase`)."""

    def __init__(self, smoke, mods):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        (self.configs, self.tm, self.steps, self.engine_mod, self.pk,
         self.attn, self.ch) = mods

    def fail(self, what):
        raise SystemExit(f"serving: {what}")

    def requests(self, cfg, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, cfg.vocab, t).astype(np.int32)
                for t in SERVE_PROMPTS]

    def new_engine(self, cfg, params, **kw):
        return self.engine_mod.ServingEngine(cfg, params, device=self.dev,
                                             **{**SERVE_ENGINE, **kw})

    def submit_all(self, eng, prompts):
        for rid, prompt in enumerate(prompts):
            eng.submit(self.engine_mod.Request(rid=rid, prompt=prompt,
                                               max_new_tokens=SERVE_NEW))

    # -- the checked run ------------------------------------------------------

    def checked_run(self, cfg, params, prompts):
        """The engine on the six requests with the page table held to
        `PageModel` after every step and the sampled logits kept (on the
        host) for the dense comparison.  Returns (tokens by rid, logits
        by (rid, position), steps, the model)."""
        pk = self.pk
        eng = self.new_engine(cfg, params)
        model = PageModel(SERVE_ENGINE["n_pages"])
        orig_alloc, orig_book = pk.alloc_pages, pk.txn_bookkeep

        def alloc_pages(paged, seq_ids, page_nos):
            want = model.alloc([model.key(s, p)
                                for s, p in zip(seq_ids, page_nos)])
            paged, phys = orig_alloc(paged, seq_ids, page_nos)
            if want is None or phys.tolist() != want:
                self.fail(f"alloc_pages gave {phys.tolist()}, the model "
                          f"{want}")
            return paged, phys

        def txn_bookkeep(paged, retires, allocs):
            model.retire([model.key(s, p) for s, used in retires
                          for p in range(used)])
            want = model.alloc([model.key(s, p) for s, p in allocs])
            paged, phys = orig_book(paged, retires, allocs)
            if want is None or phys.tolist() != want:
                self.fail(f"txn_bookkeep gave {phys.tolist()}, the model "
                          f"{want}")
            return paged, phys

        tags, logits = [], []
        orig_sample, orig_pc = eng._sample, eng._prefill_compute
        orig_fd = eng._finish_decode

        def sample(x):
            logits.append(x.float().cpu())
            return orig_sample(x)

        def prefill_compute(req):
            tags.append([(req.rid, len(req.prompt) - 1)])
            steps["admissions"] += 1
            return orig_pc(req)

        def finish_decode(live, x):
            tags.append([(eng.slots[i].rid, eng.slots[i].pos) for i in live])
            return orig_fd(live, x)

        steps = {"steps": 0, "crossings": 0, "admissions": 0, "retires": 0}
        eng._sample, eng._prefill_compute = sample, prefill_compute
        eng._finish_decode = finish_decode
        pk.alloc_pages, pk.txn_bookkeep = alloc_pages, txn_bookkeep
        try:
            self.submit_all(eng, prompts)
            for _ in range(4 * SERVE_NEW * len(prompts)):
                before = [s.pos for s in eng.slots if s.active]
                live = eng.step()
                if not live and not eng.pending():
                    break
                steps["steps"] += 1
                steps["crossings"] += sum(
                    p % SERVE_ENGINE["page_size"] == 0 for p in before)
                self.check_table(eng, model)
        finally:
            pk.alloc_pages, pk.txn_bookkeep = orig_alloc, orig_book
        self.check_table(eng, model)
        if model.map or len(eng.paged.free) != SERVE_ENGINE["n_pages"]:
            self.fail(f"{len(model.map)} pages still mapped, "
                      f"{len(eng.paged.free)} on the free ring")
        pages, ok = eng.paged.free.dequeue_batch(SERVE_ENGINE["n_pages"])
        if not ok.all() or sorted(pages[:, 0].tolist()) != list(
                range(SERVE_ENGINE["n_pages"])):
            self.fail("the free ring does not hold every page once")
        by_pos = {}
        for tag, x in zip(tags, logits):
            for j, (rid, pos) in enumerate(tag):
                by_pos[(rid, pos)] = x[j]
        out = {rid: r.out_tokens for rid, r in eng.requests.items()}
        steps["retires"] = sum(r.done for r in eng.requests.values())
        return out, by_pos, steps, model

    def pipelined(self, cfg, params, prompts, want):
        """`run_to_completion` then `run_pipelined`, each on a fresh engine
        over the six requests: both must give the checked run's tokens
        (`want`).  Wall time, tokens/s and fused decode dispatches of
        each.  The launch counts are set to 0 just before `run_pipelined`
        and read just after: "launches" are that run's alone."""
        tk = self.s.tk
        runs = {}
        for name in ("run_to_completion", "run_pipelined"):
            eng = self.new_engine(cfg, params)
            self.submit_all(eng, prompts)
            self.torch.cuda.synchronize()
            pipelined = name == "run_pipelined"
            if pipelined:
                tk.reset_launch_counts()
            t = time.perf_counter()
            got = getattr(eng, name)()
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if pipelined:
                launches = {k: v for k, v in tk.launch_counts().items()
                            if v}
            if got != want:
                diff = [rid for rid in want if got.get(rid) != want[rid]]
                self.fail(f"{name}: tokens of requests {diff} differ from "
                          "the checked run's")
            new_tokens = sum(len(toks) for toks in got.values())
            runs[name] = {"wall_s": wall, "new_tokens": new_tokens,
                          "tokens_per_s": new_tokens / wall,
                          "dispatches": eng.dispatch_count}
            del eng
        return {"runs": runs, "launches": launches}

    def check_table(self, eng, model):
        """The page table's contents equal the model's mapping; no physical
        page is mapped twice; the ring holds the model's free count."""
        items = self.ch.items(eng.paged.state.table, inline=True, vw=1)
        got = {int(k): int(v[0]) for k, v in items.items()}
        if got != model.map:
            diff = sorted(set(got.items()) ^ set(model.map.items()))[:6]
            self.fail(f"page table differs from the model: {diff}")
        if len(set(got.values())) != len(got):
            self.fail("a physical page is mapped twice")
        if len(eng.paged.free) != len(model.free):
            self.fail(f"free ring holds {len(eng.paged.free)}, the model "
                      f"{len(model.free)}")

    # -- the dense path -------------------------------------------------------

    def dense_compare(self, cfg, params, prompts, out, by_pos):
        """`make_prefill_step` + `make_serve_step` (no page table) per
        request, teacher-forced with the engine's tokens: every logit
        within the stated tolerance of the engine's, and the engine's token
        the dense argmax wherever the dense top-2 margin exceeds twice the
        tolerance.  Returns the largest error and the token counts."""
        torch = self.torch
        max_err, checked, margin_ok = 0.0, 0, 0
        for rid, prompt in enumerate(prompts):
            T = len(prompt)
            prefill = self.steps.make_prefill_step(cfg, max_len=T + SERVE_NEW)
            serve = self.steps.make_serve_step(cfg)
            tokens = torch.as_tensor(prompt[None]).to(self.dev)
            logits, cache = prefill(params, {"tokens": tokens})
            rows = [logits[0, -1]]
            for d in range(SERVE_NEW - 1):
                logits, cache = serve(params, cache, {
                    "tokens": torch.tensor([[out[rid][d]]], dtype=torch.int32,
                                           device=self.dev),
                    "pos": torch.tensor([T + d], dtype=torch.int32,
                                        device=self.dev)})
                rows.append(logits[0, 0])
            for d, row in enumerate(rows):      # row d -> out[rid][d]
                want = row.float().cpu()
                got = by_pos[(rid, T - 1 + d)]
                tol = SERVE_ATOL + SERVE_RTOL * want.abs()
                err = (got - want).abs()
                max_err = max(max_err, float(err.max()))
                if not torch.isfinite(got).all() or bool((err > tol).any()):
                    self.fail(f"request {rid} position {T + d}: paged logits "
                              f"differ from the dense path by "
                              f"{float(err.max()):.4f}")
                top2 = torch.topk(want, 2)
                margin = float(top2.values[0] - top2.values[1])
                checked += 1
                if margin > 2 * float(tol[top2.indices[0]]):
                    margin_ok += 1
                    if out[rid][d] != int(top2.indices[0]):
                        self.fail(f"request {rid} token {d}: engine "
                                  f"{out[rid][d]}, dense "
                                  f"{int(top2.indices[0])} (margin "
                                  f"{margin:.3f})")
            del cache
        return {"max_abs_err": max_err, "positions": checked,
                "tokens_held_by_margin": margin_ok}

    def prefill_route(self, cfg, seed):
        """The prefill's attention at one prompt's shapes (the longest):
        the kernel route (`models.attention.flash_attention`) against the
        plain pair-list version, bf16 within the attention phase's
        tolerance; the route must launch `flash_attention_wgmma`."""
        torch, tk = self.torch, self.s.tk
        T = max(SERVE_PROMPTS)
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        q, k, v = (torch.randn((1, T, h, cfg.hd), generator=gen,
                               device=self.dev).to(cfg.cdtype())
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        before = tk.launch_counts()[WGMMA]
        got = self.attn.flash_attention(q, k, v, causal=True,
                                        q_block=cfg.q_block,
                                        kv_block=cfg.kv_block)
        launched = tk.launch_counts()[WGMMA] - before
        want = self.attn.flash_attention_pairs(q, k, v, causal=True,
                                               q_block=cfg.q_block,
                                               kv_block=cfg.kv_block)
        err = (got.float() - want.float()).abs()
        atol, rtol = BF16_TOL
        if launched != 1 or not torch.isfinite(got.float()).all() or \
                bool((err > atol + rtol * want.float().abs()).any()):
            self.fail(f"prefill attention route: {launched} wgmma launches, "
                      f"max abs err {float(err.max())}")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # read q, k and v once, write o once; the causal pairs' products
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * cfg.n_heads * cfg.hd * live_pairs(T, T, True, 0)
        row = {"t": T, "max_abs_err": float(err.max()),
               "kernel_ms": self.s.device_ms(
                   lambda: self.attn.flash_attention(q, k, v, causal=True),
                   reps=10),
               "plain_ms": self.s.time_ms(
                   lambda: self.attn.flash_attention_pairs(
                       q, k, v, causal=True), reps=3, warmup=1),
               "library_ms": self.s.device_ms(lambda: sdpa(
                   qt, kt, vt, is_causal=True, enable_gqa=True), reps=10),
               "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "flops_ms": flops / BF16_FLOPS * 1e3}
        row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
        return row

    def fp32_layouts(self, seed):
        """The reduced fp32 deepseek_7b engine on the four lock-free
        layouts: greedy tokens equal the dense path's exactly."""
        import dataclasses
        cfg = dataclasses.replace(
            self.configs.get_config("deepseek_7b", reduced=True),
            param_dtype="float32", compute_dtype="float32")
        params = self.tm.init_params(cfg, seed=seed, device=self.dev)
        rng = np.random.default_rng(seed)
        reqs = [(rng.integers(0, cfg.vocab, t).astype(np.int32), n)
                for t, n in SERVE_FP32_REQUESTS]
        dense = [self.dense_greedy(cfg, params, p, n) for p, n in reqs]
        for strategy in STRATEGIES:
            eng = self.engine_mod.ServingEngine(
                cfg, params, max_batch=2, n_pages=32, page_size=8,
                max_pages_per_seq=8, strategy=strategy, device=self.dev)
            for rid, (p, n) in enumerate(reqs):
                eng.submit(self.engine_mod.Request(rid=rid, prompt=p,
                                                   max_new_tokens=n))
            got = eng.run_to_completion()
            for rid, want in enumerate(dense):
                if got[rid] != want:
                    self.fail(f"fp32 deepseek_7b on {strategy}: request "
                              f"{rid} paged {got[rid]}, dense {want}")
            if len(eng.paged.free) != 32:
                self.fail(f"fp32 deepseek_7b on {strategy}: pages leaked")
        return [len(d) for d in dense]

    def dense_greedy(self, cfg, params, prompt, n_new):
        torch = self.torch
        T = len(prompt)
        prefill = self.steps.make_prefill_step(cfg, max_len=T + n_new)
        serve = self.steps.make_serve_step(cfg)
        logits, cache = prefill(params, {"tokens": torch.as_tensor(
            prompt[None]).to(self.dev)})
        toks = [int(torch.argmax(logits[0, -1]))]
        for d in range(n_new - 1):
            logits, cache = serve(params, cache, {
                "tokens": torch.tensor([[toks[-1]]], dtype=torch.int32,
                                       device=self.dev),
                "pos": torch.tensor([T + d], dtype=torch.int32,
                                    device=self.dev)})
            toks.append(int(torch.argmax(logits[0, 0])))
        return toks

    # -- timing ---------------------------------------------------------------

    def timed_run(self, cfg, params, prompts):
        """The six requests again, unhooked: the wall time of every step
        (each ends on the sampled tokens' read back) with its host syncs
        (`torch.cuda.set_sync_debug_mode("warn")`: reads and uploads from
        pageable memory) and host reads (`counting_host_reads`; a decode
        step's and a one-crossing step's must equal `SERVE_HOST_READS`),
        each prefill's time,
        tokens/s; three plain decode steps (4 live, no crossing, nobody
        retiring) profiled for their device operations and busy share."""
        torch = self.torch
        eng = self.new_engine(cfg, params)
        prefill_ms = []
        orig_pc = eng._prefill_compute

        def prefill_compute(req):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig_pc(req)
            prefill_ms.append(((time.perf_counter() - t) * 1e3,
                               len(req.prompt)))
            return out

        eng._prefill_compute = prefill_compute
        self.submit_all(eng, prompts)
        P = SERVE_ENGINE["page_size"]
        rows, profile = [], None
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        while True:
            live = [s for s in eng.slots if s.active]
            plain = (len(live) == SERVE_ENGINE["max_batch"] and
                     not eng._pending_retire and
                     all((s.pos + d) % P and s.new_tokens + d + 1 < SERVE_NEW
                         for s in live
                         for d in range(SERVE_PROFILED_STEPS)))
            if profile is None and plain:
                t = time.perf_counter()
                profile = self.s.device_busy(
                    eng.step, reps=SERVE_PROFILED_STEPS,
                    trace=ROOT / "chiprun_out" / "serving_trace.tmp.json")
                rows.append({"kind": "profiled", "n": SERVE_PROFILED_STEPS,
                             "ms": (time.perf_counter() - t) * 1e3})
                continue
            crossing = sum(s.pos % P == 0 for s in live)
            n_pre = len(prefill_ms)
            pending = bool(eng._pending_retire)
            done = sum(r.done for r in eng.requests.values())
            t = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught, \
                    counting_host_reads(torch) as reads:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    n = eng.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            ms = (time.perf_counter() - t) * 1e3
            syncs = sum("called a synchronizing" in str(w.message)
                        for w in caught)
            if not n and not eng.pending():
                break
            kind = ("admission" if len(prefill_ms) > n_pre else
                    "retire_flush" if pending else
                    "retire" if sum(r.done for r in eng.requests.values())
                    > done else "crossing" if crossing else "decode")
            rows.append({"kind": kind, "live": n, "crossings": crossing,
                         "ms": ms, "host_syncs": syncs,
                         "host_reads": reads["n"]})
            want = SERVE_HOST_READS.get(kind)
            if want is not None and crossing <= 1 and reads["n"] != want:
                self.fail(f"a {kind} step read {reads['n']} tensors back to "
                          f"the host, the CPU pins {want}")
        wall_s = time.perf_counter() - t_run
        if profile is None:
            profile = {"error": "not measured: no three plain decode steps"}
        new_tokens = sum(len(r.out_tokens) for r in eng.requests.values())
        return self.summary(rows, prefill_ms, wall_s, new_tokens, profile)

    @staticmethod
    def summary(rows, prefill_ms, wall_s, new_tokens, profile):
        def med(kind, live=None):
            vals = [r["ms"] for r in rows if r["kind"] == kind
                    and live in (None, r.get("live"))]
            return statistics.median(vals) if vals else None

        decode = [r for r in rows if r["kind"] == "decode"]
        decode_s = sum(r["ms"] for r in decode) / 1e3
        lives = sorted({r["live"] for r in decode})
        return {
            "prefill_ms": [{"t": t, "ms": ms} for ms, t in prefill_ms],
            "decode_step_ms": med("decode", SERVE_ENGINE["max_batch"]),
            "decode_step_ms_by_live": {n: med("decode", n) for n in lives},
            "crossing_step_ms": med("crossing"),
            "admission_step_ms": med("admission"),
            "host_syncs": {kind: sorted({r["host_syncs"] for r in rows
                                         if r["kind"] == kind})
                           for kind in ("decode", "crossing", "admission",
                                        "retire", "retire_flush")},
            "host_syncs_decode_by_live": sorted({
                (r["live"], r["host_syncs"]) for r in decode}),
            "host_reads": {kind: sorted({r["host_reads"] for r in rows
                                         if r["kind"] == kind})
                           for kind in ("decode", "crossing", "admission",
                                        "retire", "retire_flush")},
            "host_syncs_by_crossings": sorted({
                (r["crossings"], r["host_syncs"]) for r in rows
                if r["kind"] == "crossing"}),
            "steps": {kind: sum(r["kind"] == kind for r in rows)
                      for kind in ("decode", "crossing", "admission",
                                   "retire", "retire_flush", "profiled")},
            "wall_s": wall_s, "new_tokens": new_tokens,
            "tokens_per_s": new_tokens / wall_s,
            "decode_tokens_per_s": (sum(r["live"] for r in decode) / decode_s
                                    if decode else None),
            "profile": {k: v for k, v in (profile or {}).items()
                        if k != "device_ops"},
        }

    def split_run(self, cfg, params, prompts):
        """The six requests once more with each part of a decode step
        bracketed by synchronisations: the page-table FIND (`apply_hash`
        in `lookup_and_gather`), the gather, the forward, the append, the
        bookkeeping (`txn_bookkeep`) and the sampling.  Returns the median
        ms of each part over the plain decode steps and over the steps
        with a crossing."""
        torch, pk = self.torch, self.pk
        eng = self.new_engine(cfg, params)
        parts = {}
        saved = {}

        def timed(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                parts[name] = parts.get(name, 0.0) + \
                    (time.perf_counter() - t) * 1e3
                return out
            return run

        in_fused = [False]
        orig_fused = eng._fused_step

        def fused(*a):
            in_fused[0] = True
            try:
                return orig_fused(*a)
            finally:
                in_fused[0] = False

        orig_hash = pk._hash_apply
        timed_find = timed("find", orig_hash)

        def hash_apply(*a, **kw):
            return (timed_find if in_fused[0] else orig_hash)(*a, **kw)

        for name, attr in (("gather", "gather_fn"),
                           ("append", "append_token_fn"),
                           ("bookkeeping", "txn_bookkeep")):
            saved[attr] = getattr(pk, attr)
            setattr(pk, attr, timed(name, saved[attr]))
        saved["_hash_apply"] = orig_hash
        pk._hash_apply = hash_apply
        eng._fused_step = fused
        eng._decode_batch = timed("forward", eng._decode_batch)
        eng._sample = timed("sample", eng._sample)
        P = SERVE_ENGINE["page_size"]
        rows = []
        try:
            self.submit_all(eng, prompts)
            while True:
                live = [s for s in eng.slots if s.active]
                crossing = any(s.pos % P == 0 for s in live)
                quiet = not eng._pending_retire and (
                    len(live) == len(eng.slots) or not eng.pending())
                parts.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                n = eng.step()
                torch.cuda.synchronize()
                total = (time.perf_counter() - t) * 1e3
                if not n and not eng.pending():
                    break
                if live and quiet and len(live) == n:
                    rows.append((("crossing" if crossing else "decode")
                                 + f"_b{n}", dict(parts, step=total)))
        finally:
            for attr, fn in saved.items():
                setattr(pk, attr, fn)
        out = {}
        for kind in sorted({k for k, _ in rows}):
            sel = [p for k, p in rows if k == kind]
            names = sorted({n for p in sel for n in p})
            out[kind] = {n: statistics.median(p.get(n, 0.0) for p in sel)
                         for n in names}
            out[kind]["steps"] = len(sel)
        return out


def serving_phase(smoke, tk, launches_main):
    """Phase 11, the paged-KV server: glm4_9b at full width on the card
    (weights drawn on the card from a seeded generator), the checked run
    with the launch counts reset just before it and read just after (the
    four round kernels, through the BigQueue rings, and
    `flash_attention_wgmma`, through the prefills, must have run; their
    launches join `launches_main`), the dense comparison, the prefill's
    attention route, the fp32 layouts, then the timed and the split
    runs."""
    torch = smoke.torch
    from repro_torch import configs
    from repro_torch.core import cachehash
    from repro_torch.launch import steps
    from repro_torch.models import attention, transformer
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import engine as serving_engine
    from repro_torch.serving import paged_kv
    t0 = time.perf_counter()
    sp = ServingPhase(smoke, (configs, transformer, steps, serving_engine,
                              paged_kv, attention, cachehash))
    cfg = configs.get_config(SERVE_ARCH)
    t = time.perf_counter()
    params = transformer.init_params(cfg, seed=SERVE_SEED, device=smoke.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[serving] {SERVE_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}, hd "
        f"{cfg.hd}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}: "
        f"{n_params / 1e9:.2f} G parameters "
        f"({n_params * 2 / 2 ** 30:.1f} GiB) drawn on the card in "
        f"{init_s:.1f} s")
    prompts = sp.requests(cfg, SERVE_SEED + 1)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t = time.perf_counter()
    out, by_pos, steps_seen, _ = sp.checked_run(cfg, params, prompts)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t
    serve_launches = {k: v for k, v in tk.launch_counts().items() if v}
    for kname in ROUND_KERNELS + (WGMMA,):
        if not serve_launches.get(kname):
            raise SystemExit(f"serving: {kname} never launched on the path")
        launches_main[kname] += serve_launches[kname]
    log(f"[serving] checked run in {checked_s:.1f} s: {steps_seen}; page "
        f"table equal to the numpy model after every step, no page mapped "
        f"twice, every page back on the free ring; launches "
        f"{serve_launches}")
    t = time.perf_counter()
    dense = sp.dense_compare(cfg, params, prompts, out, by_pos)
    del by_pos
    log(f"[serving] paged decode vs the dense path (make_prefill_step + "
        f"make_serve_step, teacher-forced): {dense['positions']} positions "
        f"within {SERVE_ATOL} + {SERVE_RTOL} |want|, max abs err "
        f"{dense['max_abs_err']:.4f}; tokens equal at the "
        f"{dense['tokens_held_by_margin']} positions whose dense margin "
        f"exceeds twice that ({time.perf_counter() - t:.1f} s)")
    route = sp.prefill_route(cfg, SERVE_SEED + 2)
    smoke.max_err[WGMMA] = max(smoke.max_err[WGMMA], route["max_abs_err"])
    log(f"[serving] prefill attention at t = {route['t']}: kernel route "
        f"(flash_attention_wgmma) within the bf16 tolerance of the plain "
        f"pair-list version, max abs err {route['max_abs_err']:.2e}; "
        f"{route['kernel_ms']:.4f} ms device (bound {route['bound_ms']:.4f}: "
        f"bytes {route['bytes_ms']:.4f} / FLOPs {route['flops_ms']:.4f}), "
        f"plain {route['plain_ms']:.3f} ms, sdpa {route['library_ms']:.4f} "
        f"ms")
    t = time.perf_counter()
    fp32 = sp.fp32_layouts(SERVE_SEED + 3)
    log(f"[serving] reduced fp32 deepseek_7b engine on {', '.join(STRATEGIES)}: "
        f"greedy tokens ({fp32} per request) equal the dense path's "
        f"({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    pipelined = sp.pipelined(cfg, params, prompts, out)
    pipe_launches = pipelined["launches"]
    for kname in ROUND_KERNELS + (WGMMA,):
        if not pipe_launches.get(kname):
            raise SystemExit(f"serving: {kname} never launched in "
                             "run_pipelined")
        launches_main[kname] += pipe_launches[kname]
    log(f"[serving] run_pipelined (runtime.Executor: admission and decode "
        f"as two streams) tokens identical to run_to_completion and the "
        f"checked run: " + ", ".join(
            f"{name} {r['wall_s']:.2f} s ({r['tokens_per_s']:.1f} tokens/s, "
            f"{r['dispatches']} fused decode dispatches)"
            for name, r in pipelined["runs"].items())
        + f"; launches {pipe_launches} ({time.perf_counter() - t:.1f} s)")
    timing = sp.timed_run(cfg, params, prompts)
    log(f"[serving-timing] prefill ms (t): " + ", ".join(
        f"{r['ms']:.1f} ({r['t']})" for r in timing["prefill_ms"]))
    log(f"[serving-timing] decode step {timing['decode_step_ms']} ms "
        f"(median, 4 live; by live rows "
        f"{timing['decode_step_ms_by_live']}), with a crossing "
        f"{timing['crossing_step_ms']} ms, "
        f"with admissions {timing['admission_step_ms']} ms; steps "
        f"{timing['steps']}; tokens/s {timing['tokens_per_s']:.1f} over the "
        f"run ({timing['new_tokens']} tokens in {timing['wall_s']:.2f} s), "
        f"{timing['decode_tokens_per_s']} in plain decode steps")
    log(f"[serving-timing] host reads per step {timing['host_reads']} "
        f"(a decode step and one with one crossing equal to the CPU's pinned "
        f"{SERVE_HOST_READS})")
    log(f"[serving-timing] host syncs per step {timing['host_syncs']}, "
        f"decode by live rows {timing['host_syncs_decode_by_live']}, by "
        f"crossings {timing['host_syncs_by_crossings']}; a plain decode "
        f"step profiled: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in timing["profile"].items()}))
    split = sp.split_run(cfg, params, prompts)
    for kind, row in split.items():
        log(f"[serving-timing] split of a {kind} step (median ms, "
            f"synchronised): " + json.dumps(
                {k: round(v, 3) for k, v in row.items()}))
    del params
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    log(f"[serving] phase in {phase_s:.1f} s")
    return {"arch": SERVE_ARCH, "engine": SERVE_ENGINE,
            "prompts": list(SERVE_PROMPTS), "new_tokens": SERVE_NEW,
            "n_params": n_params, "init_s": init_s, "checked_s": checked_s,
            "steps": steps_seen, "launches": serve_launches,
            "dense": dense, "tolerance": [SERVE_ATOL, SERVE_RTOL],
            "prefill_route": route, "fp32_layouts": fp32,
            "pipelined": pipelined, "timing": timing, "split": split,
            "tokens": out, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# Phase 11b: the sharded server on two gloo ranks sharing the card
# (serving over core/distributed.py: the sharded page table and rings,
# txn.map.transact_dist).
# ---------------------------------------------------------------------------

SHARD_RANKS = 2                  # processes on the one card, gloo between
SHARD_PG_TIMEOUT_S = 120         # each collective of the world
SHARD_WORLD_TIMEOUT_S = 600      # the whole world, seen from the parent
SHARD_STRATEGY = "cached_me"
SHARD_PREFILL_BATCHES = 32       # of the cachehash phase's 128: load 1/8
SHARD_QUEUE = {"enqueue": 32, "dequeue": 16, "mixed": 32}


# Sharded training (after the sharded serving, in the same world):
# glm4_9b at its published width cut to SHARD_TRAIN_LAYERS of 40 layers,
# phase 14's TRAIN_LAYERS: both ranks' train state (bf16 params, fp32
# moments, one store slot, the update's new state: ~32 B a parameter,
# half of it a rank) and their activations fit the card beside each
# other at 4 layers, 35.1 GiB a rank (PERF.md section 4).
SHARD_TRAIN_LAYERS = 4
SHARD_TRAIN_STEPS = 3
SHARD_TRAIN_SEED = 14500
SHARD_TRAIN_MESH = (1, 2)              # (data, model)
SHARD_DP_MESH = (2, 1)
SHARD_DP_SHAPE = (128, 8)              # (t, global b), reduced glm4_9b fp32
# Step 1 (the same parameters on both runs): the mesh sums each cut
# product's bf16 partials over 'model' in fp32 and rounds once, as the
# one-device product rounds its fp32 sum once, so an activation may
# differ by a bf16 rounding: the loss and grad norm within one, 2^-8
# relative.  The first AdamW step starts from zero moments, so it moves
# every parameter by lr sign(g), and a parameter whose bf16 gradient has
# the other sign on the other run ends 2 lr away: steps 2 and 3 compare
# two trajectories, not one sum, and are held within 2^-4 (the
# 4-layer card run: 3e-3 in the loss, 2.3e-2 in the grad norm at step 3,
# a loss spike of norm 43).
SHARD_BF16_RTOL = (2 ** -8, 2 ** -4)   # step 1, later steps
SHARD_FP32_RTOL = (1e-5, 1e-5)         # fp32: sums in other orders only


class _Timed:
    """`torch.distributed`'s collectives wrapped to sum the host time of
    those on `group` (a card sync first, so the time is the collective's:
    gloo stages card tensors through the host)."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single")

    def __init__(self, torch, tdist, group):
        self.torch, self.tdist, self.group = torch, tdist, group
        self.s, self.calls, self.saved = 0.0, 0, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.tdist, name)

            def timed(*a, _fn=fn, **kw):
                if kw.get("group") is not self.group:
                    return _fn(*a, **kw)
                self.torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **kw)
                self.s += time.perf_counter() - t
                self.calls += 1
                return out
            setattr(self.tdist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.tdist, name, fn)
        return False


def _train_record(torch, hist, t0, held) -> dict:
    torch.cuda.synchronize()
    warm = hist["step_time"][1:] or hist["step_time"]
    ms = statistics.median(warm) * 1e3
    return {"loss": hist["loss"], "grad_norm": hist["grad_norm"],
            "step_ms": [x * 1e3 for x in hist["step_time"]],
            "step_ms_median_warm": ms, "call_s": time.perf_counter() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30}


def sharded_training(torch, rank, tk, timeout) -> dict:
    """Sharded training on phase 11b's world (see the module docstring):
    the one-device glm4_9b run on rank 0, the (1, 2) tensor-parallel run
    on both ranks with its launches, heads and slices checked on each, an
    instrumented step, and the (2, 1) data-parallel run on the reduced
    config beside rank 0's one-device run of it."""
    import gc

    import torch.distributed as tdist
    from repro_torch import configs, dist
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import distributed as dsb
    from repro_torch.data import DataPipeline, to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig

    def fail(what):
        raise SystemExit(f"sharded-training: rank {rank}: {what}")

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              n_layers=SHARD_TRAIN_LAYERS)
    shape = Shape("train_4k", TRAIN_T, TRAIN_B, "train")
    opt = AdamWConfig(**dict(TRAIN_OPT, total_steps=SHARD_TRAIN_STEPS))
    kw = dict(steps=SHARD_TRAIN_STEPS, seed=SHARD_TRAIN_SEED, opt_cfg=opt,
              snapshot_slots=1, log_every=1)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    held = free()           # every rank: the serving models' memory freed
    out = {"layers": SHARD_TRAIN_LAYERS, "steps": SHARD_TRAIN_STEPS,
           "held_at_start_gib": held / 2 ** 30}
    if rank == 0:                   # alone on the card: the other waits
        t0 = time.perf_counter()
        hist = train(cfg, shape, device="cuda", **kw)[2]     # state freed
        out["one"] = _train_record(torch, hist, t0, held)
    tdist.barrier()
    mesh = dsb.make_mesh(SHARD_TRAIN_MESH, ("data", "model"),
                         device="cuda", timeout=timeout)
    calls = []
    plain = attn_mod.flash_attention

    def recorded(q, k, v, **akw):
        calls.append((q.shape[2], k.shape[2],
                      attn_mod.kernel_route(q, **{
                          n: akw[n] for n in ("softcap", "score_dtype")
                          if n in akw})))
        return plain(q, k, v, **akw)
    held = free()
    attn_mod.flash_attention = recorded
    try:
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, hist = train(cfg, shape, mesh=mesh, **kw)
        tp = _train_record(torch, hist, t0, held)
        tp["launches"] = {k: v for k, v in tk.launch_counts().items() if v}
    finally:
        attn_mod.flash_attention = plain
    n = SHARD_TRAIN_LAYERS * SHARD_TRAIN_STEPS
    m = SHARD_TRAIN_MESH[1]
    want = {WGMMA: 2 * n, BWD["bfloat16"]: n, BWD["float32"]: None}
    if any(tp["launches"].get(k) != v for k, v in want.items()):
        fail(f"launches {tp['launches']}, expected {want}")
    heads = (cfg.n_heads // m, cfg.n_kv_heads // m, True)
    if len(calls) != 2 * n or any(c != heads for c in calls):
        fail(f"attention calls (query heads, kv heads, kernel route) "
             f"{sorted(set(calls))} x {len(calls)}, expected {heads} x "
             f"{2 * n}")
    tp["heads"] = list(heads[:2])
    for leaf in tree_leaves((params, state)):
        whole = math.prod(leaf.shape)
        if leaf.placement.dim is not None and leaf.local.numel() * m != whole:
            fail(f"a stored slice of {leaf.shape} holds "
                 f"{leaf.local.numel()} elements, not 1/{m}")
    tp["state_gib_rank"] = sum(x.local.numel() * x.local.element_size()
                               for x in tree_leaves((params, state))) / 2 ** 30
    # one more step, its 'model' collectives timed
    batch = to_device(DataPipeline(cfg, shape, seed=SHARD_TRAIN_SEED)
                      .batch(SHARD_TRAIN_STEPS), "cuda")
    step = make_train_step(cfg, opt)
    with dist.axis_rules(mesh, dist.make_rules(cfg, mesh)), \
            _Timed(torch, tdist, mesh.groups["model"]) as timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = step(params, state, batch)
        torch.cuda.synchronize()
        tp["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
    tp["collective_ms"], tp["collectives"] = timed.s * 1e3, timed.calls
    out["tp"] = tp
    del params, state, new, batch
    # data parallel on the reduced config
    rcfg = dataclasses.replace(configs.get_config(TRAIN_ARCH, reduced=True),
                               param_dtype="float32", compute_dtype="float32")
    rshape = Shape("train", *SHARD_DP_SHAPE, "train")
    held = free()
    if rank == 0:
        t0 = time.perf_counter()
        hist = train(rcfg, rshape, device="cuda", **kw)[2]
        out["dp_one"] = _train_record(torch, hist, t0, held)
    tdist.barrier()
    mesh2 = dsb.make_mesh(SHARD_DP_MESH, ("data", "model"), device="cuda",
                          timeout=timeout)
    held, t0 = free(), time.perf_counter()
    hist = train(rcfg, rshape, mesh=mesh2, **kw)[2]
    out["dp"] = _train_record(torch, hist, t0, held)
    free()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    return out


def sync_warnings(caught) -> int:
    return sum("called a synchronizing" in str(w.message) for w in caught)


def map_check(torch, mesh, mods, n_shards, seed, dev):
    """`txn.map.transact_dist` on `HashSpec(2**22, vw=2, p_max=16384)`
    sharded `n_shards` ways, beside the one-device `transact` on the same
    table: both prefilled with the cachehash phase's first
    `SHARD_PREFILL_BATCHES` batches, then the txn phase's map cases (T =
    4096 read-modify-write txns on disjoint keys, R = W = 2; one hot
    counter, T = 64, which must take T rounds).  Every `MapResult` field
    equal bit for bit, the read sets equal to `transact_reference`
    replaying the claimed order, the contents equal.  Returns ms and host
    syncs of each call (`set_sync_debug_mode("warn")`) and the rounds."""
    dsb, ch, tmap = mods
    rng = np.random.default_rng(seed)
    prefill, _ = HashPhase(SimpleNamespace(torch=torch), ch).batches(seed)
    prefill = prefill[:SHARD_PREFILL_BATCHES]
    spec = ch.HashSpec(HASH_NB, HASH_VW, SHARD_STRATEGY, p_max=HASH_Q)
    dspec = dsb.DistSpec(spec, "shard", n_shards, HASH_Q // n_shards)
    dst = dsb.init_dist(mesh, dspec)
    one = ch.init_hash(spec, device=dev)
    t0 = time.perf_counter()
    for kind, keys, vals in prefill:
        ops = ch.make_hash_ops(kind, keys, vals, vw=HASH_VW, device=dev)
        dst, res, ovf = dsb.apply_hash_global(mesh, dspec, dst, ops,
                                              donate=True)
        one, res1, _ = ch.apply_hash(spec, one, ops, donate=True)
        if bool(ovf.any()) or not torch.equal(res.found, res1.found):
            raise SystemExit("map: a sharded prefill batch differs from the "
                             "one-device one")
    torch.cuda.synchronize()
    out = {"prefill_s": time.perf_counter() - t0,
           "prefill_keys": len(prefill) * HASH_Q, "runs": {}}
    pk = np.concatenate([b[1] for b in prefill])
    pv = np.concatenate([b[2] for b in prefill])
    chosen = rng.choice(len(pk), 2 * MAP_T, replace=False)
    hot_key = np.uint32(rng.integers(0, 2 ** 32))
    while np.isin(hot_key, pk):
        hot_key = np.uint32(rng.integers(0, 2 ** 32))
    model = {int(k): v for k, v in zip(pk[chosen], pv[chosen])}
    for name, keys, fn in (
            ("disjoint_rmw", pk[chosen].reshape(MAP_T, 2), map_fn_increment),
            ("hot_counter", np.full((MAP_HOT_T, 1), hot_key, np.uint32),
             map_fn_sum_plus_one)):
        txns = tmap.make_map_txns(keys, keys, vw=HASH_VW, device=dev)
        row = {"t": len(keys)}
        for how in ("dist", "one"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    if how == "dist":
                        dst, res = tmap.transact_dist(mesh, dspec, dst,
                                                      txns, fn)
                    else:
                        one, res1 = tmap.transact(spec, one, txns, fn)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            row[f"{how}_ms"] = (time.perf_counter() - t) * 1e3
            row[f"{how}_host_syncs"] = sync_warnings(caught)
        for field, a, b in zip(res._fields, res, res1):
            if not torch.equal(a.cpu(), b.cpu()):
                raise SystemExit(f"map/{name}: transact_dist's {field} "
                                 "differs from transact's")
        model, rv, rf = tmap.transact_reference(
            model, txns, fn, tmap.linearization_order(res), HASH_VW)
        if not (np.array_equal(res.read_value.cpu().numpy().view(np.uint32),
                               rv) and
                np.array_equal(res.read_found.cpu().numpy(), rf)):
            raise SystemExit(f"map/{name}: read sets differ from "
                             "transact_reference")
        row["rounds"] = int(res.rounds)
        out["runs"][name] = row
    if out["runs"]["hot_counter"]["rounds"] != MAP_HOT_T or \
            list(model[int(hot_key)]) != [MAP_HOT_T] * HASH_VW:
        raise SystemExit(f"map/hot_counter: {out['runs']['hot_counter']}, "
                         f"counter {model[int(hot_key)]}")
    got = dsb.hash_items(dspec, dst)
    keys = np.fromiter(got, np.uint32, len(got))
    order = np.argsort(keys)
    values = np.stack([got[int(k)] for k in keys[order]])
    want_k, want_v = ch.contents(one, inline=True, vw=HASH_VW)
    o = np.argsort(want_k)
    if not (np.array_equal(keys[order], want_k[o]) and
            np.array_equal(values, want_v[o])):
        raise SystemExit("map: the sharded contents differ from transact's")
    for k, v in model.items():
        if not np.array_equal(got[k], v):
            raise SystemExit(f"map: key {k} holds {got[k]}, the model {v}")
    out["entries"] = len(got)
    return out


SRT_P_LOCAL = 1024               # p_global 2048 at 2 shards: phase 12's width
SRT_FAULT = {"streams": 4, "n_batches": 6, "loss_round": 3,
             "checkpoint_every": 2}
SRT_FACTORS = (1, 4)             # S = 2 and 8 at RT_SLOTS: x_of_f1
SRT_LL_SLOT, SRT_STORE_SLOT = 12345, 4000000


def history_digest(history) -> str:
    """One hash of an executor history (stream, seq, ops, claimed order,
    overflow, value, success of every issue): equal on two ranks iff
    their journals are."""
    h = hashlib.sha256()
    for r in history:
        h.update(np.asarray([r.stream, r.seq], np.int64).tobytes())
        for x in (*r.ops, r.order, r.overflow, r.value, r.success):
            h.update(b"-" if x is None else np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


class Marks:
    """Host-clock spans of wrapped functions (`wrap(obj, attr, label)`),
    recorded while `on`; `restore()` puts every function back."""

    def __init__(self):
        self.spans, self.on, self._saved = [], False, []

    def wrap(self, obj, attr, label):
        fn = getattr(obj, attr)
        self._saved.append((obj, attr, fn))

        def run(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((label, t, time.perf_counter()))
        setattr(obj, attr, run)

    def restore(self):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        self._saved.clear()

    def total(self, label, lo=0.0, hi=float("inf")) -> float:
        return sum(b - a for name, a, b in self.spans
                   if name == label and a >= lo and b <= hi)

    def within(self, label):
        return [(a, b) for name, a, b in self.spans if name == label]


class ShardedRuntime:
    """The sharded runtime on one rank of phase 11b's world (see
    `sharded_runtime`): `runtime.DistTarget` over
    `DistSpec(AtomicSpec(2**22, 4, layout), "shard", 2, 1024)`."""

    def __init__(self, torch, mesh, mods, timeout):
        self.torch, self.mesh, self.dev = torch, mesh, mesh.device
        self.rt, self.dsb, self.atomics = mods
        self.timeout = timeout
        self.one = None                  # the (1, 2) mesh, made at the loss

    def fail(self, what):
        raise SystemExit(f"sharded-runtime: {what}")

    def spec(self, strategy):
        return self.atomics.AtomicSpec(N, K, strategy, p_max=RT_P)

    def factory(self, strategy):
        """n_surviving -> (mesh, dspec): the two-shard mesh, or after the
        loss one shard replicated on both ranks, mesh (1, 2)."""
        def make(n_surviving):
            if n_surviving >= SHARD_RANKS:
                return self.mesh, self.dsb.DistSpec(
                    self.spec(strategy), "shard", SHARD_RANKS, SRT_P_LOCAL)
            if self.one is None:                # every rank, same point
                self.one = self.dsb.make_mesh(
                    (1, SHARD_RANKS), ("shard", "rest"), device=self.dev,
                    timeout=self.timeout)
            return self.one, self.dsb.DistSpec(
                self.spec(strategy), "shard", 1, SHARD_RANKS * SRT_P_LOCAL)
        return make

    def table(self, target):
        return (self.torch_words(self.dsb.logical(target.dspec,
                                                  target.state)),
                self.torch_words(self.dsb.versions(target.dspec,
                                                   target.state)))

    @staticmethod
    def torch_words(t):
        return t.cpu().numpy().view(np.uint32)

    def streams(self, n_streams, n_batches, seed):
        hot_cells, hot_frac = RT_MIXES["hot"]
        return [self.rt.SyntheticStream(
            f"s{i}", seed=seed + i, n=N, k=K, width=RT_P,
            n_batches=n_batches, hot_cells=hot_cells, hot_frac=hot_frac)
            for i in range(n_streams)]

    def replay_equal(self, ex, init, what):
        t = time.perf_counter()
        oracle = self.rt.replay_history(N, K, [RT_P] * len(ex.streams),
                                        ex.history, initial=init)
        logical, versions = self.table(ex.target)
        if not (np.array_equal(oracle.data, logical)
                and np.array_equal(oracle.version, versions)):
            self.fail(f"{what}: the table differs from the replay of its "
                      "history")
        return time.perf_counter() - t

    def faulted(self, strategy, si):
        """S = 4 streams of 6 hot batches, slots 1, factor 4, a shard loss
        mid-round 3 (after two issues), `checkpoint_every=2`: the
        recovery onto one shard on both ranks, its split, the replay."""
        rt, torch = self.rt, self.torch
        rng = np.random.default_rng(12000 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        make = self.factory(strategy)
        mesh, dspec = make(SHARD_RANKS)
        target = rt.DistTarget(mesh, dspec, init, mesh_factory=make)
        f = SRT_FAULT
        ex = rt.Executor(
            target, self.streams(f["streams"], f["n_batches"], 700 + si),
            slots=1, oversubscription=4,
            checkpoint_every=f["checkpoint_every"],
            injector=rt.FaultInjector([rt.Fault(
                round=f["loss_round"], kind="shard_loss", shard=1,
                after_issues=2)]))
        marks = Marks()
        from repro_torch.runtime import executor as ex_mod
        for obj, attr, label in ((ex, "_recover", "recover"),
                                 (ex, "_load_ck", "restore"),
                                 (ex, "checkpoint", "checkpoint"),
                                 (target, "shrink", "reshard"),
                                 (self.dsb, "logical", "gather"),
                                 (self.dsb, "versions", "gather")):
            marks.wrap(obj, attr, label)
        marks.on = True
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            rep = ex.run()
            torch.cuda.synchronize()
        finally:
            marks.on = False
            marks.restore()
        wall = time.perf_counter() - t
        (rec,) = rep["recoveries"] or [None]
        if rec is None or rec["n_shards"] != 1 or target.width != RT_P \
                or target.dspec.p_global != RT_P:
            self.fail(f"{strategy}: recoveries {rep['recoveries']}, width "
                      f"{target.width}")
        replay_s = self.replay_equal(ex, init, f"{strategy} faulted")
        (r0, r1), = marks.within("recover")
        (s0, s1), = marks.within("reshard")
        ck = [(a, b) for a, b in marks.within("checkpoint") if r0 <= a <= r1]
        restore = marks.total("restore", r0, r1)
        gather = marks.total("gather", s0, s1)
        post_ck = ck[-1][1] - ck[-1][0]
        normal_ck = [b - a for a, b in marks.within("checkpoint")
                     if not r0 <= a <= r1]
        return {"wall_s": wall, "issues": rep["issues"],
                "rounds": rep["rounds"], "checkpoints": rep["checkpoints"],
                "recovery": {k: v for k, v in rec.items()},
                "split_s": {"restore": restore, "reshard": s1 - s0,
                            "reshard_gather": gather,
                            "reshard_rebuild": (s1 - s0) - gather,
                            "journal_replay": (r1 - r0) - restore
                            - (s1 - s0) - post_ck,
                            "post_recovery_checkpoint": post_ck,
                            "total": r1 - r0},
                "checkpoint_s": normal_ck,
                "digest": history_digest(ex.history), "replay_s": replay_s}

    def clean(self, strategy, si):
        """No fault, hot, phase 12's streams and table at factor 1 (S = 2)
        and 4 (S = 8), slots 2, 96 batches: a timed run each (its issues'
        host time split into prepare, route, round, return and
        all_gather), then at factor 4 a run with every host sync and read
        counted; the factor-4 history replayed."""
        rt, torch, dsb = self.rt, self.torch, self.dsb
        rng = np.random.default_rng(12000 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        out = {}
        for factor in SRT_FACTORS:
            n_streams = RT_SLOTS * factor
            seed = 100 * si + 10 * factor

            def executor():
                make = self.factory(strategy)
                mesh, dspec = make(SHARD_RANKS)
                return rt.Executor(
                    rt.DistTarget(mesh, dspec, init, mesh_factory=make),
                    self.streams(n_streams, RT_BATCHES // n_streams, seed),
                    slots=RT_SLOTS, oversubscription=factor)
            ex = executor()
            marks = Marks()
            for obj, attr, label in ((ex.target, "issue", "issue"),
                                     (dsb, "apply", "apply"),
                                     (dsb, "_local_round", "round"),
                                     (dsb, "_gather_lanes", "all_gather")):
                marks.wrap(obj, attr, label)
            marks.on = True
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                rep = ex.run()
                torch.cuda.synchronize()
            finally:
                marks.on = False
                marks.restore()
            wall = time.perf_counter() - t
            issues = rep["issues"]
            if issues != RT_BATCHES:
                self.fail(f"{strategy} f{factor}: {issues} issues")
            apply_s = marks.total("apply")
            round_s = marks.total("round")
            route_s = sum(r0 - a0 for (a0, _), (r0, _) in zip(
                marks.within("apply"), marks.within("round")))
            row = {"streams": n_streams, "wall_s": wall,
                   "mops_s": RT_BATCHES * RT_P / wall / 1e6,
                   "issue_ms": marks.total("issue") / issues * 1e3,
                   "split_ms": {
                       "prepare": (marks.total("issue") - apply_s
                                   - marks.total("all_gather")) / issues
                       * 1e3,
                       "route": route_s / issues * 1e3,
                       "round": round_s / issues * 1e3,
                       "return": (apply_s - route_s - round_s) / issues
                       * 1e3,
                       "all_gather": marks.total("all_gather") / issues
                       * 1e3}}
            if factor == SRT_FACTORS[-1]:
                row["replay_s"] = self.replay_equal(ex, init,
                                                    f"{strategy} f{factor}")
                row["digest"] = history_digest(ex.history)
                want = self.table(ex.target)
                del ex
                ex = executor()
                with warnings.catch_warnings(record=True) as caught, \
                        counting_host_reads(torch) as reads:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        ex.run()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                got = self.table(ex.target)
                if not (np.array_equal(got[0], want[0])
                        and np.array_equal(got[1], want[1])):
                    self.fail(f"{strategy} f{factor}: the counted run "
                              "ended in another table")
                row["host_syncs_per_issue"] = sync_warnings(caught) \
                    / RT_BATCHES
                row["host_reads_per_issue"] = reads["n"] / RT_BATCHES
            out[f"f{factor}_hot"] = row
            del ex
        out["x_of_f1"] = out[f"f{SRT_FACTORS[-1]}_hot"]["mops_s"] \
            / out["f1_hot"]["mops_s"]
        return out

    def reshard(self, strategy, si):
        """`reshard_dist` 2 -> 1 -> 2 at n = 2**22: an LL of one cell and a
        STORE to another first, values and versions equal after each hop,
        then the SC with the link taken before the trip succeeds; each
        hop's time split into gather and rebuild."""
        dsb, torch, at = self.dsb, self.torch, self.atomics
        from repro_torch.runtime import elastic
        rng = np.random.default_rng(12400 + si)
        init = rng.integers(0, 2 ** 32, (N, K), dtype=np.uint32)
        make = self.factory(strategy)
        mesh, dspec = make(SHARD_RANKS)
        st = dsb.init_dist(mesh, dspec, init)
        kind = np.full(RT_P, at.IDLE, np.int32)
        slot = np.zeros(RT_P, np.int32)
        desired = np.zeros((RT_P, K), np.uint32)
        kind[0], slot[0] = at.LL, SRT_LL_SLOT
        kind[1], slot[1], desired[1] = at.STORE, SRT_STORE_SLOT, 77
        st, ctx, _, _ = dsb.apply_global(mesh, dspec, st, at.make_ops(
            kind, slot, desired=desired, k=K, device=self.dev))
        want = (dsb.logical(dspec, st), dsb.versions(dspec, st))
        hops = []
        for n_surv in (1, SHARD_RANKS):
            mesh2, dspec2 = make(n_surv)
            marks = Marks()
            for attr in ("logical", "versions"):
                marks.wrap(dsb, attr, "gather")
            marks.on = True
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                st = elastic.reshard_dist(dspec, st, dspec2, mesh2)
                torch.cuda.synchronize()
            finally:
                marks.on = False
                marks.restore()
            total = time.perf_counter() - t
            mesh, dspec = mesh2, dspec2
            got = (dsb.logical(dspec, st), dsb.versions(dspec, st))
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                self.fail(f"{strategy}: reshard to {dspec.n_shards} "
                          "shard(s) changed values or versions")
            hops.append({"n_shards": dspec.n_shards, "s": total,
                         "gather_s": marks.total("gather"),
                         "rebuild_s": total - marks.total("gather")})
        kind = np.full(RT_P, at.IDLE, np.int32)
        kind[0], desired[0] = at.SC, 55
        st, ctx, res, _ = dsb.apply_global(mesh, dspec, st, at.make_ops(
            kind, slot, desired=desired, k=K, device=self.dev), ctx)
        if not bool(res.success[0]):
            self.fail(f"{strategy}: the LL link taken before the 2 -> 1 -> "
                      "2 trip did not commit after it")
        return {"hops": hops, "bytes": N * K * 4 + N * 4}


def sharded_runtime(torch, mesh, mods, tk, timeout) -> dict:
    """The sharded-runtime phase on one rank of phase 11b's world: per
    lock-free layout the faulted run, the clean runs and the reshard trip
    (`ShardedRuntime`), the launch counts reset just before and read just
    after: rows 1-2b must have launched."""
    sr = ShardedRuntime(torch, mesh, mods, timeout)
    out = {"layouts": {}}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for si, strategy in enumerate(STRATEGIES):
        out["layouts"][strategy] = {
            "faulted": sr.faulted(strategy, si),
            "clean": sr.clean(strategy, si),
            "reshard": sr.reshard(strategy, si)}
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out["launches"] = {k: v for k, v in tk.launch_counts().items() if v}
    for kname in ROUND_KERNELS:
        if not out["launches"].get(kname):
            sr.fail(f"{kname} never launched on the path")
    out["phase_s"] = time.perf_counter() - t0
    return out


class ShardedRank:
    """One rank of phase 11b's world (`sharded_rank_main`): the sharded
    `BigQueue` against the one-device one, `transact_dist` against
    `transact`, then glm4_9b served through `ServingEngine(mesh=...)` with
    the counts reset just before and read just after, and (rank 0 alone,
    the other rank waiting) without the mesh."""

    def __init__(self, torch, mesh, mods):
        self.torch, self.mesh, self.dev = torch, mesh, mesh.device
        (self.dsb, self.ch, self.tmap, self.queue_mod, self.serving,
         self.pk, self.core_engine) = mods

    def fail(self, what):
        raise SystemExit(f"sharded: {what}")

    def queue(self, seed):
        """`BigQueue(4096, k=2, p_max=64)` sharded over the mesh and on one
        device, the same calls: enqueue, dequeue, then a contended batch
        of half ENQ, half DEQ lanes; payloads, success, rounds, the commit
        log, `len` and the ring's cells equal.  ms of each call."""
        torch, dsb, Q = self.torch, self.dsb, self.queue_mod
        rng = np.random.default_rng(seed)
        kw = dict(capacity=QUEUE_CAPACITY, k=QUEUE_K,
                  strategy=SHARD_STRATEGY, p_max=QUEUE_LANES)
        shq = Q.BigQueue(**kw, mesh=self.mesh, n_shards=SHARD_RANKS)
        oneq = Q.BigQueue(**kw, device=self.dev)
        m = SHARD_QUEUE["mixed"]
        mixed = rng.permutation(np.repeat([Q.ENQ, Q.DEQ], m // 2)).astype(
            np.int32)
        calls = {
            "enqueue": (np.full(SHARD_QUEUE["enqueue"], Q.ENQ, np.int32),
                        rng.integers(0, 2 ** 32, (SHARD_QUEUE["enqueue"], 1),
                                     dtype=np.uint32)),
            "dequeue": (np.full(SHARD_QUEUE["dequeue"], Q.DEQ, np.int32),
                        None),
            "mixed": (mixed, rng.integers(0, 2 ** 32, (m, 1),
                                          dtype=np.uint32))}
        out = {}
        for name, (kinds, values) in calls.items():
            got = {}
            for how, q in (("sharded", shq), ("one", oneq)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got[how] = q.run_batch(kinds, values)
                torch.cuda.synchronize()
                out.setdefault(name, {})[f"{how}_ms"] = \
                    (time.perf_counter() - t) * 1e3
            for a, b in zip(got["sharded"], got["one"]):
                if not np.array_equal(a, b):
                    self.fail(f"queue {name}: the sharded ring's results "
                              "differ from the one-device ring's")
            out[name]["rounds"] = int(got["one"][2])
            out[name]["lanes"] = len(kinds)
        view = dsb.DistSpec(shq._dist_inner, "shard", SHARD_RANKS, 1)
        cells = dsb.logical(view, shq._dstate)[:oneq._tspec.n]
        if shq.commit_log != oneq.commit_log or len(shq) != len(oneq) or \
                not torch.equal(cells, self.core_engine.logical(
                    oneq._tspec, oneq.state)):
            self.fail("queue: commit log, length or ring cells differ")
        return out

    def serve(self, cfg, params, prompts, mesh):
        """The six requests through `ServingEngine` (with `mesh`, sharded)
        on `SHARD_STRATEGY`: every step timed with CUDA events, the decode
        steps' page-table FIND too, split (sharded) into route (to the
        owner's `cachehash.apply_hash`), round (that call), return (back
        to the issuing rank) and the all_gather of the results.  Checks
        one fused dispatch a decode step, every page back on the ring and
        the table empty at the end.  Returns the tokens and the times."""
        torch, pk, dsb = self.torch, self.pk, self.dsb
        eng = self.serving.ServingEngine(cfg, params, mesh=mesh,
                                         strategy=SHARD_STRATEGY,
                                         device=self.dev, **SERVE_ENGINE)
        for rid, prompt in enumerate(prompts):
            eng.submit(self.serving.Request(rid=rid, prompt=prompt,
                                            max_new_tokens=SERVE_NEW))
        marks, in_fused = [], [False]

        def mark(name):
            if in_fused[0]:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))

        def around(fn, before, after):
            def run(*a, **kw):
                mark(before)
                out = fn(*a, **kw)
                mark(after)
                return out
            return run

        orig_fused = eng._fused_step

        def fused(*a):
            in_fused[0] = True
            try:
                return orig_fused(*a)
            finally:
                in_fused[0] = False

        saved = [(pk, "_hash_apply"), (dsb, "apply_hash"),
                 (dsb.ch, "apply_hash")]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr in saved]
        pk._hash_apply = around(saved[0][2], "find", "find_end")
        dsb.apply_hash = around(saved[1][2], "route", "gather")
        dsb.ch.apply_hash = around(saved[2][2], "round", "return")
        eng._fused_step = fused
        P = SERVE_ENGINE["page_size"]
        rows, decode_steps = [], 0
        try:
            while True:
                live = [s for s in eng.slots if s.active]
                crossing = sum(s.pos % P == 0 for s in live)
                admits = eng.pending() and len(live) < len(eng.slots)
                pending = bool(eng._pending_retire)
                done = sum(r.done for r in eng.requests.values())
                marks.clear()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                n = eng.step()
                b.record()
                b.synchronize()
                if not n and not eng.pending():
                    break
                decode_steps += n > 0
                kind = ("admission" if admits else "retire_flush" if
                        pending else "retire" if sum(
                            r.done for r in eng.requests.values()) > done
                        else "crossing" if crossing else "decode")
                row = {"kind": kind, "live": n, "ms": a.elapsed_time(b)}
                times = dict((name, ev) for name, ev in marks)
                if "find" in times:
                    row["find_ms"] = times["find"].elapsed_time(
                        times["find_end"])
                if "route" in times:
                    for part, (x, y) in {"route": ("route", "round"),
                                         "round": ("round", "return"),
                                         "return": ("return", "gather"),
                                         "gather": ("gather", "find_end")
                                         }.items():
                        row[f"{part}_ms"] = times[x].elapsed_time(times[y])
                rows.append(row)
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        if eng.dispatch_count != decode_steps:
            self.fail(f"{eng.dispatch_count} fused dispatches over "
                      f"{decode_steps} decode steps")
        if mesh is not None:
            view = dsb.DistSpec(eng.paged.spec.table, "shard", SHARD_RANKS,
                                1)
            left = dsb.hash_items(view, eng.paged.state.table)
        else:
            left = self.ch.items(eng.paged.state.table, inline=True, vw=1)
        if left or len(eng.paged.free) != SERVE_ENGINE["n_pages"]:
            self.fail(f"{len(left)} pages still mapped, "
                      f"{len(eng.paged.free)} on the free ring")
        tokens = {rid: r.out_tokens for rid, r in eng.requests.items()}

        def med(key, kind="decode"):
            vals = [r[key] for r in rows if r["kind"] == kind
                    and r["live"] == SERVE_ENGINE["max_batch"] and key in r]
            return statistics.median(vals) if vals else None
        return tokens, {
            "decode_step_ms": med("ms"), "crossing_step_ms":
                med("ms", "crossing"), "admission_step_ms":
                med("ms", "admission"),
            "find_ms": med("find_ms"),
            "find_split_ms": {p: med(f"{p}_ms") for p in
                              ("route", "round", "return", "gather")},
            "steps": {k: sum(r["kind"] == k for r in rows) for k in
                      ("decode", "crossing", "admission", "retire",
                       "retire_flush")},
            "dispatches": eng.dispatch_count}


def sharded_rank_main(argv) -> int:
    """One rank of phase 11b: `python3 chip_smoke.py --sharded-rank RANK
    PORT OUT_DIR`, started by `sharded_phase` (the kernels already built);
    writes OUT_DIR/sharded_rank<RANK>.json."""
    import datetime

    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(SRC))
    from repro_torch import atomics, configs, runtime
    from repro_torch import kernels as tk
    from repro_torch.core import cachehash as ch
    from repro_torch.core import distributed as dsb
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.models import transformer
    from repro_torch.serving import engine as serving_engine
    from repro_torch.serving import paged_kv
    from repro_torch.sync import queue
    from repro_torch.txn import map as txn_map
    rank, port, out_dir = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.cuda.set_device(0)
    timeout = datetime.timedelta(seconds=SHARD_PG_TIMEOUT_S)
    tdist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=SHARD_RANKS, timeout=timeout)
    try:
        mesh = dsb.make_mesh((SHARD_RANKS,), ("shard",), device="cuda",
                             timeout=timeout)
        for name in _build.SIGNATURES:
            _build.load(name)
        sr = ShardedRank(torch, mesh, (dsb, ch, txn_map, queue,
                                       serving_engine, paged_kv, engine))
        out = {"rank": rank, "card": torch.cuda.get_device_name(0)}
        t = time.perf_counter()
        out["queue"] = sr.queue(17000)
        out["queue_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["map"] = map_check(torch, mesh, (dsb, ch, txn_map), SHARD_RANKS,
                               17100, mesh.device)
        out["map_s"] = time.perf_counter() - t
        out["runtime"] = sharded_runtime(
            torch, mesh, (runtime, dsb, atomics), tk, timeout)
        cfg = configs.get_config(SERVE_ARCH)
        params = transformer.init_params(cfg, seed=SERVE_SEED,
                                         device=mesh.device)
        rng = np.random.default_rng(SERVE_SEED + 1)
        prompts = [rng.integers(0, cfg.vocab, t).astype(np.int32)
                   for t in SERVE_PROMPTS]
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t = time.perf_counter()
        out["tokens"], out["mesh"] = sr.serve(cfg, params, prompts, mesh)
        torch.cuda.synchronize()
        out["launches"] = {k: v for k, v in tk.launch_counts().items() if v}
        out["mesh_s"] = time.perf_counter() - t
        group = mesh.groups["shard"]
        if rank == 0:                   # alone on the card: no contention
            t = time.perf_counter()
            out["tokens_one"], out["one"] = sr.serve(cfg, params, prompts,
                                                     None)
            out["one_s"] = time.perf_counter() - t
        tdist.barrier(group=group)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, sr
        t = time.perf_counter()
        out["training"] = sharded_training(torch, rank, tk, timeout)
        out["training"]["training_s"] = time.perf_counter() - t
        (out_dir / f"sharded_rank{rank}.json").write_text(json.dumps(out))
    finally:
        tdist.destroy_process_group()
    return 0


def sharded_training_check(trains, launches_main) -> dict:
    """Phase 11b's sharded training, from each rank's `sharded_training`
    record: the (1, 2) run's losses and grad norms within SHARD_BF16_RTOL
    of rank 0's one-device run, the (2, 1) run's within SHARD_FP32_RTOL of
    its one-device run, the ranks' losses equal, rows 1-2b launched on
    each rank; the (1, 2) run's launches join `launches_main`.  Returns
    them, per rank."""
    card = card_line()
    one, dp_one = trains[0]["one"], trains[0]["dp_one"]
    for r, tr in enumerate(trains):
        for run, want, rtol in (("tp", one, SHARD_BF16_RTOL),
                                ("dp", dp_one, SHARD_FP32_RTOL)):
            for key in ("loss", "grad_norm"):
                got = tr[run][key]
                if len(got) != SHARD_TRAIN_STEPS or not all(
                        math.isfinite(x)
                        and abs(x - w) <= rtol[i > 0] * abs(w)
                        for i, (x, w) in enumerate(zip(got, want[key]))):
                    raise SystemExit(
                        f"sharded-training: rank {r}'s {run} {key} {got} "
                        f"against one device's {want[key]} (rtol {rtol})")
        if tr["tp"]["loss"] != trains[0]["tp"]["loss"]:
            raise SystemExit("sharded-training: the ranks read other losses")
        for kname in ROUND_KERNELS:
            if not tr["tp"]["launches"].get(kname):
                raise SystemExit(f"sharded-training: rank {r} never "
                                 f"launched {kname} (the store's publish)")
    train_launches = {kname: [tr["tp"]["launches"].get(kname, 0)
                              for tr in trains]
                      for kname in ROUND_KERNELS + (WGMMA, BWD["bfloat16"])}
    for kname, per_rank in train_launches.items():
        launches_main[kname] = launches_main.get(kname, 0) + sum(per_rank)
    tb = TRAIN_B * TRAIN_T
    log(f"[sharded-training] {card} | {TRAIN_ARCH} {SHARD_TRAIN_LAYERS} of "
        f"40 layers, b {TRAIN_B}, t {TRAIN_T}, bf16, remat, {SHARD_TRAIN_STEPS}"
        f" steps; one device (rank 0 alone): losses "
        f"{[round(x, 4) for x in one['loss']]}, grad norms "
        f"{[round(x, 4) for x in one['grad_norm']]}, "
        f"{one['step_ms_median_warm']:.1f} ms a step (warm median; all "
        f"{[round(x, 1) for x in one['step_ms']]}), "
        f"{tb / one['step_ms_median_warm'] * 1e3:.0f} tokens/s, peak "
        f"{one['peak_gib']:.2f} GiB")
    for r, tr in enumerate(trains):
        tp = tr["tp"]
        log(f"[sharded-training] {card} | rank {r} at (data, model) = "
            f"{SHARD_TRAIN_MESH}: losses {[round(x, 4) for x in tp['loss']]}"
            f", grad norms {[round(x, 4) for x in tp['grad_norm']]} (within "
            f"{SHARD_BF16_RTOL} of one device's), "
            f"{tp['step_ms_median_warm']:.1f} ms a step (all "
            f"{[round(x, 1) for x in tp['step_ms']]}), "
            f"{tb / tp['step_ms_median_warm'] * 1e3:.0f} tokens/s, peak "
            f"{tp['peak_gib']:.2f} GiB above {tr['held_at_start_gib']:.2f} "
            f"held, state {tp['state_gib_rank']:.2f} GiB;"
            f" heads (query, kv) {tp['heads']}; launches {tp['launches']}; "
            f"an instrumented step {tp['timed_step_ms']:.1f} ms, its "
            f"{tp['collectives']} 'model' collectives "
            f"{tp['collective_ms']:.1f} ms of host time; data parallel "
            f"{SHARD_DP_MESH} reduced fp32: losses "
            f"{[round(x, 6) for x in tr['dp']['loss']]} (one device "
            f"{[round(x, 6) for x in dp_one['loss']]}), "
            f"{tr['dp']['step_ms_median_warm']:.1f} ms a step; training part "
            f"{tr['training_s']:.1f} s")
    return train_launches


def sharded_phase(smoke, tk, launches_main, want_tokens):
    """Phase 11b: `SHARD_RANKS` processes on the card, one gloo world
    (collectives on card tensors, staged through the host; NCCL takes one
    card a rank), each running `ShardedRank` with its own copy of the
    weights.  Fails on a rank that fails or a world that outlives
    `SHARD_WORLD_TIMEOUT_S`, on ranks that disagree, on sharded tokens
    that differ from the serving phase's (`want_tokens`, the engine
    without a mesh on the same weights and requests) or from rank 0's
    engine without a mesh, and on a kernel of rows 1-2b or 7a that a rank
    never launched in its sharded run.  The ranks' launches join
    `launches_main`."""
    import gc
    torch = smoke.torch
    gc.collect()        # the serving phase's weights, held in cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[sharded] {held:.2f} GiB held on the card by this process")
    out_dir = ROOT / "chiprun_out"
    for r in range(SHARD_RANKS):
        (out_dir / f"sharded_rank{r}.json").unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("BIGATOMIC_OBS", "BIGATOMIC_GUARD")}
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(out_dir / f"sharded_rank{r}.log", "w")
            for r in range(SHARD_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
         str(r), str(port), str(out_dir)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(SHARD_RANKS)]
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rcs) or \
                    time.perf_counter() - t0 > SHARD_WORLD_TIMEOUT_S:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        rcs = [p.wait() for p in procs]
        for f in logs:
            f.close()
    world_s = time.perf_counter() - t0
    if any(rcs):
        tails = "\n".join(
            f"-- rank {r} (rc {rc}):\n" +
            (out_dir / f"sharded_rank{r}.log").read_text()[-3000:]
            for r, rc in enumerate(rcs))
        raise SystemExit(f"sharded: the world failed after {world_s:.1f} s "
                         f"(return codes {rcs}; {SHARD_WORLD_TIMEOUT_S} s "
                         f"allowed):\n{tails}")
    recs = [json.loads((out_dir / f"sharded_rank{r}.json").read_text())
            for r in range(SHARD_RANKS)]

    def tokens(d):
        return {int(k): list(v) for k, v in d.items()}
    want = tokens(want_tokens)
    for r, rec in enumerate(recs):
        if tokens(rec["tokens"]) != want:
            diff = [rid for rid in want
                    if tokens(rec["tokens"]).get(rid) != want[rid]]
            raise SystemExit(f"sharded: rank {r}'s tokens of requests {diff} "
                             "differ from the engine's without a mesh")
        for kname in ROUND_KERNELS + (WGMMA,):
            if not rec["launches"].get(kname):
                raise SystemExit(f"sharded: rank {r} never launched {kname} "
                                 "in its sharded run")
    if tokens(recs[0]["tokens_one"]) != want:
        raise SystemExit("sharded: rank 0's engine without a mesh gave "
                         "other tokens than the serving phase's")
    for key in ("queue", "map"):
        if any(rec[key].keys() != recs[0][key].keys() for rec in recs):
            raise SystemExit(f"sharded: ranks ran other {key} cases")
    launches = {kname: [rec["launches"][kname] for rec in recs]
                for kname in ROUND_KERNELS + (WGMMA,)}
    for kname, per_rank in launches.items():
        launches_main[kname] += sum(per_rank)
    train_launches = sharded_training_check(
        [rec["training"] for rec in recs], launches_main)
    rts = [rec["runtime"] for rec in recs]
    for strategy in STRATEGIES:
        a, b = (rt["layouts"][strategy] for rt in rts)
        for what in ("faulted", "clean"):
            da = a[what].get("digest") or a[what]["f4_hot"]["digest"]
            db = b[what].get("digest") or b[what]["f4_hot"]["digest"]
            if da != db:
                raise SystemExit(f"sharded-runtime: {strategy} {what}: the "
                                 "ranks' histories differ")
    rt_launches = {kname: [rt["launches"][kname] for rt in rts]
                   for kname in ROUND_KERNELS}
    for kname, per_rank in rt_launches.items():
        launches_main[kname] += sum(per_rank)
    r0 = recs[0]
    log(f"[sharded] {SHARD_RANKS} gloo ranks on the card (collectives on "
        f"card tensors staged through the host), world in {world_s:.1f} s; "
        f"BigQueue({QUEUE_CAPACITY}, k={QUEUE_K}) sharded equal to one "
        "device: " + "; ".join(
            f"{name} {c['lanes']} lanes {c['rounds']} rounds "
            f"{c['sharded_ms']:.1f} ms (one device {c['one_ms']:.1f})"
            for name, c in r0["queue"].items()))
    m = r0["map"]
    log(f"[sharded] transact_dist at {SHARD_RANKS} shards equal to transact "
        f"and transact_reference (prefill {m['prefill_keys']} keys "
        f"{m['prefill_s']:.1f} s, {m['entries']} entries equal): " + "; ".join(
            f"{name} T={r['t']} rounds {r['rounds']} {r['dist_ms']:.1f} ms "
            f"(transact {r['one_ms']:.1f}), host syncs {r['dist_host_syncs']} "
            f"({r['one_host_syncs']})" for name, r in m["runs"].items()))
    for rec in recs:
        msh = rec["mesh"]
        log(f"[sharded] rank {rec['rank']}: glm4_9b through "
            f"ServingEngine(mesh=) on {SHARD_STRATEGY}, tokens equal to the "
            f"engine without a mesh; launches {rec['launches']}; decode step "
            f"{msh['decode_step_ms']} ms (4 live), crossing "
            f"{msh['crossing_step_ms']}, admission "
            f"{msh['admission_step_ms']}; FIND {msh['find_ms']} ms, split "
            f"{json.dumps(msh['find_split_ms'])}; steps {msh['steps']}; "
            f"peak {rec['peak_gib']:.1f} GiB")
    one = r0["one"]
    log(f"[sharded] rank 0 without a mesh (the other rank waiting): decode "
        f"step {one['decode_step_ms']} ms, crossing "
        f"{one['crossing_step_ms']}, admission {one['admission_step_ms']}; "
        f"FIND {one['find_ms']} ms")
    card = card_line()
    for strategy in STRATEGIES:
        for r, rt in enumerate(rts):
            lay = rt["layouts"][strategy]
            f, c, h = lay["faulted"], lay["clean"], lay["reshard"]
            log(f"[sharded-runtime] {card} | rank {r} {strategy}: faulted "
                f"S={SRT_FAULT['streams']} {f['issues']} issues in "
                f"{f['wall_s']:.2f} s, recovery {f['recovery']} split s "
                + json.dumps(f["split_s"]) + f", checkpoints s "
                f"{[round(x, 4) for x in f['checkpoint_s']]}, replayed equal "
                f"in {f['replay_s']:.2f} s; clean " + "; ".join(
                    f"{name} S={row['streams']} {row['mops_s']:.4f} Mops/s "
                    f"issue {row['issue_ms']:.3f} ms split ms "
                    + json.dumps(row["split_ms"])
                    for name, row in c.items() if name.startswith("f"))
                + f"; x_of_f1 {c['x_of_f1']:.3f}; host syncs / reads per "
                f"issue {c['f4_hot']['host_syncs_per_issue']} / "
                f"{c['f4_hot']['host_reads_per_issue']}; reshard 2 -> 1 -> 2 "
                + json.dumps(h["hops"]))
    log(f"[sharded-runtime] {card} | both ranks' histories equal on every "
        f"layout; phase {[round(rt['phase_s'], 1) for rt in rts]} s; "
        f"launches per rank {rt_launches}")
    return {"ranks": SHARD_RANKS, "transport": "gloo, card tensors staged "
            "through the host", "world_s": world_s, "launches": launches,
            "runtime_launches": rt_launches,
            "training_launches": train_launches, "parent_held_gib": held,
            "per_rank": recs}


# ---------------------------------------------------------------------------
# Phase 13: the model families (models/moe.py, ssm.py, rglru.py) served
# through launch.steps (make_prefill_step + make_serve_step).
# ---------------------------------------------------------------------------

class FamilyCase(NamedTuple):
    arch: str
    layers: int           # depth kept of the config's published depth
    b: int
    t: int                # prompt length
    dtype: str
    kernel: str | None    # the attention kernel its prefill launches


# Published widths; depth cut only where the weights would not fit the
# card's 80 GB: mixtral's 32 layers are ~93 GB in bf16, one layer of
# llama4's 128 experts ~32 GB (two layers with the embeddings ~69 GB);
# in fp32 mixtral keeps 2 layers and recurrentgemma one period (rglru,
# rglru, attn): ~13 and ~10 GB.
FAMILY_CASES = {
    # t > window 4096: the prefill keeps a ring cache; cf 1.25, C = 1920
    "mixtral_8x7b": FamilyCase("mixtral_8x7b", 16, 1, 6144, "bfloat16",
                               WGMMA),
    # the same in fp32 at 2 layers (~13 GB): decode held to the full
    # forward where bf16 noise cannot move an expert; 3xTF32 at hd 128
    "mixtral_8x7b_fp32": FamilyCase("mixtral_8x7b", 2, 1, 6144, "float32",
                                    TF32X3),
    # 128 experts, top-1, C = 40
    "llama4_maverick_400b_a17b": FamilyCase(
        "llama4_maverick_400b_a17b", 1, 2, 2048, "bfloat16", WGMMA),
    # 8 chunks of 256: the inter-chunk scan runs; no attention
    "mamba2_780m": FamilyCase("mamba2_780m", 48, 2, 2048, "bfloat16",
                              None),
    # the same in fp32 (~3 GB): the SSD decode held to 1e-3
    "mamba2_780m_fp32": FamilyCase("mamba2_780m", 48, 2, 2048, "float32",
                                   None),
    # t > window 2048; hd 256 on the wgmma kernel
    "recurrentgemma_9b": FamilyCase("recurrentgemma_9b", 38, 2, 3072,
                                    "bfloat16", WGMMA),
    # the fp32 3xTF32 kernel past hd 128 (row 7c) on a client path
    "recurrentgemma_9b_fp32": FamilyCase("recurrentgemma_9b", 3, 1, 4096,
                                         "float32", TF32X3),
}
FAMILY_SEED = 13000
FAMILY_STEPS = 8                     # greedy decode steps a config
# Decode against the full forward over the same tokens, (atol, rtol,
# row): |got - want| <= atol + rtol |want| + row * rms(want's row); tokens
# must agree wherever the full forward's top-2 margin exceeds twice the
# bound.  The bounds lie between what a sound decode and a faulty one read
# (`families_probe.py` plants the faults; a reading is the row factor the
# worst position needs, H100 80GB HBM3 at 700 W).  bf16: the serving
# phase's SERVE_ATOL + SERVE_RTOL |want| alone fails sound runs (mamba2,
# 48 layers: each rounds the residual to bf16 after another sum, and its
# tied embedding of scale 1 gives logits an RMS of ~35), so a row term:
# 2^-4, above the largest sound reading (mamba2 0.040; the others < 0.001)
# and below the smallest fault one (mamba2 with the SSD state not written
# back 0.078, with no recurrent entry written back 2.0).  recurrentgemma's
# 38 bf16 layers dilute a stale RG-LRU state below bf16 noise (both faults
# read 0); its fp32 twin catches both (errors 0.0017 and 0.098 against
# 3.9e-5 sound).  fp32: 1e-3 + 1e-3 |want| (cuBLAS's products at M = 1 and
# M = t + 8 and the 3xTF32 attention differ by ~1e-5 relative).
FAMILY_TOL = {"bfloat16": (SERVE_ATOL, SERVE_RTOL, 2 ** -4),
              "float32": (1e-3, 1e-3, 0.0)}
# MoE: a position's decode is compared with the full forward only where
# every layer chose the same experts for it.  At the reference's scales
# (expert weights 1/sqrt(E)) a MoE layer's output has an RMS of ~7.7e3, so
# the bf16 residual rounds in steps of hundreds: the router's
# probabilities in decode and in the full forward differ by up to 0.0105
# (mixtral, 16 layers), two experts that close may trade places, and the
# position's logits then differ by O(1) (a row reading of 1.5).  A
# position whose expert sets differ is exempt only if, at the first layer
# where they do, the full forward's k-th and (k+1)-th probabilities are
# within ROUTE_NOISE of its dtype: bf16 0.02, about twice that noise
# (moves seen at gaps to 0.0047), so a wrong expert at a gap under it is
# not seen in bf16 (one planted at 0.0195 passed); fp32 1e-4, 26 times
# the fp32 noise (3.8e-6): a wrong expert planted at a gap of 0.0234 fails
# there.
ROUTE_NOISE = {"bfloat16": 0.02, "float32": 1e-4}
# One MoE layer at mixtral's full width in fp32, on the card against the
# port on the CPU: routing equal wherever each token's gaps between its
# top k + 1 probabilities exceed MOE_MARGIN (ranks, keeps and dests up to
# the first token that does not); outputs within MOE_TOL = (a, r):
# a * rms(want) + r |want| (sums of 4096 and 14336 fp32 products in other
# orders).
MOE_LAYER_SHAPE = (2, 128)           # b, s: 256 tokens
MOE_MARGIN = 1e-6
MOE_TOL = (1e-4, 1e-4)


class FamiliesPhase:
    """Phase 13: mixtral_8x7b, llama4_maverick_400b_a17b, mamba2_780m and
    recurrentgemma_9b (bf16; mixtral, mamba2 and recurrentgemma also in
    fp32) at their published widths through `make_prefill_step` +
    `make_serve_step` (see `families_phase`)."""

    def __init__(self, smoke, mods):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        (self.configs, self.tm, self.steps, self.moe, self.ssm,
         self.common) = mods

    def fail(self, what):
        raise SystemExit(f"families: {what}")

    def config(self, case):
        return dataclasses.replace(
            self.configs.get_config(case.arch), n_layers=case.layers,
            param_dtype=case.dtype, compute_dtype=case.dtype)

    def case(self, name, case, seed):
        """Weights drawn on the card; the served run (prefill, then
        FAMILY_STEPS greedy decode steps) with the launch counts reset
        just before and read just after; then the decode held to the full
        forward."""
        torch = self.torch
        cfg = self.config(case)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()     # by the earlier phases
        t = time.perf_counter()
        params = self.tm.init_params(cfg, seed=seed, device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        leaves = self.common.tree_leaves(params)
        n_params = sum(x.numel() for x in leaves)
        weight_gib = sum(x.numel() * x.element_size() for x in leaves) \
            / 2 ** 30
        del leaves
        prompt = self.prompt(cfg, case, seed)
        served = self.served_run(cfg, params, prompt)
        served_peak = torch.cuda.max_memory_allocated()
        n_attn = sum(k == "attn" for k in cfg.layer_kinds)
        launched = served["launches"]
        if case.kernel is not None and launched.get(case.kernel) != n_attn:
            self.fail(f"{name}: {launched.get(case.kernel, 0)} launches of "
                      f"{case.kernel}, not one per attention layer "
                      f"({n_attn})")
        if case.kernel is None and launched:
            self.fail(f"{name}: launched {launched} without attention")
        cfg_c, rows, routes = cfg, served["rows"], None
        if cfg.is_moe:
            cfg_c, rows, routes = self.decode_rows(cfg, params, prompt,
                                                   served["tokens"])
        check = self.consistency(cfg_c, params, prompt, served["tokens"],
                                 rows, FAMILY_TOL[case.dtype], name, routes)
        peak = torch.cuda.max_memory_allocated()
        del params, rows, served["rows"]
        torch.cuda.empty_cache()
        steps_ms = served["step_ms"]
        return {
            "config": {"arch": case.arch, "layers": case.layers,
                       "published_layers": self.configs.get_config(
                           case.arch).n_layers,
                       "d_model": cfg.d_model, "dtype": case.dtype,
                       "b": case.b, "t": case.t},
            "n_params": n_params, "weight_gib": weight_gib,
            "init_s": init_s,
            "prefill_ms": served["prefill_ms"],
            "prefill_cold_ms": served["prefill_cold_ms"],
            "decode_ms": steps_ms, "decode_profile": served["profile"],
            "decode_ms_median": statistics.median(steps_ms),
            "decode_tokens_per_s": case.b * len(steps_ms)
            / (sum(steps_ms) / 1e3),
            "prefill_tokens_per_s": case.b * case.t
            / (served["prefill_ms"] / 1e3),
            "peak_gib_served": (served_peak - held) / 2 ** 30,
            "peak_gib": (peak - held) / 2 ** 30,
            "held_by_earlier_phases_gib": held / 2 ** 30,
            "launches": launched, "tokens": served["tokens"].tolist(),
            "consistency": check}

    def prompt(self, cfg, case, seed):
        rng = np.random.default_rng(seed)
        return self.torch.as_tensor(rng.integers(
            0, cfg.vocab, (case.b, case.t)).astype(np.int32)).to(self.dev)

    def decode_rows(self, cfg, params, prompt, tokens):
        """(the config checked, the rows, the routing log or None): the
        prefill's and each decode step's logits, teacher-forced with
        `tokens`.  MoE: the full forward drops tokens and decode does not,
        so the prefill and decode run dropless, to be held to a dropless
        full forward, with each layer's expert choices logged."""
        if not cfg.is_moe:
            return cfg, self.teacher_forced(cfg, params, prompt, tokens), None
        cfg = dataclasses.replace(cfg, moe_dropless=True)
        with self.routing_log() as routes:
            rows = self.teacher_forced(cfg, params, prompt, tokens)
        return cfg, rows, routes

    def served_run(self, cfg, params, prompt):
        """make_prefill_step, then FAMILY_STEPS greedy make_serve_step
        steps, each synchronised and timed on the host clock; the counts
        reset just before and read just after.  Returns the prefill's and
        each step's logits (fp32, for the consistency check), the tokens
        fed ([b, FAMILY_STEPS]) and the times."""
        torch, tk = self.torch, self.s.tk
        b, t = prompt.shape
        prefill = self.steps.make_prefill_step(cfg, max_len=t + FAMILY_STEPS)
        serve = self.steps.make_serve_step(cfg)
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompt})          # warm-up, not counted
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        rows, toks, step_ms = [logits[:, -1].float()], [], []
        for d in range(FAMILY_STEPS):
            toks.append(tok)
            t0 = time.perf_counter()
            logits, cache = serve(params, cache, {
                "tokens": tok[:, None],
                "pos": torch.full((b,), t + d, dtype=torch.int32,
                                  device=self.dev)})
            tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(logits[:, 0].float())
        launches = {k: v for k, v in tk.launch_counts().items() if v}
        # the last step again, three times from its cache, profiled
        batch = {"tokens": tok[:, None],
                 "pos": torch.full((b,), t + FAMILY_STEPS - 1,
                                   dtype=torch.int32, device=self.dev)}
        prof = self.s.device_busy(
            lambda: (serve(params, cache, batch), torch.cuda.synchronize()),
            reps=3, trace=ROOT / "chiprun_out" / "family_trace.tmp.json")
        del cache, logits
        return {"prefill_ms": prefill_ms, "prefill_cold_ms": cold_ms,
                "step_ms": step_ms, "rows": rows,
                "tokens": torch.stack(toks, 1), "launches": launches,
                "profile": {k: v for k, v in prof.items()
                            if k not in ("device_ops", "device_ops_by_call")}}

    def teacher_forced(self, cfg, params, prompt, tokens):
        """The prefill's and each decode step's logits with `tokens` fed."""
        torch = self.torch
        b, t = prompt.shape
        logits, cache = self.steps.make_prefill_step(
            cfg, max_len=t + FAMILY_STEPS)(params, {"tokens": prompt})
        rows = [logits[:, -1].float()]
        serve = self.steps.make_serve_step(cfg)
        for d in range(tokens.shape[1]):
            logits, cache = serve(params, cache, {
                "tokens": tokens[:, d:d + 1],
                "pos": torch.full((b,), t + d, dtype=torch.int32,
                                  device=self.dev)})
            rows.append(logits[:, 0].float())
        return rows

    @contextlib.contextmanager
    def routing_log(self):
        """Log each `moe.route` call's expert choices and router
        probabilities (one entry a MoE layer, in order) while the block
        runs."""
        torch, moe = self.torch, self.moe
        entries, route = [], moe.route

        def logged(xg, router_w, cfg, C):
            r = route(xg, router_w, cfg, C)
            probs = torch.softmax(torch.matmul(xg.float(),
                                               router_w.float()), -1)
            entries.append((r.expert_idx.reshape(-1, cfg.top_k),
                            probs.reshape(-1, probs.shape[-1])))
            return r
        moe.route = logged
        try:
            yield entries
        finally:
            moe.route = route

    def consistency(self, cfg, params, prompt, tokens, rows, tol, name,
                    routes=None):
        """`forward(mode="train")` over the prompt and the fed tokens (an
        SSD stack padded to a multiple of its chunk: positions after the
        last compared one change nothing before it): its logits at
        positions t - 1 ... t + FAMILY_STEPS - 1 against the prefill's and
        the decode steps'.  With `routes` (MoE: the decode's routing log),
        positions whose experts differ somewhere are exempt as
        ROUTE_NOISE says."""
        torch = self.torch
        b, t = prompt.shape
        seq = torch.cat([prompt, tokens], 1)
        if "ssm" in cfg.layer_kinds:
            pad = (-seq.shape[1]) % self.ssm.CHUNK
            seq = torch.nn.functional.pad(seq, (0, pad))
        with (self.routing_log() if routes is not None
              else contextlib.nullcontext()) as full_routes:
            full, _, _ = self.tm.forward(params, cfg, {"tokens": seq},
                                         mode="train")
        n = tokens.shape[1] + 1
        want = full[:, t - 1:t - 1 + n].float()
        del full
        got = torch.stack(rows, 1)
        moved = torch.zeros((b, n), dtype=torch.bool, device=got.device)
        route_out = {}
        if routes is not None:
            moved, route_out = self.moved_positions(
                cfg, routes, full_routes, b, t, seq.shape[1], n, name)
        atol, rtol, row = tol
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        bound = atol + rtol * want.abs() + row * rms
        raw = (got - want).abs()
        # the row factor each position would need to pass: the reading
        # that FAMILY_TOL's row term is set against
        need = ((raw - atol - rtol * want.abs()).clamp(min=0) / rms).amax(-1)
        err = torch.where(moved[..., None], 0.0, raw)
        if not torch.isfinite(got).all() or bool((err > bound).any()):
            bad = (err > bound).nonzero()[:4].tolist()
            self.fail(f"{name}: decode differs from the full forward by "
                      f"{float(err.max()):.4f} (at [b, step, vocab] {bad})")
        top2 = torch.topk(want, 2, dim=-1)
        margin = top2.values[..., 0] - top2.values[..., 1]
        held = (margin > 2 * torch.gather(bound, -1, top2.indices[..., :1])
                [..., 0]) & ~moved
        same = got.argmax(-1) == top2.indices[..., 0]
        if bool((held & ~same).any()):
            self.fail(f"{name}: greedy tokens differ from the full forward "
                      f"at {(held & ~same).nonzero().tolist()}")
        return {"max_abs_err": float(err.max()),
                "max_abs_err_by_step": err.amax((0, 2)).tolist(),
                "row_reading": float(need[~moved].max()),
                "row_reading_moved": float(need[moved].max())
                if bool(moved.any()) else None,
                "rms_err": float(err[~moved].pow(2).mean().sqrt()),
                "logits_rms": float(rms.mean()),
                "positions": int(b * n),
                "positions_compared": int((~moved).sum()),
                "tokens_held_by_margin": int(held.sum()),
                "tolerance": list(tol), "full_forward_t": seq.shape[1],
                **route_out}

    def moved_positions(self, cfg, dec_log, full_log, b, t, T, n, name):
        """[b, n] bool: the positions whose expert sets differ at some MoE
        layer between the decode (prefill's last row, then each step) and
        the full forward (T tokens a row), each allowed only if the full
        forward's k-th and (k+1)-th probabilities are within the dtype's
        ROUTE_NOISE at the first such layer.  With the gaps seen there."""
        torch = self.torch
        L, k = len(full_log), cfg.top_k
        if len(dec_log) != L * n:
            self.fail(f"{name}: {len(dec_log)} routing entries for the "
                      f"decode, not {L} x {n}")
        # decode: the prefill's rows b * t + t - 1, then one row a step
        pos = torch.arange(b, device=self.dev) * t + t - 1
        sel = [pos if j == 0 else slice(None)
               for j in range(n) for _ in range(L)]
        dec_idx, dec_p = (
            torch.stack([e[f][s] for e, s in zip(dec_log, sel)])
            .view(n, L, b, -1).permute(2, 0, 1, 3) for f in (0, 1))
        rows = (torch.arange(b, device=self.dev)[:, None] * T + t - 1
                + torch.arange(n, device=self.dev)[None]).reshape(-1)
        full_idx = torch.stack([e[0][rows] for e in full_log])  # [L, b*n, k]
        full_p = torch.stack([e[1][rows] for e in full_log])    # [L, b*n, E]
        full_idx = full_idx.view(L, b, n, k).permute(1, 2, 0, 3)
        full_p = full_p.view(L, b, n, -1).permute(1, 2, 0, 3)
        differ = (dec_idx.sort(-1).values
                  != full_idx.sort(-1).values).any(-1)          # [b, n, L]
        moved = differ.any(-1)
        first = differ.int().argmax(-1)                          # [b, n]
        top = full_p.sort(-1, descending=True).values[..., k - 1:k + 1]
        gap = (top[..., 0] - top[..., 1]).gather(-1, first[..., None])[..., 0]
        gaps = gap[moved]
        limit = ROUTE_NOISE[cfg.compute_dtype]
        # the router's noise: the largest difference between the decode's
        # and the full forward's probabilities at the layers where both
        # still chose alike, and at the first where they did not
        upto = (torch.arange(L, device=self.dev)
                <= torch.where(moved, first, L - 1)[..., None])  # [b, n, L]
        noise = (dec_p - full_p).abs().amax(-1)[upto].max()
        if bool((gaps > limit).any()):
            self.fail(f"{name}: the decode chose other experts than the "
                      f"full forward where their probabilities were "
                      f"{gaps.max():.4f} apart (> {limit})")
        return moved, {"positions_moved_by_routing": int(moved.sum()),
                       "first_moved_layer": first[moved].tolist(),
                       "moved_gaps": gaps.tolist(),
                       "router_noise": float(noise)}

    def moe_layer(self, seed):
        """One MoE layer at mixtral_8x7b's full width (d 4096, f 14336, 8
        experts, top-2) in fp32 on the card against the same port on the
        CPU, in capacity dispatch (cf 1.25), with two groups, and
        dropless."""
        torch, moe = self.torch, self.moe
        base = dataclasses.replace(self.configs.get_config("mixtral_8x7b"),
                                   param_dtype="float32",
                                   compute_dtype="float32")
        d, f, E = base.d_model, base.d_ff, base.n_experts
        gen = torch.Generator(device=self.dev).manual_seed(seed)

        def draw(shape):
            return self.common.dense_init(gen, shape, torch.float32,
                                          device=self.dev)
        w = {"router": draw((d, E)), "w_gate": draw((E, d, f)),
             "w_up": draw((E, d, f)), "w_down": draw((E, f, d))}
        b, s = MOE_LAYER_SHAPE
        x = torch.randn((b, s, d), generator=gen, device=self.dev)
        w_cpu = {k: v.cpu() for k, v in w.items()}
        x_cpu = x.cpu()
        out = {}
        for mode, cfg in (("capacity", base),
                          ("groups", dataclasses.replace(base,
                                                         moe_groups=2)),
                          ("dropless", base)):
            dropless = mode == "dropless"
            G, C = moe.group_capacity(cfg, b * s, dropless)
            runs = []
            for xx, ww in ((x, w), (x_cpu, w_cpu)):
                r = moe.route(xx.reshape(G, -1, d), ww["router"], cfg, C)
                y, _ = moe.moe_ffn(xx, ww["router"], ww["w_gate"],
                                   ww["w_up"], ww["w_down"], cfg,
                                   dropless=dropless)
                runs.append((r, y.reshape(G, -1, d).cpu()))
            (rd, yd), (rc, yc) = runs
            # each token's smallest gap between its top k + 1 probabilities
            probs = torch.softmax(x_cpu.reshape(G, -1, d) @ w_cpu["router"],
                                  -1)
            top = torch.sort(probs, -1, descending=True).values[
                ..., :cfg.top_k + 1]
            margin = (top[..., :-1] - top[..., 1:]).min(-1).values  # [G, Tg]
            clear = margin > MOE_MARGIN
            # tokens compared per group: those before its first near tie
            first = [c.numel() if bool(c.all())
                     else int((~c).nonzero()[0, 0]) for c in clear]
            if not bool((rd.expert_idx.cpu() == rc.expert_idx)[clear].all()):
                self.fail(f"moe layer {mode}: expert_idx differs on the card")
            max_err, rms = 0.0, float(yc.pow(2).mean().sqrt())
            for g, n in enumerate(first):
                for field in ("rank", "keep", "dest"):
                    a = getattr(rd, field)[g, :n].cpu()
                    if not torch.equal(a, getattr(rc, field)[g, :n]):
                        self.fail(f"moe layer {mode}: {field} differs on "
                                  f"the card (group {g})")
                err = (yd[g, :n] - yc[g, :n]).abs()
                bound = MOE_TOL[0] * rms + MOE_TOL[1] * yc[g, :n].abs()
                if not torch.isfinite(yd).all() or bool((err > bound).any()):
                    self.fail(f"moe layer {mode}: output differs from the "
                              f"CPU's by {float(err.max())} (rms {rms})")
                max_err = max(max_err, float(err.max()) if n else 0.0)
            out[mode] = {"G": G, "C": C, "dropped": int((~rc.keep).sum()),
                         "near_ties": int((~clear).sum()),
                         "tokens_compared": sum(first),
                         "max_abs_err": max_err, "rms": rms}
        del w, x
        torch.cuda.empty_cache()
        return out


def families_phase(smoke, tk, launches_main):
    """Phase 13: each config of FAMILY_CASES in turn, at its published
    widths (weights drawn on the card from a seeded generator), through
    `make_prefill_step` + `make_serve_step`, held to `forward(mode=
    "train")`, then freed; the launch counts reset just before each served
    run and read just after (the attention kernel of each config with
    attention must have run once a layer; `flash_attention_wgmma` and
    `flash_attention_tf32x3` join the kernels line); after mixtral, one
    MoE layer at full width in fp32 on the card against the CPU."""
    torch = smoke.torch
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import common, moe, ssm, transformer
    fp = FamiliesPhase(smoke, (configs, transformer, steps, moe, ssm,
                               common))
    t0 = time.perf_counter()
    out, launches = {"cases": {}}, {}
    for i, (name, case) in enumerate(FAMILY_CASES.items()):
        out["cases"][name] = row = fp.case(name, case, FAMILY_SEED + 10 * i)
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
        c = row["consistency"]
        log(f"[families] {name}: {case.layers} of "
            f"{row['config']['published_layers']} layers, {case.dtype}, b "
            f"{case.b}, t {case.t}: {row['n_params'] / 1e9:.2f} G "
            f"parameters ({row['weight_gib']:.1f} GiB) drawn on the card in "
            f"{row['init_s']:.1f} s; "
            f"prefill {row['prefill_ms']:.1f} ms "
            f"({row['prefill_tokens_per_s']:.0f} tokens/s; first call "
            f"{row['prefill_cold_ms']:.1f} ms), decode "
            f"{row['decode_ms_median']:.2f} ms a step (median of "
            f"{FAMILY_STEPS}; {row['decode_tokens_per_s']:.1f} tokens/s), "
            f"peak memory {row['peak_gib_served']:.1f} GiB served / "
            f"{row['peak_gib']:.1f} GiB with the check (above the "
            f"{row['held_by_earlier_phases_gib']:.1f} GiB held before); "
            f"launches "
            f"{row['launches']}")
        log(f"[families] {name}: decode vs forward(mode=\"train\") over "
            f"{c['full_forward_t']} tokens: {c['positions_compared']} of "
            f"{c['positions']} positions within {c['tolerance'][0]} + "
            f"{c['tolerance'][1]} |want| + {c['tolerance'][2]} rms (logits "
            f"rms {c['logits_rms']:.2f}), max abs err "
            f"{c['max_abs_err']:.4f} (by step "
            f"{[round(e, 4) for e in c['max_abs_err_by_step']]}, rms "
            f"{c['rms_err']:.4f}; the row factor needed "
            f"{c['row_reading']:.5f}); tokens equal at the "
            f"{c['tokens_held_by_margin']} positions whose margin exceeds "
            f"twice that"
            + (f"; {c['positions_moved_by_routing']} positions whose experts "
               f"moved (first at layers {c['first_moved_layer']}, the full "
               f"forward's gaps there "
               f"{[round(g, 5) for g in c['moved_gaps']]}, the row factor "
               f"they would need {c['row_reading_moved']}); router noise "
               f"{c['router_noise']:.5f}"
               if "moved_gaps" in c else ""))
        p = row["decode_profile"]
        log(f"[families] {name}: a decode step profiled: "
            f"{p.get('device_ops_per_apply')} device operations, "
            f"{p.get('device_us_per_apply', 0) / 1e3:.2f} ms device, busy "
            f"{p.get('device_busy_share', p.get('error'))}; top "
            + json.dumps({k: round(v, 1) for k, v in
                          p.get("top_device_us_per_apply", {}).items()}))
        if name == "mixtral_8x7b":
            t = time.perf_counter()
            out["moe_layer"] = layer = fp.moe_layer(FAMILY_SEED + 99)
            log(f"[families] one MoE layer at mixtral_8x7b's full width, "
                f"fp32, card vs CPU ({time.perf_counter() - t:.1f} s): "
                + "; ".join(
                    f"{mode} G {r['G']} C {r['C']}: {r['dropped']} pairs "
                    f"dropped, routing equal ({r['near_ties']} near ties), "
                    f"max abs err {r['max_abs_err']:.3g} (rms "
                    f"{r['rms']:.3g}) over {r['tokens_compared']} tokens"
                    for mode, r in layer.items()))
    for kname in (WGMMA, TF32X3):
        if not launches.get(kname):
            raise SystemExit(f"families: {kname} never launched on the "
                             "path")
        launches_main[kname] += launches[kname]
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    log(f"[families] phase in {out['phase_s']:.1f} s, launches {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: training (models/transformer.py::lm_loss, optim/, data/,
# launch/steps.py::make_train_step, launch/train.py::train) and the
# attention backward kernels (kernels/csrc/flash_attention_bwd_wgmma.cu,
# bf16; kernels/csrc/flash_attention_bwd_tf32x3.cu, fp32).
# ---------------------------------------------------------------------------

# each dtype's backward kernel (`flash_attention.bwd_kernel_for`)
BWD = {"bfloat16": "flash_attention_bwd_wgmma",
       "float32": "flash_attention_bwd_tf32x3"}
# The backward against its plain twin, as a share of each gradient's
# largest entry.  fp32: 3xTF32 products (within 2^-21 of each; one TF32
# pass misses it) summed in other orders; bf16:
# dq, dk, dv rounded to bf16 (one ulp, 2^-8 relative) on top of that.  Set
# between the sound readings and the planted faults' (`BWD_FAULTS`), see
# PERF.md §6.
BWD_TOL = {"bfloat16": 2 ** -7, "float32": 1e-4}
# (b, tq, tkv, h, kvh, hd, causal, window), each in bf16 and fp32
BWD_SHAPES = {
    "glm4_9b_b2_t4096": (2, 4096, 4096, 32, 2, 128, True, 0),
    "mixtral_8x7b_t6144_w4096": (1, 6144, 6144, 32, 8, 128, True, 4096),
    "recurrentgemma_9b_t4096_w2048": (1, 4096, 4096, 16, 1, 256, True, 2048),
    "hubert_xlarge_b2_t1000": (2, 1000, 1000, 16, 16, 80, False, 0),
    "hd7_b2_t1000": (2, 1000, 1000, 32, 8, 7, True, 0),
    "hd100_b2_t1000": (2, 1000, 1000, 32, 8, 100, True, 0),
}
# the faults both backward kernels can plant: each must fail BWD_TOL on the
# glm4_9b case (causal, 16 query heads a kv head)
BWD_FAULTS = {1: "D left out", 2: "the GQA sum over one head only",
              3: "the causal mask off by one"}
BWD_CASE = "glm4_9b_b2_t4096"           # the kernels line's timing case
# Each forward kernel's LSE (natural log units of the scaled scores)
# against the plain forward's, as the largest absolute difference: the
# backward's P is exp(scale S - LSE), so an LSE off by d moves P by a share
# d.  Set by dtype between the sound readings and the planted errors (the
# LSE rounded to bf16, or cut to one TF32 operand's top 19 bits; in log2
# units), see PERF.md §6; fp32's stays under its BWD_TOL of 1e-4.
LSE_TOL = {"bfloat16": 2 ** -10, "float32": 2 ** -14}


def tf32_operand(x):
    """fp32 x as one TF32 operand of the tensor cores keeps it: its low 13
    mantissa bits cleared."""
    import torch
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


LSE_FAULTS = {"rounded to bf16": lambda lse: lse.bfloat16().float(),
              "cut to one TF32 operand": tf32_operand,
              "in log2 units": lambda lse: lse * 1.4426950408889634}
TRAIN_ARCH = "glm4_9b"
# Depth and batch cut so the train state, one copy of it in the versioned
# store (TRAIN_SLOTS), the update's new state and the loss's fp32 logits
# fit the card (PERF.md §4): 4 of 40 layers, b 2, t 4096 (train_4k's).
TRAIN_LAYERS, TRAIN_B, TRAIN_T = 4, 2, 4096
TRAIN_STEPS, TRAIN_CKPT = 6, 3
TRAIN_SLOTS = 1
TRAIN_OPT = {"lr": 3e-4, "warmup": 1, "total_steps": TRAIN_STEPS}
TRAIN_SEED = 14000
# One train step of each family at its published width, bf16: (arch,
# layers, b, t): mixtral past its window with capacity drops, mamba2 whole
# (the SSD and the scan through autograd), recurrentgemma one period
# (RG-LRU, RG-LRU, the hd-256 backward); llama4 stays on the CPU (one
# layer's 16 G expert parameters need ~190 GB with AdamW's state).
TRAIN_FAMILIES = {"mixtral_8x7b": ("mixtral_8x7b", 2, 1, 6144),
                  "mamba2_780m": ("mamba2_780m", 48, 2, 2048),
                  "recurrentgemma_9b": ("recurrentgemma_9b", 3, 1, 4096)}
# Whole fp32 step, card (kernels) against CPU (plain versions), every
# reduced config, from an AdamW state as after 5 steps (so the update is
# m / sqrt(v), not the sign of g): loss within STEP_RTOL, grad norm within
# 1e-3 relative, moments within 1e-3 of their largest entry, parameters
# within STEP_PARAM_ATOL (lr x an update error of ~1e-3 relative is
# ~1e-6: the 3xTF32 forward agrees with fp32 to ~1e-4 relative).
STEP_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-5


def bwd_bound(b, tq, tkv, h, kvh, hd, causal, window, dtype):
    """(flops, bytes, bound ms, bound_by) of the backward: 2.5 x the
    forward's 4 b h hd pairs over the type's fastest route; q, k, v, o,
    dO and the LSE read once, dq, dk, dv written once."""
    es = 2 if dtype == "bfloat16" else 4
    flops = 10 * b * h * hd * live_pairs(tq, tkv, causal, window)
    nbytes = (4 * b * tq * h * hd + 4 * b * tkv * kvh * hd) * es \
        + b * h * tq * 4
    peak, passes = DTYPE_PEAK[dtype]
    ops_ms, bytes_ms = passes * flops / peak * 1e3, \
        nbytes / HBM_BYTES_PER_S * 1e3
    return flops, nbytes, max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


class TrainPhase:
    """Phase 14 (see `train_phase`)."""

    def __init__(self, smoke, mods):
        self.s, self.torch, self.dev = smoke, smoke.torch, smoke.dev
        (self.fa, self.configs, self.shapes, self.tm, self.steps,
         self.train_mod, self.optim, self.data, self.ckpt,
         self.common) = mods

    def fail(self, what):
        raise SystemExit(f"training: {what}")

    # -- the backward kernel against its plain twin ---------------------------

    def bwd_inputs(self, shape, dtype, seed):
        """q, k, v, dO drawn on the card, o and the LSE the forward
        kernel's (`with_lse=True`: the instance that also stores it)."""
        torch = self.torch
        b, tq, tkv, h, kvh, hd, causal, window = shape
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(s, generator=gen, device=self.dev).to(dt)
                       for s in ((b, tq, h, hd), (b, tkv, kvh, hd),
                                 (b, tkv, kvh, hd), (b, tq, h, hd)))
        o, lse = self.fa.flash_attention(q, k, v, causal=causal,
                                         window=window, with_lse=True)
        return q, k, v, o, do, lse

    @staticmethod
    def reading(got, want):
        """max |got - want| / max |want| of each of dq, dk, dv."""
        return [float((g.float() - w.float()).abs().max())
                / max(float(w.float().abs().max()), 1e-30)
                for g, w in zip(got, want)]

    def planted(self, dtype, q, k, v, o, do, lse, causal, window, fault):
        """(dq, dk, dv) of the dtype's backward kernel with `fault`
        planted."""
        torch, fa = self.torch, self.fa
        bad = tuple(torch.empty_like(t) for t in (q, k, v))
        launch = fa._bwd_wgmma_kernel if dtype == "bfloat16" \
            else fa._bwd_tf32x3_kernel
        launch(q, k, v, o, do, lse, *bad, causal, window, fault=fault)
        return bad

    def bwd_check(self):
        """Every case in both dtypes: the dtype's kernel (through
        `flash_attention_bwd`, from the forward kernel's LSE) within
        BWD_TOL of the plain backward; then each planted fault on the
        glm4_9b case outside it.  At each case the forward kernel's LSE
        within the dtype's LSE_TOL of the plain forward's, and each of
        LSE_FAULTS outside it.  Returns {case: readings}, {fault:
        readings}, {case: LSE reading}, {LSE fault: reading} and the
        largest abs errors by kernel."""
        torch, fa = self.torch, self.fa
        sound, faults, lse_sound, lse_faults = {}, {}, {}, {}
        max_abs = dict.fromkeys(BWD.values(), 0.0)
        for i, (name, shape) in enumerate(BWD_SHAPES.items()):
            b, tq, tkv, h, kvh, hd, causal, window = shape
            for dtype in ("bfloat16", "float32"):
                q, k, v, o, do, lse = self.bwd_inputs(shape, dtype,
                                                      14100 + i)
                got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                             window=window, lse=lse)
                want = fa.flash_attention_bwd_plain(q, k, v, o, do,
                                                    causal=causal,
                                                    window=window)
                torch.cuda.synchronize()
                for g in got:
                    if g.dtype != q.dtype or not torch.isfinite(
                            g.float()).all():
                        self.fail(f"backward {name}/{dtype}: not finite or "
                                  "not in q's dtype")
                r = self.reading(got, want)
                sound[f"{name}/{dtype}"] = r
                max_abs[BWD[dtype]] = max(max_abs[BWD[dtype]], max(
                    float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)))
                if max(r) > BWD_TOL[dtype]:
                    self.fail(f"backward {name}/{dtype} differs from the "
                              f"plain version: {r} of the largest entries "
                              f"(tolerance {BWD_TOL[dtype]})")
                if name == BWD_CASE:
                    for fault in BWD_FAULTS:
                        rf = self.reading(self.planted(
                            dtype, q, k, v, o, do, lse, causal, window,
                            fault), want)
                        faults[f"{BWD_FAULTS[fault]}/{dtype}"] = rf
                        if max(rf) <= BWD_TOL[dtype]:
                            self.fail(f"the planted fault '{BWD_FAULTS[fault]}'"
                                      f" ({dtype}) passes the tolerance: "
                                      f"{rf}")
                _, plain = fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window, with_lse=True)
                case = f"{name}/{dtype}"
                lse_sound[case] = float((lse - plain).abs().max())
                if lse_sound[case] > LSE_TOL[dtype]:
                    self.fail(f"the forward kernel's LSE at {case} differs "
                              f"from the plain one's by {lse_sound[case]} "
                              f"(tolerance {LSE_TOL[dtype]})")
                for what, plant in LSE_FAULTS.items():
                    rf = float((plant(lse) - plain).abs().max())
                    lse_faults[f"{what}/{case}"] = rf
                    if rf <= LSE_TOL[dtype]:
                        self.fail(f"the LSE {what} passes the tolerance at "
                                  f"{case}: {rf}")
                del plain
                del q, k, v, o, do, lse, got, want
                torch.cuda.empty_cache()
        return sound, faults, lse_sound, lse_faults, max_abs

    def bwd_timing(self, name, dtype, seed):
        """Device ms of the dtype's kernel, its plain twin's ms (from the
        same LSE), SDPA's backward (its forward + backward less its
        forward; a dense mask where there is a window) and the bound."""
        torch, fa, s = self.torch, self.fa, self.s
        shape = BWD_SHAPES[name]
        b, tq, tkv, h, kvh, hd, causal, window = shape
        q, k, v, o, do, lse = self.bwd_inputs(shape, dtype, seed)
        row = {"kernel": BWD[dtype],
               "ms": s.device_ms(lambda: fa.flash_attention_bwd(
                   q, k, v, o, do, causal=causal, window=window, lse=lse),
                   reps=5),
               "plain_ms": s.time_ms(lambda: fa.flash_attention_bwd_plain(
                   q, k, v, o, do, causal=causal, window=window, lse=lse),
                   reps=3, warmup=1)}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        mask = None
        if window > 0:
            qpos = torch.arange(tq, device=self.dev)[:, None]
            kpos = torch.arange(tkv, device=self.dev)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)

        def fwd():
            return sdpa(qt, kt, vt, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=True)
        try:                          # a yardstick, not part of the port
            both = s.device_ms(lambda: torch.autograd.grad(
                fwd(), (qt, kt, vt), dot), reps=5)
            with torch.no_grad():
                alone = s.device_ms(fwd, reps=5)
            row["library_ms"] = both - alone
            row["library_fwd_bwd_ms"] = both
        except RuntimeError as err:
            row["library_ms"] = None
            row["library_error"] = f"not measured: {err!r}"[:300]
        flops, nbytes, bound, by = bwd_bound(*shape, dtype)
        row.update(flops=flops, bytes=nbytes, bound_ms=bound, bound_by=by)
        return row

    # -- glm4_9b trained at its published width --------------------------------

    def train_config(self):
        return dataclasses.replace(self.configs.get_config(TRAIN_ARCH),
                                   n_layers=TRAIN_LAYERS)

    def glm4(self, tmp):
        """`train()` for TRAIN_CKPT steps with a checkpoint there, the
        checkpoint restored (CRC-verified) into a fresh template on the
        host and held bit for bit to the state the run returned; then
        `train()` again to TRAIN_STEPS, resumed from it.  The launch
        counts reset just before the first call and read just after the
        second."""
        torch, tk = self.torch, self.s.tk
        cfg = self.train_config()
        shape = self.shapes.Shape("train_4k", TRAIN_T, TRAIN_B, "train")
        opt = self.optim.AdamWConfig(**TRAIN_OPT)
        kw = dict(ckpt_dir=str(tmp), ckpt_every=TRAIN_CKPT, seed=TRAIN_SEED,
                  opt_cfg=opt, snapshot_slots=TRAIN_SLOTS, log_every=1,
                  device=self.dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, first = self.train_mod.train(cfg, shape,
                                                    steps=TRAIN_CKPT, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        steps = self.ckpt.list_steps(str(tmp))
        if steps != [TRAIN_CKPT]:
            self.fail(f"checkpoints {steps}, expected [{TRAIN_CKPT}]")
        t0 = time.perf_counter()
        template = self.steps.init_train_state(cfg, opt, 0, device="meta")
        restored, meta = self.ckpt.restore_checkpoint(
            str(tmp), TRAIN_CKPT, template, device="cpu", verify=True)
        restore_s = time.perf_counter() - t0
        saved = self.common.tree_leaves((params, state))
        back = self.common.tree_leaves(restored)
        if len(saved) != len(back) or meta.get("next_step") != TRAIN_CKPT:
            self.fail("the restored checkpoint's tree or meta differs")
        for x, y in zip(saved, back):
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y):
                self.fail("the restored checkpoint differs from the saved "
                          "state")
        n_params = sum(x.numel() for x in self.common.tree_leaves(params))
        state_gib = sum(x.numel() * x.element_size() for x in saved) / 2 ** 30
        del params, state, restored, saved, back, template
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params, state, second = self.train_mod.train(cfg, shape,
                                                     steps=TRAIN_STEPS, **kw)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        launches = {k: v for k, v in tk.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        losses = first["loss"] + second["loss"]
        norms = first["grad_norm"] + second["grad_norm"]
        step_s = first["step_time"] + second["step_time"]
        if len(losses) != TRAIN_STEPS or not all(
                math.isfinite(x) for x in losses + norms):
            self.fail(f"losses {losses}, grad norms {norms}")
        if not losses[-1] < losses[0]:
            self.fail(f"the loss did not fall: {losses}")
        n_steps = TRAIN_STEPS * TRAIN_LAYERS
        # remat: the forward twice; bf16 never reaches the fp32 backward
        want = {WGMMA: 2 * n_steps, BWD["bfloat16"]: n_steps,
                BWD["float32"]: None}
        if any(launches.get(k) != v for k, v in want.items()):
            self.fail(f"launches {launches}, expected {want} (forward twice "
                      "an attention layer and step under remat, backward "
                      "once, the bf16 kernel)")
        # one more step profiled, from the final state
        step = self.steps.make_train_step(cfg, opt)
        batch = self.data.to_device(self.data.DataPipeline(
            cfg, shape, seed=TRAIN_SEED).batch(TRAIN_STEPS), self.dev)
        prof = self.s.device_busy(
            lambda: (step(params, state, batch), torch.cuda.synchronize()),
            reps=1, trace=ROOT / "chiprun_out" / "train_trace.tmp.json")
        del params, state, batch
        torch.cuda.empty_cache()
        warm = step_s[1:TRAIN_CKPT] + step_s[TRAIN_CKPT + 1:]
        ms = statistics.median(warm) * 1e3
        return {"config": {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS,
                           "published_layers": self.configs.get_config(
                               TRAIN_ARCH).n_layers, "b": TRAIN_B,
                           "t": TRAIN_T, "dtype": cfg.param_dtype,
                           "remat": cfg.remat, "opt": TRAIN_OPT,
                           "snapshot_slots": TRAIN_SLOTS},
                "n_params": n_params, "state_gib": state_gib,
                "losses": losses, "grad_norms": norms,
                "step_ms": [x * 1e3 for x in step_s],
                "step_ms_median_warm": ms,
                "tokens_per_s": TRAIN_B * TRAIN_T / (ms / 1e3),
                "first_call_s": first_s, "resumed_call_s": second_s,
                "restore_verify_s": restore_s,
                "peak_gib": (peak - held) / 2 ** 30,
                "held_before_gib": held / 2 ** 30, "launches": launches,
                "profile": {k: v for k, v in prof.items()
                            if k not in ("device_ops", "device_ops_by_call")}}

    # -- the families, one step each; every reduced config card vs CPU ---------

    def family_step(self, name, seed):
        """One bf16 train step at the published width: the loss and every
        gradient leaf finite (from autograd over the leaves, as
        `make_train_step` takes them), then the AdamW update's state
        finite."""
        torch = self.torch
        arch, layers, b, t = TRAIN_FAMILIES[name]
        cfg = dataclasses.replace(self.configs.get_config(arch),
                                  n_layers=layers)
        opt = self.optim.AdamWConfig(**TRAIN_OPT)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        params, state = self.steps.init_train_state(cfg, opt, seed,
                                                    device=self.dev)
        shape = self.shapes.Shape("train_4k", t, b, "train")
        batch = self.data.to_device(self.data.DataPipeline(
            cfg, shape, seed=seed).batch(0), self.dev)
        t0 = time.perf_counter()
        live = [p.detach().requires_grad_()
                for p in self.common.tree_leaves(params)]
        loss = self.tm.lm_loss(self.common.tree_unflatten(params, live), cfg,
                               batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        del live
        bad = [i for i, g in enumerate(grads)
               if g is not None and not torch.isfinite(g.float()).all()]
        unused = sum(g is None for g in grads)
        grads = self.common.tree_unflatten(params, [
            g if g is not None else torch.zeros_like(p) for g, p in
            zip(grads, self.common.tree_leaves(params))])
        new_p, new_s, metrics = self.optim.adamw_update(params, grads, state,
                                                        opt)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        finite = all(bool(torch.isfinite(x.float()).all()) for x in
                     self.common.tree_leaves((new_p, new_s["m"],
                                              new_s["v"])))
        out = {"arch": arch, "layers": layers, "b": b, "t": t,
               "loss": float(loss.detach()),
               "grad_norm": float(metrics["grad_norm"]),
               "leaves": len(self.common.tree_leaves(params)),
               "unused_leaves": unused, "step_ms": step_ms,
               "peak_gib": (torch.cuda.max_memory_allocated() - held)
               / 2 ** 30}
        del params, state, grads, new_p, new_s, batch, loss
        torch.cuda.empty_cache()
        if bad or not finite or not math.isfinite(out["loss"]):
            self.fail(f"{name}: gradient leaves {bad} not finite, state "
                      f"finite {finite}, loss {out['loss']}")
        return out

    def card_vs_cpu(self, arch, seed):
        """One fp32 train step of the reduced config on the card (the
        kernels) and on the CPU (the plain versions), from the same
        weights, AdamW state and batch: loss, grad norm, moments and every
        parameter after the step within the STEP_* tolerances."""
        torch = self.torch
        cfg = dataclasses.replace(self.configs.get_config(arch, reduced=True),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        opt = self.optim.AdamWConfig(**TRAIN_OPT)
        params, state = self.steps.init_train_state(cfg, opt, seed,
                                                    device="cpu")
        rng = np.random.default_rng(seed)
        mv = {k: self.common.tree_map(lambda p, k=k: torch.from_numpy(
            (rng.standard_normal(p.shape) * 1e-3 if k == "m"
             else rng.uniform(0.5, 1.5, p.shape) * 1e-5).astype(np.float32)),
            params) for k in ("m", "v")}
        state = {**mv, "step": torch.tensor(5, dtype=torch.int32)}
        shape = self.shapes.reduced_shape(self.shapes.SHAPES["train_4k"])
        raw = self.data.DataPipeline(cfg, shape, seed=seed).batch(0)
        step = self.steps.make_train_step(cfg, opt)
        outs = {}
        for dev in ("cpu", self.dev):
            def move(tree, dev=dev):
                return self.common.tree_map(lambda x: x.to(dev), tree)
            outs[str(dev)] = step(move(params), move(state),
                                  self.data.to_device(raw, dev))
        (pc, sc, mc), (pg, sg, mg) = outs["cpu"], outs[str(self.dev)]
        err = {"loss": abs(float(mg["loss"]) - float(mc["loss"]))
               / abs(float(mc["loss"])),
               "grad_norm": abs(float(mg["grad_norm"])
                                - float(mc["grad_norm"]))
               / float(mc["grad_norm"])}
        err["params"] = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            self.common.tree_leaves(pg), self.common.tree_leaves(pc)))
        err["moments"] = max(
            float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            for k in ("m", "v") for a, b in zip(
                self.common.tree_leaves(sg[k]),
                self.common.tree_leaves(sc[k])))
        if err["loss"] > STEP_RTOL or err["grad_norm"] > 1e-3 or \
                err["params"] > STEP_PARAM_ATOL or err["moments"] > 1e-3 or \
                int(sg["step"]) != int(sc["step"]):
            self.fail(f"{arch}: the card's fp32 step differs from the CPU's: "
                      f"{err}")
        return err


def train_phase(smoke, tk, launches_main):
    """Phase 14: the backward kernels against their plain twin (and the
    planted faults), the forward kernels' LSE against the plain one's, and
    their timing; glm4_9b trained at its published width through
    `launch.train.train` (the counts reset just before and read just
    after: `flash_attention_wgmma` and `flash_attention_bwd_wgmma` join
    the kernels line); one step of mixtral, mamba2 and recurrentgemma;
    every reduced config's fp32 step card vs CPU (its counts likewise:
    `flash_attention_tf32x3` and `flash_attention_bwd_tf32x3` join the
    line)."""
    import gc
    import shutil
    import tempfile
    torch = smoke.torch
    from repro_torch import checkpoint, configs
    from repro_torch import data, optim
    from repro_torch.configs import shapes
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import common, transformer
    gc.collect()                     # what earlier phases left in cycles
    torch.cuda.empty_cache()
    # the train state's tensors come and go in sizes of GBs: segments that
    # grow keep the freed ones from fragmenting the card
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    tp = TrainPhase(smoke, (fa, configs, shapes, transformer, steps,
                            train_mod, optim, data, checkpoint, common))
    t0 = time.perf_counter()
    out = {"held_at_start_gib": torch.cuda.memory_allocated() / 2 ** 30}
    log(f"[training] {out['held_at_start_gib']:.2f} GiB held by the earlier "
        "phases")
    sound, faults, lse_sound, lse_faults, max_abs = tp.bwd_check()
    smoke.max_err.update(max_abs)
    out["backward"] = {"tolerance": BWD_TOL, "readings": sound,
                       "faults": faults, "lse_tolerance": LSE_TOL,
                       "lse_readings": lse_sound, "lse_faults": lse_faults}
    log(f"[training] backward kernels vs plain (bf16 {BWD['bfloat16']}, "
        f"fp32 {BWD['float32']}), max err / largest entry (dq, dk, dv): "
        + "; ".join(f"{k} {[f'{x:.2e}' for x in v]}"
                    for k, v in sound.items()))
    log(f"[training] planted faults on {BWD_CASE}: " + "; ".join(
        f"{k} {[f'{x:.2e}' for x in v]}" for k, v in faults.items())
        + f" (tolerance {BWD_TOL}); all fail it")
    log(f"[training] the forward kernels' LSE vs plain, max abs err: "
        + "; ".join(f"{k} {v:.3e}" for k, v in lse_sound.items())
        + f"; planted: " + "; ".join(f"{k} {v:.3e}"
                                     for k, v in lse_faults.items())
        + f" (tolerance {LSE_TOL}); all fail it")
    timing = {}
    for i, name in enumerate(BWD_SHAPES):
        for dtype in ("bfloat16", "float32"):
            timing[f"{name}/{dtype}"] = row = tp.bwd_timing(name, dtype,
                                                            14200 + i)
            log(f"[training-timing] backward {name}/{dtype} "
                f"({row['kernel']}): kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, SDPA "
                f"backward {row['library_ms']} ms (fwd + bwd "
                f"{row.get('library_fwd_bwd_ms')}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            torch.cuda.empty_cache()
    out["backward"]["timing"] = timing
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    try:
        out["glm4_9b"] = g = tp.glm4(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    p = g["profile"]
    log(f"[training] {TRAIN_ARCH}: {TRAIN_LAYERS} of "
        f"{g['config']['published_layers']} layers, b {TRAIN_B}, t "
        f"{TRAIN_T}, bf16, remat, AdamW fp32 moments, {TRAIN_SLOTS} "
        f"snapshot slot: {g['n_params'] / 1e9:.3f} G parameters "
        f"({g['state_gib']:.1f} GiB of state); losses "
        f"{[round(x, 4) for x in g['losses']]}, grad norms "
        f"{[round(x, 3) for x in g['grad_norms']]}; "
        f"{g['step_ms_median_warm']:.1f} ms a step (median, warm; all "
        f"{[round(x, 1) for x in g['step_ms']]}), "
        f"{g['tokens_per_s']:.0f} tokens/s, peak {g['peak_gib']:.1f} GiB "
        f"above {g['held_before_gib']:.1f}; checkpoint at step {TRAIN_CKPT} "
        f"restored (CRC-verified) into a fresh template in "
        f"{g['restore_verify_s']:.1f} s and equal bit for bit; calls "
        f"{g['first_call_s']:.1f} s + {g['resumed_call_s']:.1f} s (resumed); "
        f"launches {g['launches']}")
    log(f"[training] a step profiled: {p.get('device_ops_per_apply')} device "
        f"operations, {p.get('device_us_per_apply', 0) / 1e3:.1f} ms device, "
        f"busy {p.get('device_busy_share', p.get('error'))}; top "
        + json.dumps({k: round(v, 1) for k, v in
                      p.get("top_device_us_per_apply", {}).items()}))
    out["families"] = {}
    for i, name in enumerate(TRAIN_FAMILIES):
        out["families"][name] = r = tp.family_step(name, TRAIN_SEED + 10 + i)
        log(f"[training] {name} ({r['layers']} layers, b {r['b']}, t "
            f"{r['t']}, bf16): loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['leaves']} leaves finite "
            f"({r['unused_leaves']} unused), step {r['step_ms']:.0f} ms, "
            f"peak {r['peak_gib']:.1f} GiB")
    out["card_vs_cpu"] = {}
    # the fp32 step's kernels (the 3xTF32 forward, the fp32 backward): the
    # counts reset just before the ten steps and read just after
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for i, arch in enumerate(configs.ARCHS):
        out["card_vs_cpu"][arch] = tp.card_vs_cpu(arch, TRAIN_SEED + 50 + i)
    fp32_launches = {k: v for k, v in tk.launch_counts().items() if v}
    if not fp32_launches.get(BWD["float32"]) or \
            fp32_launches.get(BWD["bfloat16"]):
        tp.fail(f"the fp32 steps launched {fp32_launches}: expected the "
                "fp32 backward kernel, and not the bf16 one")
    out["card_vs_cpu_launches"] = fp32_launches
    log(f"[training] one fp32 step card vs CPU, all ten reduced configs: "
        + "; ".join(f"{a} " + json.dumps({k: float(f'{v:.2e}') for k, v in
                                          e.items()})
                    for a, e in out["card_vs_cpu"].items())
        + f"; launches {fp32_launches}")
    for launched in (g["launches"], fp32_launches):
        for kname, n in launched.items():
            launches_main[kname] = launches_main.get(kname, 0) + n
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    out["phase_s"] = time.perf_counter() - t0
    log(f"[training] phase in {out['phase_s']:.1f} s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import atomics, convert, guard, runtime
    from repro_torch.core import engine, layout
    from repro_torch import kernels as tk
    from repro_torch.guard import inject
    from repro_torch.kernels import _build, llsc_commit, ops, ref
    from repro_torch.kernels import engine_round as er
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scrub_digest

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")
    out_dir = ROOT / "chiprun_out"          # details and profiler traces
    out_dir.mkdir(exist_ok=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:  # nvcc's at once
        libs = list(pool.map(_build.build, _build.SIGNATURES))
    for name in _build.SIGNATURES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(lib.name for lib in libs)} in {build_s:.2f} s")

    smoke = Smoke(torch, atomics, engine, er, convert, tk)

    # -- 2. kernel vs plain ----------------------------------------------------
    t0 = time.perf_counter()
    sort_cases = [(N, P, s) for s in SORT_SPECTRA]
    sort_cases += [(N, p, "uniform") for p in (1, 700, 3000, 2 ** 20)]
    passes = {}
    for i, (n, p, spectrum) in enumerate(sort_cases):
        passes[f"{spectrum}_p{p}"] = smoke.sort_vs_torch(n, p, spectrum,
                                                         seed=500 + i)
    if passes[f"uniform_p{P}"] != 3:
        raise SystemExit(f"the sort ran {passes[f'uniform_p{P}']} passes "
                         "on 23-bit keys, not 3")
    log(f"[kernel-vs-plain] the prologue's sort equals torch.sort(stable="
        f"True) in {len(sort_cases)} cases (n = 2**22) in "
        f"{time.perf_counter() - t0:.1f} s; passes run {passes}")
    t0 = time.perf_counter()
    cases = [(4096, k, 2048, s) for k in (1, 3, 4, 5, 16, 20)
             for s in ("none", "low", "all_same")]
    cases += [(4096, k, 2048, "long") for k in (3, 5, 20)]
    cases += [(N, K, P, s) for s in ("none", "low", "all_same", "zipf",
                                     "long")]
    for i, (n, k, p, spectrum) in enumerate(cases):
        smoke.kernel_vs_plain(n, k, p, spectrum, seed=1000 + i)
    log(f"[kernel-vs-plain] {len(cases)} cases x 4 kernels, each branch "
        f"taken and not, bit-identical in {time.perf_counter() - t0:.1f} s "
        f"(spectra none / low / all_same / zipf / long; k = 1, 3, 4, 5, 16, "
        f"20)")
    # p = 2**20: 1024 epilogue tiles of 512 threads, more than the card
    # holds at once, so the epilogue's blocks take tickets
    t0 = time.perf_counter()
    branches = [smoke.round_vs_plain_round(N, K, 2 ** 20, spectrum,
                                           seed=1500 + i)
                for i, spectrum in enumerate(("none", "low"))]
    if branches != ["fast", "slow"]:
        raise SystemExit(f"p = 2**20: branches {branches}, not fast, slow")
    log(f"[kernel-vs-plain] the round's kernels equal the plain round "
        f"(make_round mode xla) at n = 2**22, p = 2**20 on both branches in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 3. main path --------------------------------------------------------
    totals = dict.fromkeys(ROUND_KERNELS, 0)
    timings = {}
    states = {}
    for si, strategy in enumerate(STRATEGIES):
        (spec, state, initial, record, launches, final, read,
         wall) = smoke.main_path(strategy, seed=si)
        for name in totals:
            totals[name] += launches[name]
        smoke.check_main_path(strategy, initial, record, launches, final,
                              read)
        tiers = " ".join(f"{name}:{tier}" for name, _, tier, *_ in record)
        log(f"[main-path] {strategy}: 6 batches in {wall:.3f} s, launches "
            f"{launches}, branches {tiers}; oracle-equal")
        states[strategy] = (spec, state)
    launches_main = dict(totals)

    # -- 3b. table ops -----------------------------------------------------------
    table = TableOps(smoke, tk, ops, llsc_commit, ref)
    t0 = time.perf_counter()
    n_cases = table.kernel_vs_plain()
    log(f"[table-ops] {n_cases} cases (seqlock_gather, cas_apply_round, "
        f"llsc_commit_round, cachehash_probe, cachehash_find) bit-identical "
        f"to their plain versions in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rounds_cases = table.rounds_vs_plain()
    log(f"[table-ops] cas_apply_rounds bit-identical to the round loop in "
        f"{len(rounds_cases)} cases in {time.perf_counter() - t0:.1f} s "
        "(longest segment / rounds): " + "; ".join(
            f"{name} {longest}/{rounds}"
            for name, longest, rounds in rounds_cases))
    t0 = time.perf_counter()
    counts, fast_in_commit, op = table.main_path(atomics, engine, convert)
    table_wall = time.perf_counter() - t0
    for name in TABLE_KERNELS:
        launches_main[name] = counts[name]
    log(f"[table-ops] path in {table_wall:.2f} s (CacheHash build "
        f"{op['build_cachehash_s']:.2f} s, chains <= {op['max_depth']}, "
        f"queries hit/miss {op['find_mix']}, find's distinct buckets / "
        f"nodes / chain steps / most steps a lane {op['find_walk']}), "
        f"update rounds (= longest "
        f"segment) {op['rounds']}, launches {counts}, commit_round's "
        f"branch {fast_in_commit}; oracle-equal")
    table_entries, table_kernels = table.timing(op)
    for name, row in table_entries.items():
        prof = row.get("profile", {})
        log(f"[table-timing] {name:32s} {row['ms']:.4f} ms, device busy "
            f"{prof.get('device_busy_share', prof.get('error'))}, device "
            f"operations {prof.get('device_ops_per_apply')} "
            f"({prof.get('device_us_per_apply')} us)")
    for name, row in table_kernels.items():
        log(f"[table-timing] kernel {name:24s} {row['ms']:.5f} ms device / "
            f"{row['with_launch_ms']:.4f} ms with launch, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bytes']} B, {row['written_rows']} rows written)")
    log(f"[table-timing] note: data.index_select(0, idx) "
        f"{table_kernels['seqlock_gather']['index_select_ms']:.5f} ms device")
    log(f"[table-timing] longest segment: {op['rounds']}")
    del op, table
    torch.cuda.empty_cache()

    # -- 4. timing -------------------------------------------------------------
    rng = np.random.default_rng(99)
    for strategy in STRATEGIES:
        spec, state = states.pop(strategy)
        _, timings[strategy] = smoke.timing(strategy, spec, state, rng)
        for name, row in timings[strategy].items():
            log(f"[timing] {strategy:9s} {name:20s} {row['branch']} (longest "
                f"segment {row['longest_segment']}): apply "
                f"{row['apply_ms']:.4f} ms ({row['ops_per_s']:.4g} ops/s), "
                f"replayed graph {row['replay_ms']:.4f} ms "
                f"({row['replay_device_ms']:.4f} ms device), host side "
                f"{row['host_side_ms']:.4f} ms "
                + json.dumps({k: round(v, 4)
                              for k, v in row['host_steps_ms'].items()}))
            for kname, kern in row["kernels"].items():
                log(f"[timing] {strategy:9s} {name:20s} {kname:14s} "
                    f"{kern['ms']:.5f} ms device / {kern['with_launch_ms']:.4f}"
                    f" ms with launch, plain {kern['plain_ms']:.4f} ms, bound "
                    f"{kern['bound_ms']:.6f} ms")
            log(f"[timing] {strategy:9s} {name:20s} torch.sort alone "
                f"{row['kernels']['round_prologue']['library_ms']:.5f} ms; "
                f"device operations per eager apply "
                f"{row['profile']['device_ops_per_apply']} (with torch.sort "
                f"{TORCH_SORT_DEVICE_OPS[strategy]}, limit "
                f"{DEVICE_OPS_LIMIT[strategy]})")
            for what in ("profile", "replay_profile"):
                prof = row[what]
                log(f"[{what}] {strategy:9s} {name:20s} " + json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in prof.items()
                     if k not in ("top_device_us_per_apply", "device_ops")})
                    + " top " + json.dumps({k: round(v, 2) for k, v in
                                            prof.get("top_device_us_per_apply",
                                                     {}).items()}))
        del state
        torch.cuda.empty_cache()

    slow_cases = smoke.slow_spectra()
    for name, row in slow_cases.items():
        log(f"[timing] slow_round {name} (p={P}, longest segment "
            f"{row['longest_segment']}): {row['ms']:.4f} ms device, bound "
            f"{row['bound_ms']:.6f} ms")
    torch.cuda.empty_cache()

    # -- 5. guard ----------------------------------------------------------------
    gp = GuardPhase(smoke, guard, inject, runtime, scrub_digest)
    t0 = time.perf_counter()
    n_cases = gp.kernel_vs_plain()
    log(f"[guard] digest_rows bit-identical to its plain version in "
        f"{n_cases} cases (k = 1, 3, 4, 5, 16 at n = 1003; full width, also "
        f"to numpy) in {time.perf_counter() - t0:.1f} s")
    guard_ops, guard_timing = {}, {}
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    for si, strategy in enumerate(STRATEGIES):
        guard_ops[strategy] = gp.layout(strategy, seed=7000 + si)
        rep = guard_ops[strategy]["report"]
        log(f"[guard] {strategy}: {GUARD_FAULTS} faults, detected "
            f"{len(rep['detected'])},"
            f" repaired {len(rep['repaired'])}, quarantined "
            f"{len(rep['quarantined'])}, invariants "
            f"{ {k: len(v) for k, v in rep['invariant_violations'].items()} }"
            f"; mask_ops batch oracle-equal; second scrub clean")
    guard_wall = time.perf_counter() - t0
    guard_launches = tk.launch_counts()
    launches_main["digest_rows"] = guard_launches["digest_rows"]
    if guard_launches["digest_rows"] <= 0:
        raise SystemExit("guard: digest_rows never launched on the path")
    log(f"[guard] path in {guard_wall:.2f} s, launches {guard_launches}")
    for strategy in STRATEGIES:
        op = guard_ops.pop(strategy)
        row = gp.timing(op)
        row["report"], row["second"] = op["report"], op["second"]
        guard_timing[strategy] = row
        prof = row["scrub_faulted_profile"]
        log(f"[guard-timing] {strategy:9s} cell_digest "
            f"{row['cell_digest_ms']:.4f} ms, digest kernel "
            f"{row['digest_kernel_ms'] * 1e3:.2f} us device (bound "
            f"{row['digest_bound_ms'] * 1e3:.2f} us), plain "
            f"{row['digest_plain_ms']:.4f} ms, check_invariants "
            f"{row['check_invariants_ms']:.4f} ms, Scrubber.scrub clean "
            f"{row['scrub_clean_ms']:.3f} ms / 64 faults "
            f"{row['scrub_faulted_ms']:.3f} ms, device busy "
            f"{prof.get('device_busy_share', prof.get('error'))}")
        del op
        torch.cuda.empty_cache()
    row_gather = gp.row_gather(layout)
    for name, row in row_gather.items():
        log(f"[guard-timing] row gather of {N} x {K * 4} B rows, {name} "
            f"index: table[idx] {row['index_ms'] * 1e3:.1f} us, gather_rows "
            f"{row['gather_rows_ms'] * 1e3:.1f} us device")
    torch.cuda.empty_cache()

    # -- 6. attention -------------------------------------------------------------
    ap = AttentionPhase(smoke, fa)
    t0 = time.perf_counter()
    attn_launches, attn_kernel, attn_err = ap.path()
    launches_main.update(attn_launches)
    for name in attn_launches:
        smoke.max_err[name] = max(err for case, err in attn_err.items()
                                  if attn_kernel[case] == name)
    log(f"[attention] {len(ATTENTION_CASES)} cases within tolerance of the "
        f"plain version in {time.perf_counter() - t0:.1f} s, launches "
        f"{attn_launches}, kernels {attn_kernel}, max abs err {attn_err}")
    attn_timing = {}
    for i, name in enumerate(ATTENTION_CASES):
        attn_timing[name] = row = ap.timing(name, 6000 + i)
        log(f"[attention-timing] {name:30s} {row['kernel']:22s} "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: bytes {row['bytes_ms']:.4f} / FLOPs "
            f"{row['flops_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']}"
            + (f" (causal, no window: {row['library_causal_ms']})"
               if "library_causal_ms" in row else ""))
        torch.cuda.empty_cache()

    # -- 7. obs --------------------------------------------------------------------
    from repro_torch import obs
    from repro_torch.core import cachehash
    from repro_torch.sync import atomic_copy, llsc, queue
    t0 = time.perf_counter()
    op_obs = ObsPhase(smoke, obs, tk)
    obs_out = {}
    for si, strategy in enumerate(STRATEGIES):
        obs_out[strategy] = row = op_obs.layout(strategy, seed=8000 + si)
        log(f"[obs] {strategy}: snapshot() equals the numpy recount over "
            f"{len(OBS_BATCHES)} batches x (1 eager + {OBS_REPLAYS} "
            f"replays of a captured apply); launches {row['launches']}")
        for name, t in row["timing"].items():
            log(f"[obs-timing] {strategy:9s} {name:20s} eager apply off "
                f"{t['off']['apply_ms']} / counters "
                f"{t['counters']['apply_ms']} ms; replayed counters "
                f"{t['counters']['replay_ms']} ms; device operations per "
                f"apply off {t['off']['device_ops_per_apply']} (limit "
                f"{DEVICE_OPS_LIMIT[strategy]}) / counters "
                f"{t['counters']['device_ops_per_apply']}; device us off "
                f"{t['off']['device_us_per_apply']} / counters "
                f"{t['counters']['device_us_per_apply']}")
        torch.cuda.empty_cache()
    obs_s = time.perf_counter() - t0
    log(f"[obs] phase in {obs_s:.1f} s")

    # -- 8. sync -------------------------------------------------------------------
    t0 = time.perf_counter()
    sp = SyncPhase(smoke, (llsc, atomic_copy, queue))
    sync_out = {"llsc": {}, "copy": {}, "queue": {}}
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for si, strategy in enumerate(STRATEGIES):
        sync_out["llsc"][strategy] = row = sp.llsc_layout(strategy,
                                                          9000 + si)
        log(f"[sync] llsc {strategy}: ll / sc / validate of {P} lanes at "
            f"n = 2**22 equal apply_sync_reference (values, success, links, "
            f"table); SC wins {row['sc_wins']}; ms {row['ms']}")
        torch.cuda.empty_cache()
    for si, strategy in enumerate(STRATEGIES):
        sync_out["copy"][strategy] = row = sp.copy_layout(strategy,
                                                          9100 + si)
        log(f"[sync] copy_batch {strategy}: q = {COPY_Q} equal "
            f"copy_batch_reference; " + "; ".join(
                f"{name} {r['waves']} waves {r['ms']:.2f} ms (schedule "
                f"{r['wave_schedule_ms']:.2f} ms)" for name, r in row.items()))
        torch.cuda.empty_cache()
    for strategy in ("seqlock", "cached_me"):
        for policy in ("none", "exp"):
            sync_out["queue"][f"{strategy}/{policy}"] = calls = \
                sp.queue_cell(strategy, policy, 9200)
            log(f"[sync] BigQueue({QUEUE_CAPACITY}, k={QUEUE_K}) {strategy} "
                f"{policy}: FIFO replay of the commit log equal; " + "; ".join(
                    f"{c['call']} {c['lanes']} lanes {c['ms']:.1f} ms "
                    f"rounds {c['rounds']}" for c in calls))
    sync_launches = {k: v for k, v in tk.launch_counts().items() if v}
    for kname in ROUND_KERNELS:
        if not sync_launches.get(kname):
            raise SystemExit(f"sync: {kname} never launched on the path")
    sync_s = time.perf_counter() - t0
    log(f"[sync] phase in {sync_s:.1f} s, launches {sync_launches}")

    # -- 9. cachehash --------------------------------------------------------------
    t0 = time.perf_counter()
    hp = HashPhase(smoke, cachehash)
    prefill, runs = hp.batches(9300)
    oracle = HashDict()
    oracle_steps = [oracle.step(*b) for b in prefill]
    oracle_steps += [oracle.step(*b) for b in runs.values()]
    log(f"[cachehash] dict oracle: {len(prefill)} prefill batches + "
        f"{len(runs)} runs, {len(oracle.model)} keys, "
        f"{time.perf_counter() - t0:.1f} s")
    hash_out = {}
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for strategy, inline in HASH_VARIANTS:
        what = f"{'cachehash' if inline else 'chaining'}/{strategy}"
        state, row = hp.variant(strategy, inline, prefill, runs,
                                oracle_steps)
        row["entries"] = hp.contents_equal(state, inline, oracle.model, what)
        hash_out[what] = row
        del state
        torch.cuda.empty_cache()
        log(f"[cachehash] {what}: prefill {row['prefill_s']:.2f} s, "
            f"{row['entries']} entries equal the dict oracle")
        for name, r in row["runs"].items():
            log(f"[cachehash] {what:20s} {name:20s} {r['ms']:.3f} ms "
                f"({r['ops_per_s']:.4g} ops/s), rounds {r['rounds']}, chain "
                f"steps {r['chain_steps']}, inline hits {r['inline_hits']}, "
                f"device operations " + (
                    f"{r['device_ops_per_call']} ({r['device_us_per_call']}"
                    f" us)" if r["device_ops_per_call"] is not None else
                    "not profiled") + f", host syncs {r['host_syncs']}")
    hash_launches = {k: v for k, v in tk.launch_counts().items() if v}
    hash_s = time.perf_counter() - t0
    log(f"[cachehash] phase in {hash_s:.1f} s, kernel launches "
        f"{hash_launches} (its rounds are PyTorch operations, no kernel)")

    # -- 10. txn ---------------------------------------------------------------
    txn_out = txn_phase(smoke, tk, prefill, launches_main)

    # -- 10b. dist --------------------------------------------------------------
    dist_out = dist_phase(smoke, tk, launches_main)

    # -- 11. serving -------------------------------------------------------------
    serving_out = serving_phase(smoke, tk, launches_main)

    # -- 11b. sharded serving ------------------------------------------------------
    sharded_out = sharded_phase(smoke, tk, launches_main,
                                serving_out["tokens"])

    # -- 12. runtime -------------------------------------------------------------
    runtime_out = runtime_phase(smoke, tk, launches_main)

    for strategy in STRATEGIES:
        d = sharded_out["per_rank"][0]["runtime"]["layouts"][strategy]["clean"]
        loc = runtime_out["sweep"][strategy]
        log(f"[sharded-runtime] {card} | {strategy} hot, phase 12's streams: "
            + "; ".join(
                f"f{f} S={RT_SLOTS * f} DistTarget (2 gloo ranks) "
                f"{d[f'f{f}_hot']['mops_s']:.4f} Mops/s, LocalTarget "
                f"{loc[f'f{f}_hot']['mops_s']:.4f}" for f in SRT_FACTORS)
            + f"; x_of_f1 DistTarget {d['x_of_f1']:.3f}, LocalTarget "
            f"{loc[f'f{SRT_FACTORS[-1]}_hot']['x_of_f1']:.3f}")

    # -- 13. model families -------------------------------------------------------
    families_out = families_phase(smoke, tk, launches_main)

    # -- 14. training --------------------------------------------------------------
    train_out = train_phase(smoke, tk, launches_main)

    # -- report ----------------------------------------------------------------
    ref = timings["cached_me"]
    rows = []
    for name, bench in (("round_prologue", "c_uniform_u20"),
                        ("fast_round", "a_distinct_all_kinds"),
                        ("slow_round", "c_uniform_u20"),
                        ("round_epilogue", "c_uniform_u20")):
        t = ref[bench]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t.get("library_ms")})
    for name in TABLE_KERNELS:
        t = table_kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    g = guard_timing["seqlock"]
    rows.append({
        "name": "digest_rows", "route": "cuda",
        "source": KERNELS["digest_rows"][0],
        "replaces": KERNELS["digest_rows"][1],
        "launches": launches_main["digest_rows"],
        "max_abs_err": smoke.max_err["digest_rows"],
        "ms": g["digest_kernel_ms"], "plain_ms": g["digest_plain_ms"],
        "bound_ms": g["digest_bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    for name, case in ATTENTION_ROW.items():
        a = attn_timing[case]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"]})
    for dtype, name in BWD.items():
        b = train_out["backward"]["timing"][f"{BWD_CASE}/{dtype}"]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches_main[name],
            "max_abs_err": smoke.max_err[name], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": b["library_ms"]})
    details = {"card": card, "build_s": build_s, "n": N, "k": K, "p": P,
               "sort_passes": passes,
               "launches_main_path": launches_main, "timing": timings,
               "slow_round_cases": slow_cases,
               "table_ops": {"m": M, "kw": KW, "vw": VW,
                             "path_wall_s": table_wall,
                             "commit_round_branch": fast_in_commit,
                             "entry_points": table_entries,
                             "kernels": table_kernels},
               "guard": {"path_wall_s": guard_wall,
                         "launches": guard_launches, "timing": guard_timing,
                         "row_gather": row_gather},
               "attention": {"cases": {n: c._asdict() for n, c in
                                       ATTENTION_CASES.items()},
                             "launches": attn_launches,
                             "kernel": attn_kernel,
                             "max_abs_err": attn_err, "timing": attn_timing},
               "obs": {"phase_s": obs_s, "layouts": obs_out},
               "sync": {"phase_s": sync_s, "launches": sync_launches,
                        **sync_out},
               "cachehash": {"phase_s": hash_s, "launches": hash_launches,
                             "variants": hash_out},
               "txn": txn_out,
               "dist": dist_out,
               "serving": serving_out,
               "sharded_serving": sharded_out,
               "runtime": runtime_out,
               "families": families_out,
               "training": train_out,
               "kernels": rows}
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(sharded_rank_main(sys.argv[2:])
             if sys.argv[1:2] == ["--sharded-rank"] else main())
