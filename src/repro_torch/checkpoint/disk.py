"""Atomic disk checkpoints of nested tensors and arrays.

The durability protocol is the seqlock / validated-pointer idea applied to
the filesystem: leaf arrays are written as `.npy` files to a staging
directory, a manifest naming every leaf is written LAST (write-then-
rename), and the staging directory is then renamed to `step_%08d`.  The
manifest is the validated pointer: a crash mid-write leaves a staging
directory that restore ignores, never a torn checkpoint.

A state is a tree of dicts, lists, tuples and NamedTuples whose leaves are
torch tensors or numpy arrays (None is an empty subtree).  Its leaves are
keyed by their `/`-joined path: a dict key as itself (keys in sorted
order), a sequence index as its number, a NamedTuple field as `.name`.
Each leaf is the file `<key with "/" replaced by "__">.npy`.  Every leaf
carries a CRC32 of its bytes in the manifest; `restore_latest` walks steps
newest first past any that fail it.  The layout, the keys, the file names
and the CRCs are those of the JAX package's `checkpoint.disk`, so a
checkpoint either package writes restores bit for bit through the other.

Dtypes numpy cannot `np.save` (bfloat16, the float8 types) are stored as
their unsigned view of the same width, with the logical name (e.g.
"bfloat16") in the manifest.  Words are whatever dtype the caller hands in:
the executor converts its int32 word tensors to uint32 at this boundary,
so its files hold the reference's bytes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zlib

import numpy as np
import torch


class CheckpointError(Exception):
    """A checkpoint failed verification (corrupt, truncated, or missing a
    leaf): `restore_latest` falls back to the newest step that verifies."""


_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".", 1)[1]


def _to_native(leaf) -> tuple[np.ndarray, str]:
    """(the bytes numpy can save, the logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _dtype_name(t.dtype)
        if name in _NATIVE:
            return t.numpy(), name
        signed = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}[t.element_size()]
        raw = t.view(signed).numpy()
        return raw.view(np.dtype(f"u{raw.itemsize}")), name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name in _NATIVE:
        return arr, name
    return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), name


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """[(path tuple, leaf)] in the reference's order: dict keys sorted,
    sequences by index, NamedTuple fields as `.name`; None is empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], prefix + (str(key),))
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += _flatten(v, prefix + (f".{name}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def _key(path) -> str:
    return "/".join(path)


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out[key] = _rebuild(tree[key], leaves)
        return {key: out[key] for key in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    meta: dict | None = None) -> str:
    """Write `state` atomically as <ckpt_dir>/step_<step>."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    stage = tempfile.mkdtemp(prefix=".staging_", dir=ckpt_dir)
    manifest = {"step": step, "leaves": {}, "meta": meta or {}}
    try:
        for path, leaf in _flatten(state):
            key = _key(path)
            raw, dtype_name = _to_native(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(stage, fname), raw)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(raw.shape), "dtype": dtype_name,
                "crc32": zlib.crc32(np.ascontiguousarray(raw).tobytes())}
        # the manifest LAST, itself write-then-rename: a crash never
        # leaves a torn manifest that still parses
        mtmp = os.path.join(stage, ".manifest.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(stage, "manifest.json"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(stage, final)                 # atomic on one filesystem
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{8})", name)
        # only manifest-complete (validated) checkpoints count
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _signed_tensor(raw: np.ndarray) -> torch.Tensor:
    """`raw` as a CPU tensor of the same bytes (unsigned wider than a byte
    as the signed type of its width)."""
    if raw.dtype.kind == "u" and raw.itemsize > 1:
        raw = raw.view(np.dtype(f"i{raw.itemsize}"))
    return torch.from_numpy(np.ascontiguousarray(raw))


def _leaf_tensor(raw: np.ndarray, name: str, dtype: torch.dtype, device
                 ) -> torch.Tensor:
    """A restored leaf as a tensor of the template's `dtype`: the same bits
    where the widths agree and both are integers (uint32 words as int32),
    or the logical dtype's bits reinterpreted, else a value cast."""
    t = _signed_tensor(raw)
    logical = getattr(torch, name, None)
    if name not in _NATIVE and isinstance(logical, torch.dtype):
        t = t.view(logical)
    if t.dtype != dtype:
        both_int = not (t.dtype.is_floating_point or dtype.is_floating_point
                        or t.dtype == torch.bool or dtype == torch.bool)
        t = t.view(dtype) if both_int and \
            t.element_size() == dtype.itemsize else t.to(dtype)
    return t.to(device)


def _leaf_array(raw: np.ndarray, name: str, like) -> np.ndarray:
    """A restored leaf as a numpy array of the template leaf's dtype; a
    dtype numpy lacks (bfloat16) comes back as its unsigned view."""
    want = getattr(like, "dtype", raw.dtype)
    if name not in _NATIVE or raw.dtype == want:
        return raw
    return np.asarray(raw, want)


def restore_checkpoint(ckpt_dir: str, step: int, template, *, device=None,
                       verify: bool = False):
    """Restore into the structure of `template`; returns (state, meta).

    A template leaf that is a tensor comes back as a tensor of its dtype on
    `device` (default: the template leaf's device); any other leaf comes
    back as a numpy array of its dtype, or with `device=` as a tensor
    there.

    verify=True checks every leaf against its manifest CRC32 and raises
    `CheckpointError` on any damage (corrupt bytes, truncated file,
    missing leaf) instead of returning silently wrong state; a checkpoint
    without CRCs loads unverified."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_out = []
    for leaf_path, want in _flatten(template):
        key = _key(leaf_path)
        ent = manifest["leaves"].get(key)
        if ent is None:
            if verify:
                raise CheckpointError(f"checkpoint missing leaf {key!r}")
            raise KeyError(f"checkpoint missing leaf {key!r}")
        try:
            raw = np.load(os.path.join(path, ent["file"]))
        except Exception as e:               # truncated / unreadable npy
            if verify:
                raise CheckpointError(f"{key}: unreadable leaf "
                                      f"({type(e).__name__}: {e})") from e
            raise
        if verify and ent.get("crc32") is not None:
            got = zlib.crc32(np.ascontiguousarray(raw).tobytes())
            if got != ent["crc32"]:
                raise CheckpointError(
                    f"{key}: CRC mismatch ({got:#010x} != "
                    f"{ent['crc32']:#010x})")
        shape = tuple(want.shape)
        if tuple(raw.shape) != shape:
            if verify:
                raise CheckpointError(f"{key}: shape {raw.shape} != {shape}")
            raise ValueError(f"{key}: shape {raw.shape} != {shape}")
        if isinstance(want, torch.Tensor):
            leaves_out.append(_leaf_tensor(
                raw, ent["dtype"], want.dtype,
                want.device if device is None else device))
        elif device is not None:
            leaves_out.append(_leaf_tensor(raw, ent["dtype"],
                                           _torch_dtype(ent["dtype"]),
                                           device))
        else:
            leaves_out.append(_leaf_array(raw, ent["dtype"], want))
    return _rebuild(template, iter(leaves_out)), manifest.get("meta", {})


def _torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype a leaf with no tensor template restores to on a
    device: its logical dtype, 32-bit words (uint32) as int32 bits."""
    return torch.int32 if name == "uint32" else getattr(torch, name)


def verify_checkpoint(ckpt_dir: str, step: int) -> bool:
    """True iff every leaf of `step` reads back and matches its manifest
    CRC32 (a checkpoint without CRCs verifies by readability alone)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        for ent in manifest["leaves"].values():
            raw = np.load(os.path.join(path, ent["file"]))
            if tuple(raw.shape) != tuple(ent["shape"]) and \
                    ent["dtype"] in _NATIVE:
                return False
            crc = ent.get("crc32")
            if crc is not None and \
                    zlib.crc32(np.ascontiguousarray(raw).tobytes()) != crc:
                return False
    except Exception:
        return False
    return True


def restore_latest(ckpt_dir: str, template, *, device=None):
    """Restore the newest VERIFYING checkpoint: walks steps newest first,
    skipping any that fail CRC or read verification, and returns `(state,
    meta, step)`.  Raises `CheckpointError` when no step verifies,
    `FileNotFoundError` when there are no steps at all."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    for step in reversed(steps):
        try:
            state, meta = restore_checkpoint(ckpt_dir, step, template,
                                             device=device, verify=True)
            return state, meta, step
        except CheckpointError:
            continue
    raise CheckpointError(f"no checkpoint under {ckpt_dir} verifies "
                          f"(tried steps {steps})")
