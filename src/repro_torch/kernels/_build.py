"""Build, load and call the port's CUDA kernels.

Every source `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`)
into its own shared library with a plain C interface, which `ctypes`
loads: `engine_round.cu` (the fused engine round), `table_ops.cu` (the
raw-table kernels; both include `segment_replay.cuh`, the segment
replay), `scrub_digest.cu` (the scrub's cell digest),
`flash_attention_wgmma.cu` (forward attention on the tensor cores, bf16,
writing each row's LSE where asked) and `flash_attention_tf32x3.cu` (the
same, fp32 as three TF32 products), `flash_attention_bwd_wgmma.cu` (the
backward of attention for bf16, on the tensor cores, from that LSE; it
also includes `flash_attention_bwd_prep.cuh`, its D and dK/dV-sum passes)
and `flash_attention_bwd.cu` (the backward for fp32, on the CUDA cores).
The tensor-core kernels include `tma_wgmma.cuh`, their TMA and wgmma
building blocks, and the two bf16 ones `wgmma_bf16.cuh`, their bf16
wgmma instructions.
A build happens at first use, into `build/kernels/` at the root of the
checkout, under `<name>_<hash of the source and the headers it
includes>.so`, so an edited source or header rebuilds and an unchanged one
loads at once.  A missing
`nvcc` or a failed build raises: nothing falls back to the plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each library's entry points (all return a cudaError_t).
SIGNATURES = {
    "engine_round": {
        "round_prologue": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _I, _P],
        "fast_round": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
        "slow_round": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                       _P, _I, _P],
        "round_epilogue": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _P],
        # not a launch: the int32 words of the round's scratch
        "round_scratch": [_I],
    },
    "table_ops": {
        "seqlock_gather": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _P],
        "cas_apply_round": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I,
                            _P],
        "cas_apply_rounds": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P,
                             _P, _I, _P],
        "llsc_commit_round": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                              _I, _P],
        "cachehash_probe": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                            _I, _P],
        "cachehash_find": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P,
                           _I, _P],
    },
    "scrub_digest": {"digest_rows": [_P, _P, _I, _I, _P, _I, _P]},
    "flash_attention_wgmma": {
        "flash_attention_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _I, _P],
    },
    "flash_attention_tf32x3": {
        "flash_attention_tf32x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _I, _P],
    },
    "flash_attention_bwd_wgmma": {
        "flash_attention_bwd_wgmma": [_P] * 11 + [_I] * 6 + [_F]
        + [_I] * 5 + [_P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_F] + [_I] * 4
        + [_P],
    },
}

_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: `nvcc` on PATH, else the toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def source(name: str) -> Path:
    if name not in SIGNATURES:
        raise ValueError(f"no kernel library {name!r}; expected one of "
                         f"{sorted(SIGNATURES)}")
    return CSRC / f"{name}.cu"


def sources(name: str) -> list[Path]:
    """The library's source, then the `csrc/` headers it includes."""
    main = source(name)
    return [main, *(CSRC / h for h in _INCLUDE.findall(main.read_text()))]


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library `name` unless the library for its source exists.
    Writes the compiler's output (registers, spills) beside it as `.log`."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {out.name} ({proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Kernel library `name` (built on first call), with its C signatures
    declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = _I
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [_I]
            err_fn.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def error_string(name: str, err: int) -> str:
    text = getattr(load(name), f"{name}_error_string")(err).decode()
    return f"{err} ({text})"


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call entry point `fn_name` of library `name` with `args`, then the
    device index and the current stream; raise if the launch failed."""
    lib = load(name)
    err = getattr(lib, fn_name)(
        *args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           f"{error_string(name, err)}")


def runs_plain(device: torch.device, who: str) -> bool:
    """True on the CPU (the wrapper runs its plain version), False on a
    card (it launches its kernel); any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {device}")
    return device.type == "cpu"


def check(device: torch.device, *operands) -> None:
    """Raise ValueError unless every (name, tensor, dtype, shape) operand
    has that dtype and shape, is contiguous and lies on `device`."""
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{device}")
