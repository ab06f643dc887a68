"""Build and load the port's CUDA kernels.

`nvcc` compiles `csrc/engine_round.cu` for Hopper (`sm_90a`) into a shared
library with a plain C interface, which `ctypes` loads.  The build happens
at first use, into `build/kernels/` at the root of the checkout, under a
name keyed by a hash of the source, so an edited source rebuilds and an
unchanged one loads at once.  A missing `nvcc` or a failed build raises:
nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "engine_round.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"engine_round_{digest}.so"


def build() -> Path:
    """Compile the kernels unless the library for this source exists.
    Writes the compiler's output (registers, spills) beside it as `.log`."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with its C
    signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("fast_round", "slow_round"):
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp, vp, i32,
                               vp, vp, vp, i32, vp]
                fn.restype = i32
            lib.engine_round_error_string.argtypes = [i32]
            lib.engine_round_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return f"{err} ({load().engine_round_error_string(err).decode()})"
