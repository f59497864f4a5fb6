"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/lib<name>.so csrc/<name>.cu

The output directory is keyed by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Builds
run at first use (``load``) or all at once, one ``nvcc`` per source started
together (``build_all``).  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/kernels (listed in .gitignore): src/repro_torch/kernels -> repo
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("flash_attention",)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on the machine with the card")
    return found


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / key / f"lib{name}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path, float]]:
    src, lib = _target(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), lib, time.perf_counter()


def _finish(name: str, started) -> float:
    proc, tmp, lib, t0 = started
    out, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    (lib.parent / f"{name}.nvcc.log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return seconds


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every listed kernel that is not built yet, all ``nvcc``
    processes at once.  Returns the wall seconds of each build run here."""
    started = {n: s for n in names if (s := _start(n)) is not None}
    return {n: _finish(n, s) for n, s in started.items()}


def build_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output of the current build of ``name``."""
    _, lib = _target(name)
    log = lib.parent / f"{name}.nvcc.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``lib<name>.so``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LOADED[name] = lib
    return lib
