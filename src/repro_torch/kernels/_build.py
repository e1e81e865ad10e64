"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` compiles into one shared library with a plain C
interface, for ``sm_90a`` (Hopper).  The library lands in the build
directory (``build/repro_torch/`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``) under a name keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source never
loads a stale build.  Nothing is built
at import: :func:`load` builds on first use, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) per source
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only where the toolkit is")
    return found


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, build_dir() / f"{name}_{digest}.so"


def _compile(name: str) -> Path:
    src, out = _target(name)
    if out.exists():
        BUILD_LOGS.setdefault(name, "(cached build)")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{BUILD_LOGS[name]}")
    os.replace(tmp, out)        # atomic: a concurrent loader never sees half
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(_compile(name)))
    return lib


def load_all(*names: str) -> None:
    """Build the named sources concurrently, one ``nvcc`` each, then load
    them: the build time of several sources is that of the slowest."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_compile, names))
    for name in names:
        load(name)
