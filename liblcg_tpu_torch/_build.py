"""Lazy ``nvcc`` build of the CUDA sources and their ``ctypes`` binding.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/liblcg_tpu_torch/<name>-<hash>.so`` at the root of the
checkout.  The hash covers the source, every ``csrc/*.cuh`` header and the
compiler flags, so an edit rebuilds.  Nothing is built when the package is
imported: the first wrapper call on a CUDA tensor builds its source, or
:func:`build_all` builds every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "liblcg_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels of liblcg_tpu_torch are built from source with it"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def sources() -> List[str]:
    """Names of the CUDA sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` unless it is built already; return the
    library's path.  A failed build raises with nvcc's stderr; the ptxas
    report of a successful one is kept beside the library as ``.log``."""
    target = _target(name)
    if target.is_file():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    target.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, target)
    return target


def build_all() -> Dict[str, Path]:
    """Build every source; return each one's library path."""
    return {name: build(name) for name in sources()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    The caller declares its functions and keeps it."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """The ptxas report (registers, shared memory, spills) of the last
    build of ``csrc/<name>.cu``, or "" when it was not built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""
