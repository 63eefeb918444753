"""Build and load the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<hash>/lib<name>.so``
under the repository root (``build/`` is git-ignored), compiled by
``nvcc`` for ``sm_90a`` with a plain C interface and loaded with
``ctypes``. The directory is keyed on a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads the existing
library. All sources compile in parallel, one ``nvcc`` each. Nothing here
runs at import time; a missing ``nvcc`` or a failed compile raises.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"

# --fmad=false: no contraction into FMA, so the bisection keeps the
# reference's rounding step for step (bitwise parity)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_LIBS: dict = {}
#: seconds spent compiling in this process, and nvcc's -Xptxas -v report
BUILD_INFO: dict = {"seconds": 0.0, "ptxas": {}}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _build_dir(sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that has no library yet, in parallel;
    return the build directory (keyed on the ``.cu`` and ``.cuh`` files)."""
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = _build_dir(sources + sorted(CSRC.glob("*.cuh")))
    todo = [s for s in sources if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((src, tmp, p))
    failed = []
    for src, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_INFO["ptxas"][src.name] = log
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    BUILD_INFO["seconds"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib
