"""Build the hand-written CUDA kernels of ``ops/csrc/`` on first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The sources share the headers
``csrc/*.cuh``. The library's file name carries a hash of its source and of
every header beside it, so an edited source or header is never served by a
stale build.
The only inputs are the sources in the checkout; the outputs go to
``ops/_kernels_build/``, which git ignores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "hivedscheduler_tpu_torch build from source on first use"
    )


def _target(src: Path) -> Path:
    """The library built from ``src``, named by a hash of ``src`` and of the
    ``*.cuh`` headers in its directory."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def _start(src: Path) -> Tuple[subprocess.Popen, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp


def _finish(proc: subprocess.Popen, tmp: str, src: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every source that has no current build, one ``nvcc`` per
    source, all started together. Returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        todo = [(s, _target(s)) for s in sources() if not _target(s).exists()]
        started = [(*_start(s), s, out) for s, out in todo]
        for proc, tmp, s, out in started:
            _finish(proc, tmp, s, out)
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        out = _target(src)
        if not out.exists():
            _finish(*_start(src), src, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
