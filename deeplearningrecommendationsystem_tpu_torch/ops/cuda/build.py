"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``.
Libraries go to ``build/kernels/`` at the repository root, which git ignores,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags: a library is built at its first use in a checkout and reused after
that. ``build_all`` starts one ``nvcc`` per
source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """nvcc of $CUDA_HOME (or $CUDA_PATH), else the one on PATH, else /usr/local/cuda's."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is built."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}_{digest[:16]}.so"


def _start(source: str):
    """Start nvcc for ``source`` unless its library exists; returns (process or None, path)."""
    out = library_path(source)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {out.stem} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file


def build_all(sources: Iterable[str]) -> Dict[str, Path]:
    """Build every source that is not built yet, one nvcc each, in parallel."""
    with _lock:
        jobs = {src: _start(src) for src in sources}
        for started, out in jobs.values():
            _finish(started, out)
    return {src: out for src, (_, out) in jobs.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            started, out = _start(source)
            _finish(started, out)
            lib = _loaded[source] = ctypes.CDLL(str(out))
        return lib
