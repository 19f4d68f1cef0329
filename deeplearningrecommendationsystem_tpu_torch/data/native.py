"""ctypes binding for the native ml-100k parser (``native/ml100k_parser.cc``).

The JAX package's ``data/native.py`` for the port. At its first use the
parser is compiled with ``c++`` into ``build/native/`` at the repository root
(git-ignored; the library's name carries a hash of the source, so an edited
parser is built anew), never into ``native/``, and loaded through ctypes.
Where it cannot be built or loaded every entry point returns None and
:func:`available` is False (:func:`build_error` says why);
``data/movielens.py`` then takes its NumPy path and records which parser it
used, so a failed build never passes for a native run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "ml100k_parser.cc"
BUILD_DIR = _ROOT / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None

_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libml100k_{digest[:16]}.so"


def _build(out: Path) -> None:
    """Compile the parser to ``out`` (written beside it, then renamed, so
    processes that build at once never load half a file)."""
    compiler = os.environ.get("CXX") or shutil.which("c++")
    if compiler is None:
        raise RuntimeError("no C++ compiler (c++ or $CXX) to build the native parser")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([compiler, *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.parse_u_data.restype = ctypes.c_int32
        lib.parse_u_data.argtypes = [ctypes.c_char_p, _I32, _I32, _F32, ctypes.c_int32]
        lib.parse_u_user.restype = ctypes.c_int32
        lib.parse_u_user.argtypes = [
            ctypes.c_char_p, _I32, _F32, _I32, ctypes.c_char_p, ctypes.c_int32,
            _I32, ctypes.c_int32,
        ]
        lib.parse_u_item.restype = ctypes.c_int32
        lib.parse_u_item.argtypes = [ctypes.c_char_p, _I32, _F32, ctypes.c_int32]
        _lib = lib
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the parser could not be built or loaded (None if it was, or was not tried)."""
    _load()
    return _error


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def parse_u_data(path: str, cap: int = 120_000):
    """-> (users, items, ratings) 0-based, or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    users = np.empty(cap, dtype=np.int32)
    items = np.empty(cap, dtype=np.int32)
    ratings = np.empty(cap, dtype=np.float32)
    n = lib.parse_u_data(
        path.encode(), _ptr(users, _I32), _ptr(items, _I32), _ptr(ratings, _F32), cap
    )
    if n < 0:
        return None
    return users[:n].copy(), items[:n].copy(), ratings[:n].copy()


def parse_u_user(
    path: str, cap: int = 2048
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]]:
    """-> (ids, ages, gender_idx, occupation_idx, occupation_categories)."""
    lib = _load()
    if lib is None:
        return None
    ids = np.empty(cap, dtype=np.int32)
    ages = np.empty(cap, dtype=np.float32)
    gidx = np.empty(cap, dtype=np.int32)
    oidx = np.empty(cap, dtype=np.int32)
    blob = ctypes.create_string_buffer(4096)
    n = lib.parse_u_user(
        path.encode(), _ptr(ids, _I32), _ptr(ages, _F32), _ptr(gidx, _I32),
        blob, len(blob), _ptr(oidx, _I32), cap,
    )
    if n < 0:
        return None
    cats = blob.value.decode().split("\n")
    return ids[:n].copy(), ages[:n].copy(), gidx[:n].copy(), oidx[:n].copy(), cats


def parse_u_item(path: str, cap: int = 4096):
    """-> (ids, genres [n, 19]) or None."""
    lib = _load()
    if lib is None:
        return None
    ids = np.empty(cap, dtype=np.int32)
    genres = np.empty(cap * 19, dtype=np.float32)
    n = lib.parse_u_item(path.encode(), _ptr(ids, _I32), _ptr(genres, _F32), cap)
    if n < 0:
        return None
    return ids[:n].copy(), genres[: n * 19].reshape(n, 19).copy()
