"""ctypes binding for the native data runtime (`runtime/matryio.cc`).

The port's counterpart of `matryodshka_tpu/data/native.py`: libmatryio
decodes JPEGs (libjpeg), resamples them with the fractional box filter
of tf.image.resize_area and loads batches on native threads, in C++ on
the host (no device kernel). The port builds its own copy of the library
from the repo's source with `g++ -O3 -fPIC -std=c++17 -shared ... -ljpeg`
into `matryodshka_tpu_torch/_build/` (not into runtime/), under a name
that carries a hash of the source, at the first call, not at import.
Where it cannot be built or loaded (no g++ or no libjpeg), the callers
fall back to PIL, as the JAX package does; `native_available()` says
which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "runtime" / "matryio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmatryio_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile the library into so (atomically: a private temporary file,
    then a rename, so concurrent processes never load half a file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXXFLAGS, str(SOURCE), "-o", str(tmp),
                        "-ljpeg"], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not SOURCE.exists():
        return None
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.matryio_decode_resize_opt.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
    lib.matryio_decode_resize_opt.restype = ctypes.c_int
    lib.matryio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p]
    lib.matryio_load_batch.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """True when the native library is built and loaded (building it on
    the first call)."""
    return _load() is not None


def decode_resize(path: str, height: int, width: int,
                  fast: bool = True) -> np.ndarray:
    """Decode and area-resize one JPEG -> float32 [H, W, 3] in [0, 1].

    fast=True decodes in the DCT domain at the smallest scale not below
    the target, then box-resizes (a slightly different prefilter);
    fast=False decodes at full resolution first, as PIL and TF do."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmatryio not available")
    out = np.empty((height, width, 3), np.float32)
    rc = lib.matryio_decode_resize_opt(
        path.encode(), height, width, 1 if fast else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"matryio failed to decode {path} (rc={rc})")
    return out


def load_batch(paths: List[str], height: int, width: int,
               n_threads: int = 8) -> np.ndarray:
    """Decode and resize a batch on native threads -> [N, H, W, 3]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmatryio not available")
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.matryio_load_batch(
        arr, n, height, width, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise IOError(f"matryio: {failures}/{n} images failed to load")
    return out
