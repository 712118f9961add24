"""The eval harness's native host-side library (port of
``ishara_tpu/native/``): a batched Levenshtein distance in C++
(``levenshtein.cpp``, the port's own copy), compiled with ``g++`` at first
use and loaded through ``ctypes``.

The library builds into ``ishara_tpu_torch/_build/`` (ignored by git, where
the CUDA kernels build too), under a name keyed by the source's sha1: each
process writes its own temporary file and renames it into place, so
processes building at once never see half a library, and an edited
source builds anew. When the build or the load fails,
:func:`batch_levenshtein` falls back
to the Python DP (:func:`ishara_tpu_torch.evaluation.metrics.levenshtein`),
which gives the same distances, and :func:`available` reports which path is
in use. It is a host library, not a device kernel: the distances of decoded
strings are scored on the host, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "levenshtein.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build() -> ctypes.CDLL | None:
    """Compile (when the keyed library is missing) and load; None on any
    failure (no compiler, a source that does not build, a corrupt
    library)."""
    try:
        tag = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
        so = BUILD_DIR / f"liblevenshtein-{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.batch_levenshtein.restype = None
        lib.batch_levenshtein.argtypes = \
            [ctypes.POINTER(ctypes.c_int32)] * 4 + [ctypes.c_int32] * 3 \
            + [ctypes.POINTER(ctypes.c_int32)]
        return lib
    except Exception:
        return None


def _lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build()
    return _LIB


def reset() -> None:
    """Forget the loaded library, so the next call builds (or falls back)
    again."""
    global _LIB, _TRIED
    _LIB, _TRIED = None, False


def available() -> bool:
    """Whether the native library is in use (else the Python DP)."""
    return _lib() is not None


def _code_points(strings: list[str], width: int) -> np.ndarray:
    """``[len(strings), width]`` int32 code points (UTF-32), zero-padded."""
    out = np.zeros((len(strings), width), np.int32)
    for i, s in enumerate(strings):
        out[i, :len(s)] = np.frombuffer(s.encode("utf-32-le"), np.uint32) \
            .astype(np.int32)
    return out


def batch_levenshtein(preds: list[str], targets: list[str]) -> np.ndarray:
    """int32 ``[len(preds)]``: the edit distance of each pair, over code
    points. Native when the library built, else the Python DP."""
    if len(preds) != len(targets):
        raise ValueError("preds and targets must align")
    lib = _lib()
    if lib is None:
        from ..evaluation.metrics import levenshtein

        return np.asarray([levenshtein(p, t) for p, t in zip(preds, targets)],
                          np.int32)
    n = len(preds)
    na = max((len(p) for p in preds), default=0) or 1
    nb = max((len(t) for t in targets), default=0) or 1
    a, b = _code_points(preds, na), _code_points(targets, nb)
    la = np.asarray([len(p) for p in preds], np.int32)
    lb = np.asarray([len(t) for t in targets], np.int32)
    out = np.zeros((n,), np.int32)

    def ptr(x):
        return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    lib.batch_levenshtein(ptr(a), ptr(b), ptr(la), ptr(lb), n, na, nb,
                          ptr(out))
    return out


__all__ = ["available", "batch_levenshtein", "reset"]
