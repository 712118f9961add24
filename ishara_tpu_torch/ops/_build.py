"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` compiles, with ``nvcc`` for ``sm_90a``, into its own
shared library with a plain C interface under ``ishara_tpu_torch/_build/``
(listed in ``.gitignore``). All sources compile at once, one ``nvcc`` each.
A library's file name carries a hash of its source, of the headers beside it
(``csrc/*.cuh``, which any source may include) and of the flags, so an edited
source or header builds anew and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source stem: library path}; raises with nvcc's output if one
    fails. Each build's compiler output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside its library as ``.log``."""
    srcs = sorted(SRC_DIR.glob("*.cu"))
    libs = {s.stem: _lib_path(s) for s in srcs}
    todo = [s for s in srcs if not libs[s.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in todo:
            tmp = libs[s.stem].with_name(f"{libs[s.stem].name}.{os.getpid()}.tmp")
            procs.append((s, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for s, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"nvcc failed for {s.name}:\n{out}")
                continue
            libs[s.stem].with_suffix(".log").write_text(out)
            os.replace(tmp, libs[s.stem])  # atomic: readers never see half
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build()[name]))
    return _LOADED[name]


def build_log(name: str) -> str:
    """The compiler output kept from the build of ``csrc/<name>.cu``."""
    return _lib_path(SRC_DIR / f"{name}.cu").with_suffix(".log").read_text()


def sources() -> list[str]:
    """The stems of every ``csrc/*.cu``."""
    return sorted(s.stem for s in SRC_DIR.glob("*.cu"))


def function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, returning
    a CUDA error code (0 on success); its argument types are declared on
    first use. Pass its result to :func:`check`."""
    lib = load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.ishara_error_string.argtypes = [ctypes.c_int]
        lib.ishara_error_string.restype = ctypes.c_char_p
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise when a kernel launch of library ``name`` returned ``rc`` != 0."""
    if rc:
        msg = load(name).ishara_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def device_index(t: torch.Tensor) -> int:
    """The CUDA device index of ``t``."""
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as the C functions take
    it."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
