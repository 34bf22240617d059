"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``, then linked into one shared library with a plain C
interface that ``ctypes`` loads.  The library lives under ``build/repro_torch/``
at the repository root, named by a hash of the sources and flags, and is
built at first use: a checkout holds no binary.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "load_library", "launch", "ptr", "check", "route", "UnsupportedLaunch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --fmad=false keeps every a*b+c as a rounded product then a rounded sum, as
# the plain PyTorch versions compute them, so kernel and plain version agree.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_unpack_bits": [_P, _P, _I64, _P],
    "repro_unpack_crumbs": [_P, _P, _I64, _P],
    "repro_round_select": [_P, _P, _P, _P, _I64, _I, _P, _P, _I, _I, _I, _I, _I64, _P, _P, _P, _P],
    "repro_round_tail": [
        _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _I64, _P,
    ],
    "repro_bisect_block_sums": [_P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _P],
    "repro_bisect_ticket_slots": [],
    "repro_bisect_ticket_slot": [_P, _P],
    "repro_gumbel_topk": [_P, _I64, _I, _I, _I, _I, _I, _I64, _P, _P, _P, _P],
    "repro_fused_gumbel_topk": [_P, _P, _I64, _I, _I, _I, _I, _I, _I64, _P, _P, _P, _P],
    "repro_e3cs_update": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P],
    "repro_threefry": [_P, _I, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _F, _F, _P, _P],
    "repro_threefry_rows": [_P, _I64, _I, _I64, _I64, _I64, _I64, _I64, _I, _P, _P],
    "repro_threefry_categorical": [_P, _I, _I64, _I64, _I64, _I64, _P, _I64, _I64, _I, _I, _P, _P],
}


class UnsupportedLaunch(ValueError):
    """A launch parameter (a tile, a ``(tile, k)`` pair) that the kernel was
    not built for.  Raised before anything is launched; the autotuner skips
    such candidates and records them as skipped."""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"repro_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources if the library for their hash is missing; returns
    ``(path, seconds spent building)``.  The compiler's resource report
    (``-Xptxas -v``) is kept beside the library as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    cu, _ = _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(cu, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} (exit {p.returncode}):\n{log}")
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed (exit {link.returncode}):\n{link.stdout}{link.stderr}")
    lib.with_suffix(".log").write_text("".join(f"== {s.name}\n{log}" for s, log in zip(cu, logs)))
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every entry's argument types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptr(t) -> int | None:
    """Device pointer of a tensor (``None`` -> null)."""
    return None if t is None else t.data_ptr()


def launch(name: str, device: torch.device, *args, stream: int | None = None) -> None:
    """Call one C entry on ``stream`` (a handle; ``device``'s current stream
    by default), without synchronising, and raise on a CUDA error (a refused
    launch never runs, and a later synchronise would not say so)."""
    lib = load_library()
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def route(t: torch.Tensor) -> bool:
    """True: launch the kernel (``t`` is on a CUDA device).  False: take the
    plain version (``t`` lies on the CPU).  Any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel and no plain path for a tensor on {t.device}")


def check(t, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape on
    ``device`` (a kernel reads raw pointers and trusts all four)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )
