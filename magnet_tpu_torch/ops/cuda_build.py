"""Builds the port's CUDA sources and binds them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for sm_90a into a shared library under ``magnet_tpu_torch/_build/``
at first use (once per content of ``csrc/`` and flags) and loaded with
``ctypes``.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: every kernel source of the port (``csrc/<name>.cu``).
KERNELS = ("fused_edge_tail_agg", "fused_edge_tail_agg_bwd",
           "fused_edge_tail_agg_bf16", "fused_edge_tail_agg_bf16_w128",
           "fused_mpnn_edge_agg", "fused_mpnn_edge_agg_bwd", "segment_sum")
#: nvcc flags; the cached library's name hashes them with the sources.
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
_FUNCTIONS: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return found


def build(name: str, csrc: Path = _CSRC) -> Path:
    """Compile ``<csrc>/<name>.cu`` for sm_90a (once per source, shared
    headers and flags) and return the shared library's path; ptxas's report
    (registers, spills) is kept beside it as ``<library stem>.ptxas.txt``.
    ``csrc`` is the package's ``csrc/`` unless a probe builds an altered
    copy."""
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update("\0".join(_NVCC_FLAGS).encode())
    lib = _BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    (_BUILD_DIR / f"{lib.stem}.ptxas.txt").write_text(res.stderr)
    os.replace(tmp, lib)
    return lib


def build_all(names=KERNELS) -> dict[str, Path]:
    """Build the named kernels, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def function(name: str, argtypes: list, symbol: str | None = None):
    """The C function ``symbol`` (``<name>_f32`` unless named) of library
    ``name`` (built if need be), returning a ``cudaError_t`` as an int."""
    symbol = symbol or f"{name}_f32"
    if symbol not in _FUNCTIONS:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[symbol] = (lib, fn)  # the library stays referenced with it
    return _FUNCTIONS[symbol][1]


def launching() -> bool:
    """Whether a kernel enqueued now launches now: not while the current
    stream is captured into a CUDA graph, where the kernel is recorded and
    launches with each replay.  The wrappers' launch counters count only
    such launches."""
    return not (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())
