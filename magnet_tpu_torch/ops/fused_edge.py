"""Fused InteractionNetwork edge pipeline (forward, fold-e form).

``fused_edge_tail_agg`` is the port of the TPU kernel
``magnet_tpu/ops/pallas_kernels.py:_fused2r_fwd_pallas`` as the JAX
package calls it with ``we``/``be`` (``fused_edge_tail_agg2rf``).  Per edge
j -> i of a receiver-grouped CSR graph it computes

    z = e0·W_e + b_e + pxj[j] + pxi[i];  h = relu(z);
    h = relu(h·W_k + b_k) for each tail layer;  y = LN(h·W_out + b_out)

and returns out[i] = Σ y over the edges of i, (N, C) float32.  The mean
over the degree is the caller's.

* ``fused_edge_tail_agg_plain`` is the same function in plain PyTorch
  (gather, MLP, ``index_add_``): the CPU path and the card-side reference.
* On a CUDA tensor the wrapper launches the hand-written kernel
  ``magnet_tpu_torch/csrc/fused_edge_tail_agg.cu`` (sm_90a, built with
  ``nvcc`` into ``magnet_tpu_torch/_build/`` at first use, bound with
  ``ctypes``) or raises.  Only CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LN_EPS = 1e-5
#: (Ce, H, C) widths the CUDA source is compiled for (magnet_cnn's).
KERNEL_WIDTHS = {(32, 64, 32)}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_edge_tail_agg.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: nvcc flags; the cached library's name hashes them with the source.
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
_LIB = None

#: Kernel launches so far (the wrapper adds one per launch, nowhere else).
launches = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return found


def build() -> Path:
    """Compile the kernel for sm_90a (once per source and flags) and return
    the shared library's path."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update("\0".join(_NVCC_FLAGS).encode())
    lib = _BUILD_DIR / f"fused_edge_tail_agg_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    (_BUILD_DIR / f"{lib.stem}.ptxas.txt").write_text(res.stderr)
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.fused_edge_tail_agg_f32
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fused_edge_tail_agg_plain(e0, we, be, pxj, pxi, senders, rowptr,
                              w_rest, b_rest, w_out, b_out, ln_s, ln_b):
    """Plain PyTorch version: same arguments and result as the kernel."""
    n = rowptr.numel() - 1
    deg = (rowptr[1:] - rowptr[:-1]).long()
    receivers = torch.repeat_interleave(
        torch.arange(n, device=rowptr.device), deg)
    z = (e0 @ we + be + pxj.index_select(0, senders)
         + pxi.index_select(0, receivers))
    h = torch.relu(z)
    for k in range(w_rest.shape[0]):
        h = torch.relu(h @ w_rest[k] + b_rest[k])
    y = h @ w_out + b_out
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) * (y - mu)).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + LN_EPS) * ln_s + ln_b
    out = torch.zeros(n, y.shape[1], dtype=y.dtype, device=y.device)
    return out.index_add_(0, receivers, y)


def _check(e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out,
           b_out, ln_s, ln_b):
    floats = dict(e0=e0, we=we, be=be, pxj=pxj, pxi=pxi, w_rest=w_rest,
                  b_rest=b_rest, w_out=w_out, b_out=b_out, ln_s=ln_s,
                  ln_b=ln_b)
    ints = dict(senders=senders, rowptr=rowptr)
    dev = e0.device
    for name, t in {**floats, **ints}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, e0 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (got {t.dtype})")
    E, ce = e0.shape
    h = we.shape[1]
    n = rowptr.shape[0] - 1
    l1 = w_rest.shape[0]
    c = w_out.shape[1]
    want = dict(we=(ce, h), be=(h,), pxj=(n, h), pxi=(n, h),
                senders=(E,), w_rest=(l1, h, h), b_rest=(l1, h),
                w_out=(h, c), b_out=(c,), ln_s=(c,), ln_b=(c,))
    for name, shape in want.items():
        got = tuple({**floats, **ints}[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, expected {shape}")
    return E, ce, h, c, l1, n


def fused_edge_tail_agg(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                        b_rest, w_out, b_out, ln_s, ln_b):
    """Per-receiver sum of the fused edge MLP + LayerNorm, (N, C) f32.

    e0 (E, Ce) edge latents in receiver-CSR order; we (Ce, H) with any edge
    scale already folded in, be (H,); pxj (N, H), pxi (N, H); senders (E,)
    and rowptr (N+1,) int32; w_rest (L1, H, H), b_rest (L1, H); w_out
    (H, C), b_out (C,); ln_s, ln_b (C,).  Weights are (in, out).

    The kernel trusts the CSR (rowptr from 0 up to E, senders in [0, N)):
    ``ops.graph.csr_from_edges`` checks that when the graph is built, so
    no launch pays a device-to-host read for it.
    """
    global launches
    _, ce, h, c, l1, n = _check(e0, we, be, pxj, pxi, senders, rowptr,
                                w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    if e0.device.type == "cpu":
        return fused_edge_tail_agg_plain(e0, we, be, pxj, pxi, senders,
                                         rowptr, w_rest, b_rest, w_out,
                                         b_out, ln_s, ln_b)
    if e0.device.type != "cuda":
        raise ValueError(f"no fused edge kernel for device {e0.device}")
    if (ce, h, c) not in KERNEL_WIDTHS:
        raise ValueError(
            f"the CUDA kernel is compiled for (Ce, H, C) in "
            f"{sorted(KERNEL_WIDTHS)}, got {(ce, h, c)}")
    for name, t in (("e0", e0), ("pxj", pxj), ("pxi", pxi)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 rows)")
    out = torch.empty(n, c, dtype=torch.float32, device=e0.device)
    lib = _lib()
    with torch.cuda.device(e0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_edge_tail_agg_f32(
            e0.data_ptr(), we.data_ptr(), be.data_ptr(), pxj.data_ptr(),
            pxi.data_ptr(), senders.data_ptr(), rowptr.data_ptr(),
            w_rest.data_ptr(), b_rest.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
            out.data_ptr(), n, ce, h, c, l1, stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_tail_agg launch failed: cudaError {err}")
    launches += 1
    return out
