"""Segment sum over a CSR, and the row gather whose backward it is.

``segment_sum(x, ptr, perm)`` is ``out[s] = Σ_{k=ptr[s]}^{ptr[s+1]-1}
x[perm[k]]`` (``x[k]`` without ``perm``), (S, C) in x's dtype, f32 or bf16:
the port of the JAX package's ``blocked_segment_sum``
(``magnet_tpu/ops/pallas_kernels.py``, TPU kernel ``_pallas_impl``).  bf16
rows (the models' ``graph_dtype=bf16``) are summed in f32 and the sum is
rounded once to bf16, as the TPU kernel's one-hot product accumulates them
in f32 and its callers cast the sum back (``magnet_tpu/ops/segment.py:
127-129``).  Its main use is the backward of a sender
gather, the counterpart of ``gather_sender``'s VJP
(``magnet_tpu/ops/segment.py:113-181``): ``ptr`` and ``perm`` are then the
graph's sender CSR (``CSRGraph.snd_ptr``, ``snd_perm``).

* ``segment_sum_plain`` is the same sum in plain PyTorch (gather,
  ``index_add_``): the CPU path and the card-side reference.
* On CUDA tensors ``segment_sum`` launches ``csrc/segment_sum.cu``
  (hand-written, sm_90a, built and bound by ``ops.cuda_build``; one
  template, its C entry ``segment_sum_f32`` or ``segment_sum_bf16``), or
  raises.
  Its sums have a fixed order and no atomics, so two launches give equal
  bits.
* ``GatherRows`` is an autograd Function: its forward is the plain gather
  ``x.index_select(0, idx)`` (as ``jnp.take`` is in the JAX lane), its
  backward ``segment_sum`` over the sender CSR.
"""
from __future__ import annotations

import ctypes

import torch

from magnet_tpu_torch.ops import cuda_build

NAME = "segment_sum"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
#: the C entry of each element type
SYMBOLS = {torch.float32: f"{NAME}_f32", torch.bfloat16: f"{NAME}_bf16"}
#: widest row the CUDA kernel is compiled for
KERNEL_MAX_C = 256

#: Launches of the kernel so far (one per launch, nowhere else): over f32
#: rows (``launches``) and over bf16 rows (``launches_bf16``).
launches = 0
launches_bf16 = 0


def segment_sum_plain(x, ptr, perm=None):
    """Plain PyTorch version: same arguments and result as the kernel (the
    sums in f32, rounded once to x's dtype)."""
    n_seg = ptr.numel() - 1
    seg = torch.repeat_interleave(torch.arange(n_seg, device=ptr.device),
                                  (ptr[1:] - ptr[:-1]).long())
    rows = x if perm is None else x.index_select(0, perm)
    out = torch.zeros(n_seg, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, seg, rows.float()).to(x.dtype)


def _check(x, ptr, perm):
    ints = {"ptr": ptr} if perm is None else {"ptr": ptr, "perm": perm}
    for name, t in {"x": x, **ints}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in SYMBOLS or x.dim() != 2:
        raise TypeError(f"x must be a float32 or bfloat16 (rows, C) tensor "
                        f"(got {x.dtype}, {tuple(x.shape)})")
    for name, t in ints.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    n_items = x.shape[0] if perm is None else perm.shape[0]
    # on the card this would cost a read from the device per launch: there
    # the kernel clamps every segment to the n_items rows it was given
    if x.device.type == "cpu" and int(ptr[-1]) != n_items:
        raise ValueError(f"ptr ends at {int(ptr[-1])}, but there are "
                         f"{n_items} items")
    return n_items


def _launch(x, ptr, perm):
    n_items = _check(x, ptr, perm)
    if x.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {x.device}")
    c = x.shape[1]
    if not 0 < c <= KERNEL_MAX_C:
        raise ValueError(f"the CUDA kernel is compiled for 1 <= C <= "
                         f"{KERNEL_MAX_C}, got {c}")
    n_seg = ptr.numel() - 1
    out = torch.empty(n_seg, c, dtype=x.dtype, device=x.device)
    fn = cuda_build.function(NAME, _ARGTYPES, symbol=SYMBOLS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), ptr.data_ptr(),
                 None if perm is None else perm.data_ptr(), out.data_ptr(),
                 n_seg, n_items, c, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
    if cuda_build.launching():
        counter = "launches" if x.dtype == torch.float32 else "launches_bf16"
        globals()[counter] += 1
    return out


def segment_sum(x, ptr, perm=None):
    """Σ of the rows of x (R, C) f32 or bf16 per segment of the CSR ``ptr``
    (S+1,) int32, in the order ``perm`` (R,) int32 gives (None: x's own),
    (S, C) in x's dtype (bf16: f32 sums rounded once).  The kernel trusts
    ``perm`` to index rows of x."""
    if x.device.type == "cpu":
        _check(x, ptr, perm)
        return segment_sum_plain(x, ptr, perm)
    return _launch(x, ptr, perm)


class GatherRows(torch.autograd.Function):
    """``x.index_select(0, idx)``, (E, C), whose gradient with respect to x
    is the segment sum of the rows' cotangent over ``(ptr, perm)``, the
    CSR of ``idx`` (edges stably sorted by the row they read): the
    counterpart of ``gather_sender``.  x is f32 or bf16, its gradient in
    the same dtype.  ``idx``, ``ptr``, ``perm`` get no gradient."""

    @staticmethod
    def forward(ctx, x, idx, ptr, perm):
        ctx.save_for_backward(ptr, perm)
        return x.index_select(0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ptr, perm = ctx.saved_tensors
        return segment_sum(g.contiguous(), ptr, perm), None, None, None


def gather_rows(x, graph):
    """``x[graph.senders]`` per edge with the sender-CSR backward."""
    return GatherRows.apply(x, graph.senders, graph.snd_ptr, graph.snd_perm)
