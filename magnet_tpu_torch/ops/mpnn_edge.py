"""Fused MPNN message path, forward and backward.

Per edge j -> i of a receiver-grouped CSR graph the Brandstetter message
tail is

    z1 = send[e] + pr[i];  h1 = swish(z1);  h2 = swish(h1·W + b)

and the result is out[i] = Σ h2 over the edges of i, (N, H) float32.  The
mean over the degree is the caller's.  Two entries, as in the JAX package
(``magnet_tpu/ops/pallas_kernels.py``):

* ``fused_mpnn_edge_agg2r(pxj, pr, w, b, senders, rowptr)`` gathers
  ``send[e] = pxj[senders[e]]`` inside the kernel: the port of
  ``_mpnn2r_fwd_pallas`` and, for its gradient, ``_mpnn2r_bwd_pallas``
  (which scatters into both node tables).
* ``fused_mpnn_edge_agg(h0, pr, w, b, rowptr)`` takes ``send = h0`` (E, H)
  already gathered: the port of ``_mpnn_fwd_pallas`` and
  ``_mpnn_bwd_pallas`` (which emits ``d_h0`` per edge).

Each has its plain PyTorch version (``*_plain``, ``*_bwd_plain``) beside
it: the CPU path and the card-side reference.  On CUDA tensors the wrappers
go through a ``torch.autograd.Function`` whose forward launches
``csrc/fused_mpnn_edge_agg.cu`` and whose backward launches
``csrc/fused_mpnn_edge_agg_bwd.cu`` (hand-written, sm_90a, built and bound
by ``ops.cuda_build``), or raise.  Only CPU tensors take the plain version.
The forward saves its operands and no activation: the backward recomputes.
"""
from __future__ import annotations

import ctypes

import torch

from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops.graph import part_rows

#: hidden widths the CUDA sources are compiled for (both MPNN configs).
KERNEL_WIDTHS = {128}
#: edges per tile of the forward kernel (two partial rows a tile)
FWD_TILE = 32
FWD, BWD = "fused_mpnn_edge_agg", "fused_mpnn_edge_agg_bwd"
_ARGTYPES = {
    FWD: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    BWD: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
#: the four gradients of each backward, in the operands' order.
GRAD_NAMES_2R = ("pxj", "pr", "w", "b")
GRAD_NAMES = ("h0", "pr", "w", "b")

#: Launches so far of each kernel entry (one per launch, nowhere else):
#: ``fwd_gather`` is the in-kernel-gather forward, ``bwd_gather`` its
#: backward, ``fwd_pregathered`` / ``bwd_pregathered`` the other pair.
launches = {"fwd_gather": 0, "bwd_gather": 0,
            "fwd_pregathered": 0, "bwd_pregathered": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def swish(z):
    return z * torch.sigmoid(z)


def _receivers(rowptr):
    n = rowptr.numel() - 1
    deg = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=rowptr.device), deg)


def fused_mpnn_edge_agg_plain(h0, pr, w, b, rowptr):
    """Plain PyTorch version of the pre-gathered entry."""
    receivers = _receivers(rowptr)
    h1 = swish(h0 + pr.index_select(0, receivers))
    h2 = swish(h1 @ w + b)
    out = torch.zeros_like(pr)
    return out.index_add_(0, receivers, h2)


def fused_mpnn_edge_agg2r_plain(pxj, pr, w, b, senders, rowptr):
    """Plain PyTorch version of the in-kernel-gather entry."""
    return fused_mpnn_edge_agg_plain(pxj.index_select(0, senders.long()), pr,
                                     w, b, rowptr)


def _grads_by_autograd(fn, floats, ints, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in floats]
        out = fn(*leaves, *ints)
        return torch.autograd.grad(out, leaves, g)


def fused_mpnn_edge_agg_bwd_plain(h0, pr, w, b, rowptr, g):
    """Plain backward of the pre-gathered entry: the gradients of
    ``sum(out * g)`` in ``GRAD_NAMES`` order, by autograd."""
    return _grads_by_autograd(fused_mpnn_edge_agg_plain, (h0, pr, w, b),
                              (rowptr,), g)


def fused_mpnn_edge_agg2r_bwd_plain(pxj, pr, w, b, senders, rowptr, g):
    """Plain backward of the in-kernel-gather entry, ``GRAD_NAMES_2R``
    order, by autograd."""
    return _grads_by_autograd(fused_mpnn_edge_agg2r_plain, (pxj, pr, w, b),
                              (senders, rowptr), g)


def _check(src, pr, w, b, senders, rowptr):
    """Types, shapes and layout; ``senders`` is None for the pre-gathered
    entry, whose ``src`` is h0 (E, H).  Returns (N, E, H)."""
    floats = dict(src=src, pr=pr, w=w, b=b)
    ints = dict(rowptr=rowptr) if senders is None else dict(
        senders=senders, rowptr=rowptr)
    dev = src.device
    for name, t in {**floats, **ints}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the first operand "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (got {t.dtype})")
    if pr.dim() != 2 or rowptr.dim() != 1:
        raise ValueError("pr must be (N, H) and rowptr (N+1,)")
    n, h = pr.shape
    e = src.shape[0] if senders is None else senders.shape[0]
    want = dict(src=(e if senders is None else n, h), w=(h, h), b=(h,),
                rowptr=(n + 1,))
    if senders is not None:
        want["senders"] = (e,)
    for name, shape in want.items():
        got = tuple({**floats, **ints}[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, expected {shape}")
    # on the card this would cost a read from the device per launch: there
    # the kernels clamp every edge range to the E rows they were given
    if dev.type == "cpu" and int(rowptr[-1]) != e:
        raise ValueError(f"rowptr ends at {int(rowptr[-1])}, but there are "
                         f"{e} edge rows")
    return n, e, h


def _check_cuda(src, h):
    if src.device.type != "cuda":
        raise ValueError(f"no fused MPNN kernel for device {src.device}")
    if h not in KERNEL_WIDTHS:
        raise ValueError(f"the CUDA kernels are compiled for H in "
                         f"{sorted(KERNEL_WIDTHS)}, got {h}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(src, pr, w, b, senders, rowptr):
    n, e, h = _check(src, pr, w, b, senders, rowptr)
    _check_cuda(src, h)
    for name, t in (("src", src), ("pr", pr)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 rows)")
    # a receiver of degree 0 is never written; a receiver that crosses a
    # tile boundary leaves partial rows for the kernel's second pass
    out = torch.zeros(n, h, dtype=torch.float32, device=src.device)
    part = torch.empty(part_rows(e, FWD_TILE), h, dtype=torch.float32,
                       device=src.device)
    fn = cuda_build.function(FWD, _ARGTYPES[FWD])
    gather = senders is not None
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), pr.data_ptr(), w.data_ptr(), b.data_ptr(),
                 _ptr(senders), rowptr.data_ptr(), out.data_ptr(),
                 part.data_ptr(), n, e, h, int(gather), stream)
    if err != 0:
        raise RuntimeError(f"fused_mpnn_edge_agg launch failed: cudaError {err}")
    if cuda_build.launching():
        launches["fwd_gather" if gather else "fwd_pregathered"] += 1
    return out


def bwd_blocks(dev) -> int:
    """Rows of the backward's partial weight gradients: one per block of
    its persistent grid, two blocks per SM."""
    return 2 * torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_bwd(src, pr, w, b, senders, rowptr, g):
    n, e, h = _check(src, pr, w, b, senders, rowptr)
    _check_cuda(src, h)
    if (g.device != src.device or g.dtype != torch.float32
            or tuple(g.shape) != (n, h) or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 ({n}, {h}) tensor "
                         f"on {src.device}")
    dev = src.device
    gather = senders is not None
    n_blocks = bwd_blocks(dev)
    # the kernel adds into the node tables with atomics; d_h0 it writes
    d_pr = torch.zeros(n, h, dtype=torch.float32, device=dev)
    d_src = torch.zeros_like(src) if gather else torch.empty_like(src)
    wgrad = torch.empty(h * h + h, dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, h * h + h, dtype=torch.float32,
                          device=dev)
    fn = cuda_build.function(BWD, _ARGTYPES[BWD])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), pr.data_ptr(), w.data_ptr(), b.data_ptr(),
                 _ptr(senders), rowptr.data_ptr(), g.data_ptr(),
                 d_src.data_ptr(), d_pr.data_ptr(), wgrad.data_ptr(),
                 partial.data_ptr(), n, e, h, int(gather), n_blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_mpnn_edge_agg_bwd launch failed: cudaError {err}")
    if cuda_build.launching():
        launches["bwd_gather" if gather else "bwd_pregathered"] += 1
    return d_src, d_pr, wgrad[:h * h].view(h, h), wgrad[h * h:]


class FusedMPNNEdgeAgg2R(torch.autograd.Function):
    """Both kernels of the in-kernel-gather entry as one differentiable
    function of (pxj, pr, w, b); ``senders`` and ``rowptr`` get no
    gradient."""

    @staticmethod
    def forward(ctx, pxj, pr, w, b, senders, rowptr):
        operands = tuple(t.detach() for t in (pxj, pr, w, b, senders, rowptr))
        out = _launch_fwd(*operands)
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (*_launch_bwd(*ctx.saved_tensors, g.contiguous()), None, None)


class FusedMPNNEdgeAgg(torch.autograd.Function):
    """Both kernels of the pre-gathered entry as one differentiable
    function of (h0, pr, w, b)."""

    @staticmethod
    def forward(ctx, h0, pr, w, b, rowptr):
        operands = tuple(t.detach() for t in (h0, pr, w, b, rowptr))
        out = _launch_fwd(*operands[:4], None, operands[4])
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h0, pr, w, b, rowptr = ctx.saved_tensors
        return (*_launch_bwd(h0, pr, w, b, None, rowptr, g.contiguous()), None)


def fused_mpnn_edge_agg2r(pxj, pr, w, b, senders, rowptr):
    """Σ_i swish(swish(pxj[j] + pr[i])·W + b), (N, H) f32, differentiable
    in pxj, pr, w, b.

    pxj, pr (N, H) sender- and receiver-side node tables; w (H, H) as
    (in, out), b (H,); senders (E,) and rowptr (N+1,) int32, edges in
    receiver-CSR order.  The kernels trust the CSR:
    ``ops.graph.csr_from_edges`` checks it when the graph is built.
    """
    if pxj.device.type == "cpu":
        _check(pxj, pr, w, b, senders, rowptr)
        return fused_mpnn_edge_agg2r_plain(pxj, pr, w, b, senders, rowptr)
    return FusedMPNNEdgeAgg2R.apply(pxj, pr, w, b, senders, rowptr)


def fused_mpnn_edge_agg(h0, pr, w, b, rowptr):
    """Σ_i swish(swish(h0[e] + pr[i])·W + b), (N, H) f32, differentiable
    in h0, pr, w, b; h0 (E, H) is the sender side already gathered per
    edge, in receiver-CSR order."""
    if h0.device.type == "cpu":
        _check(h0, pr, w, b, None, rowptr)
        return fused_mpnn_edge_agg_plain(h0, pr, w, b, rowptr)
    return FusedMPNNEdgeAgg.apply(h0, pr, w, b, rowptr)


def fused_mpnn_edge_agg2r_bwd(pxj, pr, w, b, senders, rowptr, g):
    """(d_pxj, d_pr, d_w, d_b) of ``sum(fused_mpnn_edge_agg2r(...) * g)``:
    the backward kernel on CUDA tensors, the plain version on CPU tensors.
    ``d_pxj`` and ``d_pr`` are summed with atomics on the card and so
    differ in the last bits from run to run."""
    if pxj.device.type == "cpu":
        _check(pxj, pr, w, b, senders, rowptr)
        return fused_mpnn_edge_agg2r_bwd_plain(pxj, pr, w, b, senders,
                                               rowptr, g)
    return _launch_bwd(pxj, pr, w, b, senders, rowptr, g.contiguous())


def fused_mpnn_edge_agg_bwd(h0, pr, w, b, rowptr, g):
    """(d_h0, d_pr, d_w, d_b) of ``sum(fused_mpnn_edge_agg(...) * g)``."""
    if h0.device.type == "cpu":
        _check(h0, pr, w, b, None, rowptr)
        return fused_mpnn_edge_agg_bwd_plain(h0, pr, w, b, rowptr, g)
    return _launch_bwd(h0, pr, w, b, None, rowptr, g.contiguous())
