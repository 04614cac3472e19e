"""Fused InteractionNetwork edge pipeline (fold-e form), forward and
backward.

``fused_edge_tail_agg`` is the port of the JAX package's
``fused_edge_tail_agg2rf`` (``magnet_tpu/ops/pallas_kernels.py``): the TPU
kernels ``_fused2r_fwd_pallas`` and, for its gradient,
``_fused2r_bwd_pallas``.  Per edge j -> i of a receiver-grouped CSR graph
it computes

    z = e0·W_e + b_e + pxj[j] + pxi[i];  h = relu(z);
    h = relu(h·W_k + b_k) for each tail layer;  y = LN(h·W_out + b_out)

and returns out[i] = Σ y over the edges of i, (N, C) float32.  The mean
over the degree is the caller's.

* ``fused_edge_tail_agg_plain`` is the same function in plain PyTorch
  (gather, MLP, ``index_add_``) and ``fused_edge_tail_agg_bwd_plain`` its
  eleven gradients by autograd: the CPU path and the card-side reference.
* On CUDA tensors the wrapper goes through ``FusedEdgeTailAgg``, a
  ``torch.autograd.Function`` whose forward launches
  ``csrc/fused_edge_tail_agg.cu`` and whose backward launches
  ``csrc/fused_edge_tail_agg_bwd.cu`` (hand-written, sm_90a, built and
  bound by ``ops.cuda_build``), or raises.  Only CPU tensors take the plain version.  The
  forward saves its operands and no activation: the backward recomputes.
"""
from __future__ import annotations

import ctypes

import torch

from magnet_tpu_torch.ops import cuda_build

LN_EPS = 1e-5
#: (Ce, H, C) widths the CUDA source is compiled for (magnet_cnn's).
KERNEL_WIDTHS = {(32, 64, 32)}

#: tail depths (L1) the backward CUDA source is compiled for.
KERNEL_BWD_MAX_L1 = 3
#: the eleven gradients of the backward, in the operands' order.
GRAD_NAMES = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
              "b_out", "ln_s", "ln_b")

FWD, BWD = "fused_edge_tail_agg", "fused_edge_tail_agg_bwd"
_ARGTYPES = {
    FWD: [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    BWD: [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}

#: Launches of the forward kernel so far (one per launch, nowhere else).
launches = 0
#: Launches of the backward kernel so far.
launches_bwd = 0


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


def fused_edge_tail_agg_bwd_plain(e0, we, be, pxj, pxi, senders, rowptr,
                                  w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                  g):
    """Plain PyTorch version of the backward: the gradients of
    ``sum(out * g)`` with respect to the eleven float operands, in
    ``GRAD_NAMES`` order, by autograd through the plain forward."""
    floats = [e0, we, be, pxj, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in floats]
        out = fused_edge_tail_agg_plain(*leaves[:5], senders, rowptr,
                                        *leaves[5:])
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    # an operand with no element (w_rest, b_rest at L1 = 0) is unused
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(floats, grads))


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


def _check_cuda(e0, widths, l1_max=None):
    if e0.device.type != "cuda":
        raise ValueError(f"no fused edge kernel for device {e0.device}")
    ce, h, c, l1 = widths
    if (ce, h, c) not in KERNEL_WIDTHS:
        raise ValueError(
            f"the CUDA kernels are compiled for (Ce, H, C) in "
            f"{sorted(KERNEL_WIDTHS)}, got {(ce, h, c)}")
    if l1_max is not None and l1 > l1_max:
        raise ValueError(f"the backward CUDA kernel is compiled for at most "
                         f"{l1_max} tail layers, got {l1}")


def _launch_fwd(e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out, ln_s, ln_b):
    global launches
    _, ce, h, c, l1, n = _check(e0, we, be, pxj, pxi, senders, rowptr,
                                w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    _check_cuda(e0, (ce, h, c, l1))
    for name, t in (("e0", e0), ("pxj", pxj), ("pxi", pxi)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 rows)")
    out = torch.empty(n, c, dtype=torch.float32, device=e0.device)
    fn = cuda_build.function(FWD, _ARGTYPES[FWD])
    with torch.cuda.device(e0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            e0.data_ptr(), we.data_ptr(), be.data_ptr(), pxj.data_ptr(),
            pxi.data_ptr(), senders.data_ptr(), rowptr.data_ptr(),
            w_rest.data_ptr(), b_rest.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
            out.data_ptr(), n, ce, h, c, l1, stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_tail_agg launch failed: cudaError {err}")
    launches += 1
    return out


def _launch_bwd(e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out, ln_s, ln_b, g):
    global launches_bwd
    E, ce, h, c, l1, n = _check(e0, we, be, pxj, pxi, senders, rowptr,
                                w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    _check_cuda(e0, (ce, h, c, l1), l1_max=KERNEL_BWD_MAX_L1)
    if (g.device != e0.device or g.dtype != torch.float32
            or tuple(g.shape) != (n, c) or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 ({n}, {c}) tensor "
                         f"on {e0.device}")
    dev = e0.device
    sizes = [ce * h, h, l1 * h * h, l1 * h, h * c, c, c, c]
    n_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    d_e0 = torch.empty_like(e0)
    # the kernel adds into these with atomics (one fill for both)
    d_pxj, d_pxi = torch.zeros(2, n, h, dtype=torch.float32, device=dev)
    wgrad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, sum(sizes), dtype=torch.float32,
                          device=dev)
    fn = cuda_build.function(BWD, _ARGTYPES[BWD])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            e0.data_ptr(), we.data_ptr(), be.data_ptr(), pxj.data_ptr(),
            pxi.data_ptr(), senders.data_ptr(), rowptr.data_ptr(),
            w_rest.data_ptr(), b_rest.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), ln_s.data_ptr(), g.data_ptr(),
            d_e0.data_ptr(), d_pxj.data_ptr(), d_pxi.data_ptr(),
            wgrad.data_ptr(), partial.data_ptr(), n, E, ce, h, c, l1,
            n_blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_edge_tail_agg_bwd launch failed: cudaError {err}")
    launches_bwd += 1
    d_we, d_be, d_wr, d_br, d_wo, d_bo, d_ls, d_lb = wgrad.split(sizes)
    return (d_e0, d_we.view(ce, h), d_be, d_pxj, d_pxi, d_wr.view(l1, h, h),
            d_br.view(l1, h), d_wo.view(h, c), d_bo, d_ls, d_lb)


class FusedEdgeTailAgg(torch.autograd.Function):
    """The two CUDA kernels as one differentiable function of the eleven
    float operands (``senders`` and ``rowptr`` get no gradient)."""

    @staticmethod
    def forward(ctx, *operands):
        operands = tuple(t.detach() for t in operands)
        out = _launch_fwd(*operands)
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = _launch_bwd(*ctx.saved_tensors, g.contiguous())
        return (*grads[:5], None, None, *grads[5:])


def fused_edge_tail_agg(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                        b_rest, w_out, b_out, ln_s, ln_b):
    """Per-receiver sum of the fused edge MLP + LayerNorm, (N, C) f32,
    differentiable in every float operand.

    e0 (E, Ce) edge latents in receiver-CSR order; we (Ce, H) with any edge
    scale already folded in, be (H,); pxj (N, H), pxi (N, H); senders (E,)
    and rowptr (N+1,) int32; w_rest (L1, H, H), b_rest (L1, H); w_out
    (H, C), b_out (C,); ln_s, ln_b (C,).  Weights are (in, out).

    The kernels trust the CSR (rowptr from 0 up to E, senders in [0, N)):
    ``ops.graph.csr_from_edges`` checks that when the graph is built, so
    no launch pays a device-to-host read for it.
    """
    operands = (e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out, ln_s, ln_b)
    if e0.device.type == "cpu":
        _check(*operands)
        return fused_edge_tail_agg_plain(*operands)
    return FusedEdgeTailAgg.apply(*operands)


def fused_edge_tail_agg_bwd(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                            b_rest, w_out, b_out, ln_s, ln_b, g):
    """The eleven gradients of ``sum(fused_edge_tail_agg(...) * g)``, in
    ``GRAD_NAMES`` order, all f32: the backward kernel on CUDA tensors, the
    plain version on CPU tensors.  ``d_pxj`` and ``d_pxi`` are summed with
    atomics on the card and so differ in the last bits from run to run."""
    operands = (e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out, ln_s, ln_b)
    if e0.device.type == "cpu":
        _check(*operands)
        return fused_edge_tail_agg_bwd_plain(*operands, g)
    return _launch_bwd(*operands, g.contiguous())
