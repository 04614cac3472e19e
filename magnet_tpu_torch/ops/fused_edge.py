"""Fused InteractionNetwork edge pipeline, forward and backward, in two
entries.

Per edge j -> i of a receiver-grouped CSR graph the edge MLP's first-layer
pre-activation z is

    fold:         z = e0·W_e + b_e + pxj[j] + pxi[i]
    pregathered:  z = h0[e] + pxi[i]      (h0 = pxj[j] + W_e·e + b_e formed
                                           by the caller, one row per edge)

followed by h = relu(z), h = relu(h·W_k + b_k) for each tail layer,
y = LN(h·W_out + b_out); the result is out[i] = Σ y over the edges of i,
(N, C) float32.  The mean over the degree is the caller's.

* ``fused_edge_tail_agg`` (fold) is the port of the JAX package's
  ``fused_edge_tail_agg2rf`` (``magnet_tpu/ops/pallas_kernels.py``): the
  TPU kernels ``_fused2r_fwd_pallas`` and, for its gradient,
  ``_fused2r_bwd_pallas``.
* ``fused_edge_tail_agg_pregathered`` is the port of its
  ``fused_edge_tail_agg``: ``_fused_fwd_pallas`` and ``_fused_bwd_pallas``.
* ``*_plain`` is each function in plain PyTorch (gather, MLP,
  ``index_add_``) and ``*_bwd_plain`` its gradients by autograd: the CPU
  path and the card-side reference.
* On CUDA tensors the wrappers go through ``FusedEdgeTailAgg`` and
  ``FusedEdgeTailAggPregathered``, ``torch.autograd.Function``s whose
  forward launches ``csrc/fused_edge_tail_agg.cu`` and whose backward
  launches ``csrc/fused_edge_tail_agg_bwd.cu`` (hand-written, sm_90a, one
  template flag per entry, built and bound by ``ops.cuda_build``), or
  raise.  Only CPU tensors take the plain version.  The forward saves its
  operands and no activation: the backward recomputes.
"""
from __future__ import annotations

import ctypes

import torch

from magnet_tpu_torch.ops import cuda_build

LN_EPS = 1e-5
#: (Ce, H, C) widths the CUDA source is compiled for (magnet_cnn's); the
#: pregathered entry reads only (H, C).
KERNEL_WIDTHS = {(32, 64, 32)}

#: tail depths (L1) the backward CUDA source is compiled for.
KERNEL_BWD_MAX_L1 = 3
#: the gradients of each backward, in its operands' order.
GRAD_NAMES = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
              "b_out", "ln_s", "ln_b")
GRAD_NAMES_PREGATHERED = ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out",
                          "ln_s", "ln_b")

FWD, BWD = "fused_edge_tail_agg", "fused_edge_tail_agg_bwd"
_ARGTYPES = {
    FWD: [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    BWD: [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}

#: Launches of the fold entry's forward and backward kernels so far (one
#: per launch, nowhere else).
launches = 0
launches_bwd = 0
#: Launches of the pregathered entry's forward and backward kernels.
launches_pregathered = 0
launches_pregathered_bwd = 0


def reset_launches() -> None:
    global launches, launches_bwd, launches_pregathered
    global launches_pregathered_bwd
    launches = launches_bwd = 0
    launches_pregathered = launches_pregathered_bwd = 0


def _receivers(rowptr):
    n = rowptr.numel() - 1
    deg = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=rowptr.device), deg)


def _tail_sum(z, receivers, n, w_rest, b_rest, w_out, b_out, ln_s, ln_b):
    """relu -> tail layers -> out layer -> LayerNorm per edge row of z,
    summed per receiver: (n, C)."""
    h = torch.relu(z)
    for k in range(w_rest.shape[0]):
        h = torch.relu(h @ w_rest[k] + b_rest[k])
    y = h @ w_out + b_out
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) * (y - mu)).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + LN_EPS) * ln_s + ln_b
    out = torch.zeros(n, y.shape[1], dtype=y.dtype, device=y.device)
    return out.index_add_(0, receivers, y)


def fused_edge_tail_agg_plain(e0, we, be, pxj, pxi, senders, rowptr,
                              w_rest, b_rest, w_out, b_out, ln_s, ln_b):
    """Plain PyTorch version of the fold entry: same arguments and result
    as the kernel."""
    receivers = _receivers(rowptr)
    z = (e0 @ we + be + pxj.index_select(0, senders)
         + pxi.index_select(0, receivers))
    return _tail_sum(z, receivers, rowptr.numel() - 1, w_rest, b_rest,
                     w_out, b_out, ln_s, ln_b)


def fused_edge_tail_agg_pregathered_plain(h0, pxi, rowptr, w_rest, b_rest,
                                          w_out, b_out, ln_s, ln_b):
    """Plain PyTorch version of the pregathered entry."""
    receivers = _receivers(rowptr)
    return _tail_sum(h0 + pxi.index_select(0, receivers), receivers,
                     rowptr.numel() - 1, w_rest, b_rest, w_out, b_out, ln_s,
                     ln_b)


def _grads_by_autograd(fn, floats, ints, g, order):
    """Gradients of sum(fn(...) * g) with respect to ``floats``; ``order``
    places the integer operands among them as ``fn`` takes them."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in floats]
        out = fn(*order(leaves, ints))
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    # an operand with no element (w_rest, b_rest at L1 = 0) is unused
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(floats, grads))


def fused_edge_tail_agg_bwd_plain(e0, we, be, pxj, pxi, senders, rowptr,
                                  w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                  g):
    """Plain PyTorch version of the fold entry's backward: the gradients of
    ``sum(out * g)`` with respect to the eleven float operands, in
    ``GRAD_NAMES`` order, by autograd through the plain forward."""
    return _grads_by_autograd(
        fused_edge_tail_agg_plain,
        [e0, we, be, pxj, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b],
        [senders, rowptr], g, lambda f, i: [*f[:5], *i, *f[5:]])


def fused_edge_tail_agg_pregathered_bwd_plain(h0, pxi, rowptr, w_rest,
                                              b_rest, w_out, b_out, ln_s,
                                              ln_b, g):
    """Plain backward of the pregathered entry, ``GRAD_NAMES_PREGATHERED``
    order, by autograd."""
    return _grads_by_autograd(
        fused_edge_tail_agg_pregathered_plain,
        [h0, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b], [rowptr], g,
        lambda f, i: [*f[:2], *i, *f[2:]])


def _check_operands(floats: dict, ints: dict, want: dict) -> None:
    """Device, contiguity, dtype and shape of every operand."""
    dev = next(iter(floats.values())).device
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
    for name, shape in want.items():
        got = tuple({**floats, **ints}[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, expected {shape}")


def _tail_shapes(w_rest, w_out, h):
    l1, c = w_rest.shape[0], w_out.shape[1]
    return l1, c, dict(w_rest=(l1, h, h), b_rest=(l1, h), w_out=(h, c),
                       b_out=(c,), ln_s=(c,), ln_b=(c,))


def _check(e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out,
           b_out, ln_s, ln_b):
    """The fold entry's operands; returns (E, Ce, H, C, L1, N)."""
    E, ce = e0.shape
    h = we.shape[1]
    n = rowptr.shape[0] - 1
    l1, c, tail = _tail_shapes(w_rest, w_out, h)
    _check_operands(
        dict(e0=e0, we=we, be=be, pxj=pxj, pxi=pxi, w_rest=w_rest,
             b_rest=b_rest, w_out=w_out, b_out=b_out, ln_s=ln_s, ln_b=ln_b),
        dict(senders=senders, rowptr=rowptr),
        dict(we=(ce, h), be=(h,), pxj=(n, h), pxi=(n, h), senders=(E,),
             **tail))
    return E, ce, h, c, l1, n


def _check_pregathered(h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s,
                       ln_b):
    """The pregathered entry's operands; returns (E, H, C, L1, N)."""
    if h0.dim() != 2 or rowptr.dim() != 1:
        raise ValueError("h0 must be (E, H) and rowptr (N+1,)")
    E, h = h0.shape
    n = rowptr.shape[0] - 1
    l1, c, tail = _tail_shapes(w_rest, w_out, h)
    _check_operands(
        dict(h0=h0, pxi=pxi, w_rest=w_rest, b_rest=b_rest, w_out=w_out,
             b_out=b_out, ln_s=ln_s, ln_b=ln_b),
        dict(rowptr=rowptr), dict(pxi=(n, h), **tail))
    # on the card this would cost a read from the device per launch: there
    # the kernels clamp every edge range to the E rows they were given
    if h0.device.type == "cpu" and int(rowptr[-1]) != E:
        raise ValueError(f"rowptr ends at {int(rowptr[-1])}, but there are "
                         f"{E} edge rows")
    return E, h, c, l1, n


def _check_cuda(t, widths, l1_max=None):
    if t.device.type != "cuda":
        raise ValueError(f"no fused edge kernel for device {t.device}")
    ce, h, c, l1 = widths
    if (ce, h, c) not in KERNEL_WIDTHS:
        raise ValueError(
            f"the CUDA kernels are compiled for (Ce, H, C) in "
            f"{sorted(KERNEL_WIDTHS)}, got {(ce, h, c)}")
    if l1_max is not None and l1 > l1_max:
        raise ValueError(f"the backward CUDA kernel is compiled for at most "
                         f"{l1_max} tail layers, got {l1}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _widths(src, we, be, pxj, pxi, senders, rowptr, tail):
    """(E, Ce, H, C, L1, N) of either entry; the pregathered entry (``we``
    None) takes the compiled Ce, which it does not read."""
    if we is not None:
        return _check(src, we, be, pxj, pxi, senders, rowptr, *tail)
    E, h, c, l1, n = _check_pregathered(src, pxi, rowptr, *tail)
    return E, next(iter(KERNEL_WIDTHS))[0], h, c, l1, n


def _launch_fwd(src, we, be, pxj, pxi, senders, rowptr, *tail):
    """The forward kernel; ``we``, ``be``, ``pxj``, ``senders`` None select
    the pregathered entry (``src`` is h0), else the fold entry (e0)."""
    global launches, launches_pregathered
    fold = we is not None
    E, ce, h, c, l1, n = _widths(src, we, be, pxj, pxi, senders, rowptr, tail)
    _check_cuda(src, (ce, h, c, l1))
    for name, t in (("src", src), ("pxj", pxj), ("pxi", pxi)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 rows)")
    out = torch.empty(n, c, dtype=torch.float32, device=src.device)
    fn = cuda_build.function(FWD, _ARGTYPES[FWD])
    w_rest, b_rest, w_out, b_out, ln_s, ln_b = tail
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            src.data_ptr(), _ptr(we), _ptr(be), _ptr(pxj), pxi.data_ptr(),
            _ptr(senders), rowptr.data_ptr(), w_rest.data_ptr(),
            b_rest.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            ln_s.data_ptr(), ln_b.data_ptr(), out.data_ptr(), n, E, ce, h, c,
            l1, int(fold), stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_tail_agg launch failed: cudaError {err}")
    if fold:
        launches += 1
    else:
        launches_pregathered += 1
    return out


def _launch_bwd(src, we, be, pxj, pxi, senders, rowptr, *tail_and_g):
    """The backward kernel, entries as ``_launch_fwd``.  Returns the
    gradients in ``GRAD_NAMES`` (fold) or ``GRAD_NAMES_PREGATHERED``
    order."""
    global launches_bwd, launches_pregathered_bwd
    *tail, g = tail_and_g
    fold = we is not None
    E, ce, h, c, l1, n = _widths(src, we, be, pxj, pxi, senders, rowptr, tail)
    _check_cuda(src, (ce, h, c, l1), l1_max=KERNEL_BWD_MAX_L1)
    if (g.device != src.device or g.dtype != torch.float32
            or tuple(g.shape) != (n, c) or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 ({n}, {c}) tensor "
                         f"on {src.device}")
    dev = src.device
    sizes = ([ce * h, h] if fold else []) + [l1 * h * h, l1 * h, h * c, c,
                                             c, c]
    n_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    d_src = torch.empty_like(src)
    # the kernel adds into these with atomics (one fill for both)
    d_nodes = torch.zeros(2 if fold else 1, n, h, dtype=torch.float32,
                          device=dev)
    d_pxj, d_pxi = (d_nodes[0], d_nodes[1]) if fold else (None, d_nodes[0])
    wgrad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, sum(sizes), dtype=torch.float32,
                          device=dev)
    fn = cuda_build.function(BWD, _ARGTYPES[BWD])
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            src.data_ptr(), _ptr(we), _ptr(be), _ptr(pxj), pxi.data_ptr(),
            _ptr(senders), rowptr.data_ptr(), w_rest.data_ptr(),
            b_rest.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            ln_s.data_ptr(), g.data_ptr(), d_src.data_ptr(), _ptr(d_pxj),
            d_pxi.data_ptr(), wgrad.data_ptr(), partial.data_ptr(), n, E, ce,
            h, c, l1, int(fold), n_blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_edge_tail_agg_bwd launch failed: cudaError {err}")
    parts = list(wgrad.split(sizes))
    d_wr, d_br, d_wo, d_bo, d_ls, d_lb = parts[-6:]
    tail_grads = (d_wr.view(l1, h, h), d_br.view(l1, h), d_wo.view(h, c),
                  d_bo, d_ls, d_lb)
    if fold:
        launches_bwd += 1
        return (d_src, parts[0].view(ce, h), parts[1], d_pxj, d_pxi,
                *tail_grads)
    launches_pregathered_bwd += 1
    return (d_src, d_pxi, *tail_grads)


class FusedEdgeTailAgg(torch.autograd.Function):
    """The fold entry's two CUDA kernels as one differentiable function of
    the eleven float operands (``senders`` and ``rowptr`` get no
    gradient)."""

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


class FusedEdgeTailAggPregathered(torch.autograd.Function):
    """The pregathered entry's two CUDA kernels as one differentiable
    function of (h0, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    (``rowptr`` gets no gradient)."""

    @staticmethod
    def forward(ctx, h0, pxi, rowptr, *tail):
        operands = tuple(t.detach() for t in (h0, pxi, rowptr, *tail))
        h0, pxi, rowptr, *tail = operands
        out = _launch_fwd(h0, None, None, None, pxi, None, rowptr, *tail)
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h0, pxi, rowptr, *tail = ctx.saved_tensors
        d_h0, d_pxi, *d_tail = _launch_bwd(h0, None, None, None, pxi, None,
                                           rowptr, *tail, g.contiguous())
        return (d_h0, d_pxi, None, *d_tail)


def fused_edge_tail_agg(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                        b_rest, w_out, b_out, ln_s, ln_b):
    """Per-receiver sum of the fused edge MLP + LayerNorm, fold entry,
    (N, C) f32, differentiable in every float operand.

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


def fused_edge_tail_agg_pregathered(h0, pxi, rowptr, w_rest, b_rest, w_out,
                                    b_out, ln_s, ln_b):
    """The same per-receiver sum from a first-layer input gathered per edge
    beforehand: h0 (E, H) in receiver-CSR order, pxi (N, H), rowptr (N+1,)
    int32, the tail weights as ``fused_edge_tail_agg``'s.  (N, C) f32,
    differentiable in every float operand."""
    operands = (h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    if h0.device.type == "cpu":
        _check_pregathered(*operands)
        return fused_edge_tail_agg_pregathered_plain(*operands)
    return FusedEdgeTailAggPregathered.apply(*operands)


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


def fused_edge_tail_agg_pregathered_bwd(h0, pxi, rowptr, w_rest, b_rest,
                                        w_out, b_out, ln_s, ln_b, g):
    """The eight gradients of ``sum(fused_edge_tail_agg_pregathered(...) *
    g)`` in ``GRAD_NAMES_PREGATHERED`` order; ``d_pxi`` is summed with
    atomics on the card."""
    operands = (h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    if h0.device.type == "cpu":
        _check_pregathered(*operands)
        return fused_edge_tail_agg_pregathered_bwd_plain(*operands, g)
    return _launch_bwd(h0, None, None, None, pxi, None, rowptr,
                       *operands[3:], g.contiguous())
