"""Fused InteractionNetwork edge pipeline, forward and backward, in three
entries.

Per edge j -> i of a receiver-grouped CSR graph the edge MLP's first-layer
pre-activation z is

    fold:         z = e0·W_e + b_e + pxj[j] + pxi[i]
    pregathered:  z = h0[e] + pxi[i]      (h0 = pxj[j] + W_e·e + b_e formed
                                           by the caller, one row per edge)
    pe:           z = pe[e] + pxj[j] + pxi[i]   (pe = e·W_e + b_e formed by
                                                 the caller)

followed by h = relu(z), h = relu(h·W_k + b_k) for each tail layer,
y = LN(h·W_out + b_out); the result is out[i] = Σ y over the edges of i,
(N, C) float32.  The mean over the degree is the caller's.

* ``fused_edge_tail_agg`` (fold) is the port of the JAX package's
  ``fused_edge_tail_agg2rf`` (``magnet_tpu/ops/pallas_kernels.py``): the
  TPU kernels ``_fused2r_fwd_pallas`` and, for its gradient,
  ``_fused2r_bwd_pallas`` (#8, #9).
* ``fused_edge_tail_agg_pregathered`` is the port of its
  ``fused_edge_tail_agg``: ``_fused_fwd_pallas`` and ``_fused_bwd_pallas``
  (#2, #3).
* ``fused_edge_tail_agg_pe`` is the port of its ``fused_edge_tail_agg2``:
  ``_fused2_fwd_pallas`` (#6) and ``_fused2_bwd_pallas`` (#7), whose d_pxj
  the JAX VJP reduces outside the kernel over the sender-transpose layout;
  here the segment sum (``ops.segment``, kernel #1) over the sender CSR
  does it.  The oracles are ``_fused2_ref_impl`` and its autodiff.  The
  entry also computes what the JAX package's no-fold ragged lanes
  (``fused_edge_tail_agg2r`` / ``2h``) compute.
* ``*_plain`` is each function in plain PyTorch (gather, MLP,
  ``index_add_``) and ``*_bwd_plain`` its gradients by autograd: the CPU
  path and the card-side reference.
* ``fused_edge_tail_agg_bf16`` is the fold entry in the bf16 lane, the
  JAX package's ``fused_edge_tail_agg2rf`` on bf16 operands (its models'
  ``graph_dtype=bf16``): e0, W_e (scale folded, exact), b_e, p_xj, p_xi and
  the tail weights in bf16, ln_s and ln_b in f32.  It computes what the TPU
  kernels compute there, rounding where they round
  (``_fused2r_fwd_pallas`` with ``we``/``be``, ``pallas_kernels.py:
  1541-1572``; ``_fused2r_bwd_pallas(dpxj_in_kernel=True)``, ``:1872-
  1960``): every product on bf16 operands with f32 accumulation, each
  activation rounded to bf16 after its relu, LayerNorm in f32, y rounded
  to bf16 before the f32 receiver sum; backward, g and d_y rounded to bf16
  before any product, each d_h rounded to bf16 before its products and
  its receiver and sender sums (the bias gradients sum it unrounded),
  d_e0 written in bf16, the weight and node gradients summed in f32 and
  then, as the JAX VJP does, every gradient cast to its operand's dtype.
  ``fused_edge_tail_agg_bf16_plain`` and ``fused_edge_tail_agg_bf16_bwd_
  plain`` are its plain versions, the backward written step by step (not
  autograd through the bf16 forward, which rounds elsewhere); the
  kernels are ``csrc/fused_edge_tail_agg_bf16.cu`` (``FusedEdgeTailAggBf16``)
  at (Ce, H, C) = (32, 64, 32) and ``csrc/fused_edge_tail_agg_bf16_w128.cu``
  at (128, 128, 128).
* ``fused_edge_tail_agg_pregathered_bf16`` is the pregathered entry in the
  bf16 lane, the JAX package's ``fused_edge_tail_agg`` on bf16 operands
  (``_fused_fwd_pallas``, ``pallas_kernels.py:278``; ``_fused_bwd_pallas``,
  376): h0, p_xi and the tail weights in bf16, ln_s and ln_b in f32, the
  same rounding points as the fold entry's bf16 build after its first
  pre-activation z = f32(h0) + f32(p_xi[i]); backward, d_h0 is the
  unrounded d_h rounded once to bf16 and d_pxi the f32 sum of bf16(d_h)
  rounded once.  ``fused_edge_tail_agg_pregathered_bf16_plain`` and
  ``_bwd_plain`` are its plain versions (width-agnostic); the kernels
  (``FusedEdgeTailAggPregatheredBf16``) are the pregathered entry of
  ``csrc/fused_edge_tail_agg_bf16.cu`` at (H, C) = (64, 32) (MAgNet[CNN]
  2D's training graph) and of ``csrc/fused_edge_tail_agg_bf16_w128.cu`` at
  (128, 128) (MAgNet[GNN] on ``impl="kernel_pregathered"``).
* ``fused_edge_tail_agg_pe_bf16`` is the pe entry in the bf16 lane, the JAX
  package's ``fused_edge_tail_agg2`` on bf16 operands (``_fused2_fwd_pallas``,
  ``pallas_kernels.py:929``; ``_fused2_bwd_pallas``, 1046, and its VJP
  ``_fused2_bwd``, 1292-1330): pe, p_xj, p_xi and the tail weights in bf16,
  ln_s and ln_b in f32; z = (f32(pe) + f32(pxj[j])) + f32(pxi[i]) (``pe +
  g0 + gath``), then the fold entry's bf16 tail.  Backward, as #7 rounds:
  dz stays unrounded f32, d_pe = bf16(dz), d_pxi the f32 sum of bf16(dz)
  rounded once, and d_pxj = bf16(the f32 segment sum of the f32 dz over
  the sender CSR), the f32 #1 on f32 rows and one cast (not the fold
  lane's sum of bf16(dz)).  ``fused_edge_tail_agg_pe_bf16_plain`` and
  ``_bwd_plain`` are its plain versions (width-agnostic); the kernels
  (``FusedEdgeTailAggPeBf16``) are the pe entry of
  ``csrc/fused_edge_tail_agg_bf16.cu`` at (H, C) = (64, 32) (MAgNet[CNN],
  beside that source's fold and pregathered entries) and of
  ``csrc/fused_edge_tail_agg_bf16_w128.cu`` at (128, 128) (MAgNet[GNN],
  beside the fold entry's bf16 build at (128, 128, 128)); both write the
  unrounded dz beside d_pe for the caller's d_pxj.
* On CUDA tensors the wrappers go through ``FusedEdgeTailAgg``,
  ``FusedEdgeTailAggPregathered`` and ``FusedEdgeTailAggPe``,
  ``torch.autograd.Function``s whose forward launches
  ``csrc/fused_edge_tail_agg.cu`` and whose backward launches
  ``csrc/fused_edge_tail_agg_bwd.cu`` (hand-written, sm_90a, one template
  value per entry, built and bound by ``ops.cuda_build``), or raise.  Only
  CPU tensors take the plain version.  The forward saves its operands and
  no activation: the backward recomputes.

Compiled builds (``KERNEL_WIDTHS``), keyed by what each entry reads: fold
(Ce, H, C) = (32, 64, 32) (MAgNet[CNN]) and (128, 128, 128) (MAgNet[GNN]);
pregathered (H, C) = (64, 32) and (128, 128); pe (H, C) = (64, 32) and
(128, 128); in bf16 fold (32, 64, 32) and (128, 128, 128), pregathered (64,
32) and (128, 128), pe (64, 32) and (128, 128).  Every forward build walks tiles of
``FWD_TILE`` consecutive CSR edges with its products on the tensor cores
(in 3xTF32, or bf16) and leaves partial rows
(``ops.graph.part_rows``) for the receivers that cross a tile; the width-64
backward builds walk tiles of ``BWD_TILE`` edges the same way, one block
an SM (see the sources' headers).  Bounds on an H100 at MAgNet[GNN]'s eval
batch (84.3k LR ∪ HR edges, L1 = 3, three TF32 products at 495 TFLOP/s):
fold 81,920 multiply-adds per edge, 0.084 ms; pe 65,536, 0.067 ms; both
bound by operations.  At width 64 the pe entry does 14,336 an edge: 0.032
ms at MAgNet[CNN] 1D's eval graph (186,624 edges), bound by operations.
"""
from __future__ import annotations

import ctypes

import torch

from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops.graph import part_rows
from magnet_tpu_torch.ops.segment import segment_sum

LN_EPS = 1e-5
#: the widths each entry's CUDA kernels are compiled for: (Ce, H, C) for
#: fold, (H, C) for pregathered and pe.
KERNEL_WIDTHS = {"fold": {(32, 64, 32), (128, 128, 128)},
                 "pregathered": {(64, 32), (128, 128)},
                 "pe": {(64, 32), (128, 128)},
                 "fold_bf16": {(32, 64, 32), (128, 128, 128)},
                 "pregathered_bf16": {(64, 32), (128, 128)},
                 "pe_bf16": {(64, 32), (128, 128)}}
#: the C entry's ``entry`` argument
ENTRY = {"pregathered": 0, "fold": 1, "pe": 2}
#: edges per tile of every forward build (two scratch rows per tile)
FWD_TILE = 64
#: edges per tile of the width-64 backward builds
BWD_TILE = 64

#: tail depths (L1) the backward CUDA source is compiled for.
KERNEL_BWD_MAX_L1 = 3
#: the gradients of each backward, in its operands' order.
GRAD_NAMES = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
              "b_out", "ln_s", "ln_b")
GRAD_NAMES_PREGATHERED = ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out",
                          "ln_s", "ln_b")
GRAD_NAMES_PE = ("pe", "pxj", "pxi", "w_rest", "b_rest", "w_out", "b_out",
                 "ln_s", "ln_b")

#: the gradients of the bf16 backward that leave in f32 (their operands'
#: dtype); every other one leaves in bf16
GRAD_F32_BF16 = ("ln_s", "ln_b")

FWD, BWD = "fused_edge_tail_agg", "fused_edge_tail_agg_bwd"
#: the bf16 lane's libraries and their C functions: at width 64 fold,
#: pregathered and pe; at width 128 fold, pregathered and pe (one function
#: each way, by entry)
BF16 = "fused_edge_tail_agg_bf16"
BF16_FWD, BF16_BWD = f"{BF16}_fwd", f"{BF16}_bwd"
BF16_PRE_FWD, BF16_PRE_BWD = f"{BF16}_pregathered_fwd", f"{BF16}_pregathered_bwd"
BF16_PE_FWD, BF16_PE_BWD = f"{BF16}_pe_fwd", f"{BF16}_pe_bwd"
BF16_W128 = "fused_edge_tail_agg_bf16_w128"
BF16_W128_FWD, BF16_W128_BWD = f"{BF16_W128}_fwd", f"{BF16_W128}_bwd"
_ARGTYPES = {
    FWD: [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    BWD: [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    BF16_FWD: [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    BF16_BWD: [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    BF16_PRE_FWD: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    BF16_PRE_BWD: [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    BF16_PE_FWD: [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    BF16_PE_BWD: [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    BF16_W128_FWD: [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    BF16_W128_BWD: [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}

#: Launches of each kernel so far (one per launch, nowhere else): the fold
#: entry at width 64 (``launches``) and 128 (``launches_fold128``), the
#: pregathered entry at width 64 (``launches_pregathered``) and 128
#: (``launches_pregathered128``), the pe entry at width 128
#: (``launches_pe``) and 64 (``launches_pe64``), and the bf16 builds of the
#: fold entry at width 64 (``launches_bf16``) and 128
#: (``launches_fold128_bf16``), of the pregathered entry at width 64
#: (``launches_pregathered_bf16``) and 128
#: (``launches_pregathered128_bf16``) and of the pe entry at width 128
#: (``launches_pe_bf16``) and 64 (``launches_pe64_bf16``); ``*_bwd`` the
#: backward's.
launches = 0
launches_bwd = 0
launches_fold128 = 0
launches_fold128_bwd = 0
launches_pregathered = 0
launches_pregathered_bwd = 0
launches_pregathered128 = 0
launches_pregathered128_bwd = 0
launches_pe = 0
launches_pe_bwd = 0
launches_bf16 = 0
launches_bf16_bwd = 0
launches_pregathered_bf16 = 0
launches_pregathered_bf16_bwd = 0
launches_pregathered128_bf16 = 0
launches_pregathered128_bf16_bwd = 0
launches_fold128_bf16 = 0
launches_fold128_bf16_bwd = 0
launches_pe_bf16 = 0
launches_pe_bf16_bwd = 0
launches_pe64 = 0
launches_pe64_bwd = 0
launches_pe64_bf16 = 0
launches_pe64_bf16_bwd = 0
#: each counter's name in ``launch_counts``
_COUNTERS = {"launches": "fused_edge_fwd", "launches_bwd": "fused_edge_bwd",
             "launches_fold128": "fused_edge_fold128_fwd",
             "launches_fold128_bwd": "fused_edge_fold128_bwd",
             "launches_pregathered": "fused_edge_pregathered_fwd",
             "launches_pregathered_bwd": "fused_edge_pregathered_bwd",
             "launches_pregathered128": "fused_edge_pregathered128_fwd",
             "launches_pregathered128_bwd": "fused_edge_pregathered128_bwd",
             "launches_pe": "fused_edge_pe_fwd",
             "launches_pe_bwd": "fused_edge_pe_bwd",
             "launches_bf16": "fused_edge_bf16_fwd",
             "launches_bf16_bwd": "fused_edge_bf16_bwd",
             "launches_pregathered_bf16": "fused_edge_pregathered_bf16_fwd",
             "launches_pregathered_bf16_bwd":
                 "fused_edge_pregathered_bf16_bwd",
             "launches_pregathered128_bf16":
                 "fused_edge_pregathered128_bf16_fwd",
             "launches_pregathered128_bf16_bwd":
                 "fused_edge_pregathered128_bf16_bwd",
             "launches_fold128_bf16": "fused_edge_fold128_bf16_fwd",
             "launches_fold128_bf16_bwd": "fused_edge_fold128_bf16_bwd",
             "launches_pe_bf16": "fused_edge_pe_bf16_fwd",
             "launches_pe_bf16_bwd": "fused_edge_pe_bf16_bwd",
             "launches_pe64": "fused_edge_pe64_fwd",
             "launches_pe64_bwd": "fused_edge_pe64_bwd",
             "launches_pe64_bf16": "fused_edge_pe64_bf16_fwd",
             "launches_pe64_bf16_bwd": "fused_edge_pe64_bf16_bwd"}


def reset_launches() -> None:
    globals().update(dict.fromkeys(_COUNTERS, 0))


def launch_counts() -> dict[str, int]:
    """Every counter above, by its name in the traces."""
    return {key: globals()[name] for name, key in _COUNTERS.items()}


def _count(entry: str, widths: tuple, bwd: bool) -> None:
    """One launch of ``entry``'s kernel at ``widths``."""
    name = ("launches_fold128" if entry == "fold" and widths[1] == 128
            else "launches" if entry == "fold"
            else "launches_pe64" if entry == "pe" and widths[0] == 64
            else "launches_pregathered128"
            if entry == "pregathered" and widths[0] == 128
            else f"launches_{entry}")
    _bump(name + ("_bwd" if bwd else ""))


def _bump(counter: str) -> None:
    """One launch on ``counter`` (none while a CUDA graph is captured:
    ``cuda_build.launching``)."""
    if cuda_build.launching():
        globals()[counter] += 1


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
    as the kernel.  Its edges are the first rowptr[-1] rows, as the
    kernel's: the rows past them (a padded graph's, ``ops.graph.
    pad_edges``) add nothing, and so get a zero gradient."""
    receivers = _receivers(rowptr)
    live = receivers.numel()
    z = (e0[:live] @ we + be + pxj.index_select(0, senders[:live])
         + pxi.index_select(0, receivers))
    return _tail_sum(z, receivers, rowptr.numel() - 1, w_rest, b_rest,
                     w_out, b_out, ln_s, ln_b)


def fused_edge_tail_agg_pregathered_plain(h0, pxi, rowptr, w_rest, b_rest,
                                          w_out, b_out, ln_s, ln_b):
    """Plain PyTorch version of the pregathered entry (its edges the first
    rowptr[-1] rows, as the fold entry's)."""
    receivers = _receivers(rowptr)
    return _tail_sum(h0[:receivers.numel()] + pxi.index_select(0, receivers),
                     receivers,
                     rowptr.numel() - 1, w_rest, b_rest, w_out, b_out, ln_s,
                     ln_b)


def fused_edge_tail_agg_pe_plain(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                 snd_perm, w_rest, b_rest, w_out, b_out, ln_s,
                                 ln_b):
    """Plain PyTorch version of the pe entry (the sender CSR ``snd_ptr``,
    ``snd_perm`` is read only by the kernel path's backward; its edges the
    first rowptr[-1] rows, as the fold entry's)."""
    receivers = _receivers(rowptr)
    live = receivers.numel()
    z = (pe[:live] + pxj.index_select(0, senders[:live])
         + pxi.index_select(0, receivers))
    return _tail_sum(z, receivers, rowptr.numel() - 1, w_rest, b_rest, w_out,
                     b_out, ln_s, ln_b)


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


def fused_edge_tail_agg_pe_bwd_plain(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                     snd_perm, w_rest, b_rest, w_out, b_out,
                                     ln_s, ln_b, g):
    """Plain backward of the pe entry, ``GRAD_NAMES_PE`` order, by
    autograd."""
    return _grads_by_autograd(
        fused_edge_tail_agg_pe_plain,
        [pe, pxj, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b],
        [senders, rowptr, snd_ptr, snd_perm], g,
        lambda f, i: [*f[:3], *i, *f[3:]])


def _check_operands(floats: dict, ints: dict, want: dict,
                    dtypes: dict | None = None) -> None:
    """Device, contiguity, dtype and shape of every operand; a float
    operand's dtype is float32 unless ``dtypes`` names another."""
    dev = next(iter(floats.values())).device
    for name, t in {**floats, **ints}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the first operand "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        dtype = (dtypes or {}).get(name, torch.float32)
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
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


def _check_rows(src, rowptr, E, padded: bool = True):
    """The CSR's edges fit the E rows: rowptr[-1] <= E, the rows past it
    the dead tail of a padded graph (``ops.graph.pad_edges``); ``padded``
    False (a build that does not ``reads_live_edges``): rowptr[-1] == E.
    On the card this would cost a read from the device per launch: there
    the kernels clamp every edge range to the E rows they were given."""
    if src.device.type != "cpu":
        return
    end = int(rowptr[-1])
    if end > E or (end != E and not padded):
        raise ValueError(f"rowptr ends at {end}, but there are {E} edge "
                         f"rows")


def reads_live_edges(dtype, h: int) -> bool:
    """Whether the builds of ``dtype`` (torch.float32 or torch.bfloat16) at
    width ``h`` read the live edge count rowptr[-1] on the card, and so
    take a padded graph (``ops.graph.pad_edges``): every f32 build and the
    width-64 bf16 builds; not the width-128 bf16 ones, which take the
    host's E as the edge count."""
    return dtype == torch.float32 or h != 128


def _check(e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out,
           b_out, ln_s, ln_b, dtype=torch.float32):
    """The fold entry's operands, all f32 or (``dtype`` bf16) the bf16
    lane's; returns (E, (Ce, H, C), L1, N)."""
    E, ce = e0.shape
    h = we.shape[1]
    n = rowptr.shape[0] - 1
    l1, c, tail = _tail_shapes(w_rest, w_out, h)
    _check_operands(
        dict(e0=e0, we=we, be=be, pxj=pxj, pxi=pxi, w_rest=w_rest,
             b_rest=b_rest, w_out=w_out, b_out=b_out, ln_s=ln_s, ln_b=ln_b),
        dict(senders=senders, rowptr=rowptr),
        dict(we=(ce, h), be=(h,), pxj=(n, h), pxi=(n, h), senders=(E,),
             **tail),
        {name: dtype for name in GRAD_NAMES if name not in GRAD_F32_BF16})
    _check_rows(e0, rowptr, E, padded=reads_live_edges(dtype, h))
    return E, (ce, h, c), l1, n


def _check_pregathered(h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s,
                       ln_b, dtype=torch.float32):
    """The pregathered entry's operands, all f32 or (``dtype`` bf16) the
    bf16 lane's; returns (E, (H, C), L1, N)."""
    if h0.dim() != 2 or rowptr.dim() != 1:
        raise ValueError("h0 must be (E, H) and rowptr (N+1,)")
    E, h = h0.shape
    n = rowptr.shape[0] - 1
    l1, c, tail = _tail_shapes(w_rest, w_out, h)
    _check_operands(
        dict(h0=h0, pxi=pxi, w_rest=w_rest, b_rest=b_rest, w_out=w_out,
             b_out=b_out, ln_s=ln_s, ln_b=ln_b),
        dict(rowptr=rowptr), dict(pxi=(n, h), **tail),
        {name: dtype for name in GRAD_NAMES_PREGATHERED
         if name not in GRAD_F32_BF16})
    _check_rows(h0, rowptr, E, padded=reads_live_edges(dtype, h))
    return E, (h, c), l1, n


def _check_pe(pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, w_rest,
              b_rest, w_out, b_out, ln_s, ln_b, dtype=torch.float32):
    """The pe entry's operands, all f32 or (``dtype`` bf16) the bf16
    lane's; returns (E, (H, C), L1, N).  ``snd_ptr`` and ``snd_perm`` None:
    the kernels' operands alone."""
    if pe.dim() != 2 or rowptr.dim() != 1:
        raise ValueError("pe must be (E, H) and rowptr (N+1,)")
    E, h = pe.shape
    n = rowptr.shape[0] - 1
    l1, c, tail = _tail_shapes(w_rest, w_out, h)
    ints = dict(senders=senders, rowptr=rowptr)
    want = dict(pxj=(n, h), pxi=(n, h), senders=(E,), **tail)
    if snd_ptr is not None:
        ints.update(snd_ptr=snd_ptr, snd_perm=snd_perm)
        want.update(snd_ptr=(n + 1,), snd_perm=(E,))
    _check_operands(
        dict(pe=pe, pxj=pxj, pxi=pxi, w_rest=w_rest, b_rest=b_rest,
             w_out=w_out, b_out=b_out, ln_s=ln_s, ln_b=ln_b), ints, want,
        {name: dtype for name in GRAD_NAMES_PE if name not in GRAD_F32_BF16})
    _check_rows(pe, rowptr, E, padded=reads_live_edges(dtype, h))
    return E, (h, c), l1, n


def _check_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"no fused edge kernel for device {t.device}")


def _check_build(entry: str, widths: tuple, l1: int, bwd: bool) -> None:
    """Raise unless ``entry``'s kernels are compiled for ``widths`` ((Ce, H,
    C) for fold, (H, C) for the others) and, backward, for ``l1``."""
    if widths not in KERNEL_WIDTHS[entry]:
        names = "(Ce, H, C)" if entry == "fold" else "(H, C)"
        raise ValueError(
            f"the {entry} entry's CUDA kernels are compiled for {names} in "
            f"{sorted(KERNEL_WIDTHS[entry])}, got {widths}")
    if bwd and l1 > KERNEL_BWD_MAX_L1:
        raise ValueError(f"the backward CUDA kernel is compiled for at most "
                         f"{KERNEL_BWD_MAX_L1} tail layers, got {l1}")


def _check_aligned(**tensors):
    """The rows the kernels read as float4 (or by cp.async) start 16-byte
    aligned; None is an operand the entry does not read."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 rows)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _operands(entry, src, we, be, pxj, pxi, senders, rowptr, tail):
    """(E, widths, L1, N) of ``entry``'s operands, checked."""
    if entry == "fold":
        return _check(src, we, be, pxj, pxi, senders, rowptr, *tail)
    if entry == "pregathered":
        return _check_pregathered(src, pxi, rowptr, *tail)
    return _check_pe(src, pxj, pxi, senders, rowptr, None, None, *tail)


def _launch_fwd(entry, src, we, be, pxj, pxi, senders, rowptr, *tail):
    """The forward kernel of ``entry`` (``fold``: src is e0; ``pregathered``:
    h0, and ``we``, ``be``, ``pxj``, ``senders`` are None; ``pe``: pe, and
    ``we``, ``be`` are None).  The widths are checked before the device, so
    that a build mismatch is found whatever the device."""
    E, widths, l1, n = _operands(entry, src, we, be, pxj, pxi, senders,
                                 rowptr, tail)
    _check_build(entry, widths, l1, bwd=False)
    _check_device(src)
    _check_aligned(src=src, pxj=pxj, pxi=pxi)
    h, c = widths[-2:]
    ce = widths[0] if entry == "fold" else h
    dev = src.device
    out = torch.zeros(n, c, dtype=torch.float32, device=dev)
    part = torch.empty(part_rows(E, FWD_TILE), c, dtype=torch.float32,
                       device=dev)
    fn = cuda_build.function(FWD, _ARGTYPES[FWD])
    w_rest, b_rest, w_out, b_out, ln_s, ln_b = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            src.data_ptr(), _ptr(we), _ptr(be), _ptr(pxj), pxi.data_ptr(),
            _ptr(senders), rowptr.data_ptr(), w_rest.data_ptr(),
            b_rest.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            ln_s.data_ptr(), ln_b.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, E, ce, h, c, l1, ENTRY[entry], stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_tail_agg launch failed: cudaError {err}")
    _count(entry, widths, bwd=False)
    return out


def bwd_scratch_planes(entry: str, l1: int) -> int:
    """(E, H) planes of the width-128 backward's scratch: h_0..h_L1 and the
    gradients dy, da_L1..da_1 and, fold, dz (the other entries write dz as
    their d_src)."""
    return 2 * l1 + (3 if entry == "fold" else 2)


def _launch_bwd(entry, src, we, be, pxj, pxi, senders, rowptr, *tail_and_g):
    """The backward kernel, entries as ``_launch_fwd``.  Returns the
    gradients in ``GRAD_NAMES`` (fold) or ``GRAD_NAMES_PREGATHERED`` order
    (pregathered, and pe, whose d_pxj is the caller's)."""
    *tail, g = tail_and_g
    fold = entry == "fold"
    E, widths, l1, n = _operands(entry, src, we, be, pxj, pxi, senders,
                                 rowptr, tail)
    _check_build(entry, widths, l1, bwd=True)
    _check_device(src)
    _check_aligned(src=src, pxj=pxj, pxi=pxi)
    h, c = widths[-2:]
    ce = widths[0] if fold else h
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
    # width 128: each h_k and each layer's output gradient, one (E, H) plane
    # each (``bwd_scratch_planes``), written and read back once, then the
    # LayerNorm pass's block partials (two blocks per SM, 2 H floats each)
    scratch = (torch.empty(bwd_scratch_planes(entry, l1) * E * h
                           + 2 * n_blocks * 2 * h, dtype=torch.float32,
                           device=dev)
               if h == 128 else None)
    fn = cuda_build.function(BWD, _ARGTYPES[BWD])
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            src.data_ptr(), _ptr(we), _ptr(be), _ptr(pxj), pxi.data_ptr(),
            _ptr(senders), rowptr.data_ptr(), w_rest.data_ptr(),
            b_rest.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            ln_s.data_ptr(), g.data_ptr(), d_src.data_ptr(), _ptr(d_pxj),
            d_pxi.data_ptr(), wgrad.data_ptr(), partial.data_ptr(),
            _ptr(scratch), n, E, ce, h, c, l1, ENTRY[entry], n_blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_edge_tail_agg_bwd launch failed: cudaError {err}")
    _count(entry, widths, bwd=True)
    parts = list(wgrad.split(sizes))
    d_wr, d_br, d_wo, d_bo, d_ls, d_lb = parts[-6:]
    tail_grads = (d_wr.view(l1, h, h), d_br.view(l1, h), d_wo.view(h, c),
                  d_bo, d_ls, d_lb)
    if fold:
        return (d_src, parts[0].view(ce, h), parts[1], d_pxj, d_pxi,
                *tail_grads)
    return (d_src, d_pxi, *tail_grads)


class FusedEdgeTailAgg(torch.autograd.Function):
    """The fold entry's two CUDA kernels as one differentiable function of
    the eleven float operands (``senders`` and ``rowptr`` get no
    gradient)."""

    @staticmethod
    def forward(ctx, *operands):
        _check_device(operands[0])
        operands = tuple(t.detach() for t in operands)
        out = _launch_fwd("fold", *operands)
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = _launch_bwd("fold", *ctx.saved_tensors, g.contiguous())
        return (*grads[:5], None, None, *grads[5:])


class FusedEdgeTailAggPregathered(torch.autograd.Function):
    """The pregathered entry's two CUDA kernels as one differentiable
    function of (h0, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    (``rowptr`` gets no gradient)."""

    @staticmethod
    def forward(ctx, h0, pxi, rowptr, *tail):
        _check_device(h0)
        operands = tuple(t.detach() for t in (h0, pxi, rowptr, *tail))
        h0, pxi, rowptr, *tail = operands
        out = _launch_fwd("pregathered", h0, None, None, None, pxi, None,
                          rowptr, *tail)
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h0, pxi, rowptr, *tail = ctx.saved_tensors
        d_h0, d_pxi, *d_tail = _launch_bwd("pregathered", h0, None, None,
                                           None, pxi, None, rowptr, *tail,
                                           g.contiguous())
        return (d_h0, d_pxi, None, *d_tail)


class FusedEdgeTailAggPe(torch.autograd.Function):
    """The pe entry as one differentiable function of (pe, pxj, pxi,
    w_rest, b_rest, w_out, b_out, ln_s, ln_b): the forward is kernel #6;
    the backward is kernel #7, which writes d_pe = dz per edge, and then
    the segment-sum kernel #1 over the sender CSR (``snd_ptr``,
    ``snd_perm``) for d_pxj, as the JAX VJP reduces it outside its kernel.
    The integer operands get no gradient."""

    @staticmethod
    def forward(ctx, pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, *tail):
        _check_device(pe)
        operands = tuple(t.detach() for t in (pe, pxj, pxi, senders, rowptr,
                                              snd_ptr, snd_perm, *tail))
        pe, pxj, pxi, senders, rowptr, _, _, *tail = operands
        out = _launch_fwd("pe", pe, None, None, pxj, pxi, senders, rowptr,
                          *tail)
        ctx.save_for_backward(*operands)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, *tail = (
            ctx.saved_tensors)
        d_pe, d_pxi, *d_tail = _launch_bwd("pe", pe, None, None, pxj, pxi,
                                           senders, rowptr, *tail,
                                           g.contiguous())
        d_pxj = segment_sum(d_pe, snd_ptr, snd_perm)
        return (d_pe, d_pxj, d_pxi, None, None, None, None, *d_tail)


def fused_edge_tail_agg(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                        b_rest, w_out, b_out, ln_s, ln_b):
    """Per-receiver sum of the fused edge MLP + LayerNorm, fold entry,
    (N, C) f32, differentiable in every float operand.

    e0 (E, Ce) edge latents in receiver-CSR order; we (Ce, H) with any edge
    scale already folded in, be (H,); pxj (N, H), pxi (N, H); senders (E,)
    and rowptr (N+1,) int32; w_rest (L1, H, H), b_rest (L1, H); w_out
    (H, C), b_out (C,); ln_s, ln_b (C,).  Weights are (in, out).

    The kernels trust the CSR (rowptr from 0 up to at most E, senders in
    [0, N)): ``ops.graph.csr_from_edges`` checks that when the graph is
    built, so no launch pays a device-to-host read for it.  The edges are
    the first rowptr[-1] rows, which the kernels read on the card: a graph
    padded for a captured step (``ops.graph.pad_edges``) has dead rows
    past them, which add nothing and get zero gradients.
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


def fused_edge_tail_agg_pe(pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm,
                           w_rest, b_rest, w_out, b_out, ln_s, ln_b):
    """The same per-receiver sum from the edge projection formed
    beforehand, pe (E, H) = e·W_e + b_e in receiver-CSR order, with the
    sender rows of pxj (N, H) gathered in the kernel: pxi (N, H); senders
    (E,) and rowptr (N+1,) int32; the sender CSR snd_ptr (N+1,), snd_perm
    (E,) int32 (``CSRGraph.snd_ptr``, ``snd_perm``), read by the backward;
    the tail weights as ``fused_edge_tail_agg``'s.  (N, C) f32,
    differentiable in every float operand."""
    operands = (pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, w_rest,
                b_rest, w_out, b_out, ln_s, ln_b)
    if pe.device.type == "cpu":
        _check_pe(*operands)
        return fused_edge_tail_agg_pe_plain(*operands)
    return FusedEdgeTailAggPe.apply(*operands)


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
    return _launch_bwd("fold", *operands, g.contiguous())


def fused_edge_tail_agg_pregathered_bwd(h0, pxi, rowptr, w_rest, b_rest,
                                        w_out, b_out, ln_s, ln_b, g):
    """The eight gradients of ``sum(fused_edge_tail_agg_pregathered(...) *
    g)`` in ``GRAD_NAMES_PREGATHERED`` order; ``d_pxi`` is summed with
    atomics on the card."""
    operands = (h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    if h0.device.type == "cpu":
        _check_pregathered(*operands)
        return fused_edge_tail_agg_pregathered_bwd_plain(*operands, g)
    return _launch_bwd("pregathered", h0, None, None, None, pxi, None, rowptr,
                       *operands[3:], g.contiguous())


def fused_edge_tail_agg_pe_bwd(pe, pxj, pxi, senders, rowptr, snd_ptr,
                               snd_perm, w_rest, b_rest, w_out, b_out, ln_s,
                               ln_b, g):
    """The nine gradients of ``sum(fused_edge_tail_agg_pe(...) * g)`` in
    ``GRAD_NAMES_PE`` order: on the card kernel #7, then d_pxj by the
    segment-sum kernel #1 over the sender CSR; ``d_pxi`` is summed with
    atomics there."""
    operands = (pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, w_rest,
                b_rest, w_out, b_out, ln_s, ln_b)
    if pe.device.type == "cpu":
        _check_pe(*operands)
        return fused_edge_tail_agg_pe_bwd_plain(*operands, g)
    d_pe, d_pxi, *d_tail = _launch_bwd("pe", pe, None, None, pxj, pxi,
                                       senders, rowptr, *operands[7:],
                                       g.contiguous())
    return (d_pe, segment_sum(d_pe, snd_ptr, snd_perm), d_pxi, *d_tail)


# ---- the fold entry's bf16 lane -----------------------------------------

def _bf16_tail(z, w_rest, b_rest, w_out, b_out):
    """The bf16 lane's tail from the first pre-activation z (f32), as the
    TPU kernels round it: ([h_0 .. h_L1] bf16, y = h_L1 . W_out + b_out f32
    before LayerNorm).  bf16 operands meet in f32 products (exact) with f32
    sums."""
    f = torch.Tensor.float
    hs = [torch.relu(z).bfloat16()]
    for k in range(w_rest.shape[0]):
        hs.append(torch.relu(f(hs[-1]) @ f(w_rest[k])
                             + f(b_rest[k])).bfloat16())
    return hs, f(hs[-1]) @ f(w_out) + f(b_out)


def _bf16_chain(e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out):
    """The fold entry's bf16 recompute over its edges, the first rowptr[-1]
    rows (as the f32 plain versions read them): (receivers, [h_0 .. h_L1]
    bf16, y f32 before LayerNorm)."""
    f = torch.Tensor.float
    receivers = _receivers(rowptr)
    live = receivers.numel()
    z = ((f(e0[:live]) @ f(we) + f(be))
         + (f(pxj).index_select(0, senders[:live])
            + f(pxi).index_select(0, receivers)))
    return (receivers, *_bf16_tail(z, w_rest, b_rest, w_out, b_out))


def _bf16_pregathered_chain(h0, pxi, rowptr, w_rest, b_rest, w_out, b_out):
    """The pregathered entry's bf16 recompute, z = f32(h0) + f32(pxi[i])
    over the first rowptr[-1] rows: (receivers, [h_0 .. h_L1] bf16, y f32
    before LayerNorm)."""
    receivers = _receivers(rowptr)
    z = h0[:receivers.numel()].float() + pxi.float().index_select(
        0, receivers)
    return (receivers, *_bf16_tail(z, w_rest, b_rest, w_out, b_out))


def _ln_stats(y):
    """(xhat, rstd) of LayerNorm over the last axis, two-pass variance."""
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) * (y - mu)).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    return (y - mu) * inv, inv


def _bf16_out(receivers, y, n, ln_s, ln_b):
    """out[i] = Σ bf16(LayerNorm(y)) over the edges of i, in f32: (n, C)."""
    xhat, _ = _ln_stats(y)
    y = (xhat * ln_s + ln_b).bfloat16().float()
    out = torch.zeros(n, y.shape[1], dtype=torch.float32, device=y.device)
    return out.index_add_(0, receivers, y)


def _rnd(t):
    """t rounded to bf16, as f32."""
    return t.bfloat16().float()


def _rows_of(d, n_rows: int):
    """The gradient d of the live edges' rows, with zero rows after them to
    ``n_rows``: a padded graph's dead rows get no gradient."""
    return torch.nn.functional.pad(d, (0, 0, 0, n_rows - d.shape[0]))


def _bf16_tail_bwd(receivers, hs, y, g, w_rest, w_out, ln_s):
    """The bf16 tail's backward, step by step at the TPU kernels' rounding
    points: (d_h, (d_wr, d_br, d_wo, d_bo, d_ls, d_lb)), d_h the unrounded
    f32 gradient of the first pre-activation z, the rest f32."""
    f = torch.Tensor.float
    xhat, inv = _ln_stats(y)
    d_out = _rnd(g).index_select(0, receivers)
    d_ls, d_lb = (d_out * xhat).sum(0), d_out.sum(0)
    d_xhat = d_out * ln_s
    d_y = inv * (d_xhat - d_xhat.mean(-1, keepdim=True)
                 - xhat * (d_xhat * xhat).mean(-1, keepdim=True))
    d_wo, d_bo = f(hs[-1]).t() @ _rnd(d_y), d_y.sum(0)
    d_h = _rnd(d_y) @ f(w_out).t()
    l1, h = w_rest.shape[0], w_out.shape[0]
    d_wr, d_br = [None] * l1, [None] * l1
    for k in reversed(range(l1)):
        d_h = d_h * (hs[k + 1] > 0)
        d_wr[k], d_br[k] = f(hs[k]).t() @ _rnd(d_h), d_h.sum(0)
        d_h = _rnd(d_h) @ f(w_rest[k]).t()
    d_h = d_h * (hs[0] > 0)
    return d_h, (torch.stack(d_wr) if l1 else d_h.new_zeros(0, h, h),
                 torch.stack(d_br) if l1 else d_h.new_zeros(0, h),
                 d_wo, d_bo, d_ls, d_lb)


def fused_edge_tail_agg_bf16_plain(e0, we, be, pxj, pxi, senders, rowptr,
                                   w_rest, b_rest, w_out, b_out, ln_s, ln_b):
    """Plain PyTorch version of the fold entry's bf16 build: the kernel's
    operands (module docstring) and its (N, C) f32 result."""
    receivers, _, y = _bf16_chain(e0, we, be, pxj, pxi, senders, rowptr,
                                  w_rest, b_rest, w_out, b_out)
    return _bf16_out(receivers, y, rowptr.numel() - 1, ln_s, ln_b)


def fused_edge_tail_agg_bf16_bwd_plain(e0, we, be, pxj, pxi, senders, rowptr,
                                       w_rest, b_rest, w_out, b_out, ln_s,
                                       ln_b, g):
    """Plain backward of the bf16 build: the gradients of ``sum(out * g)``
    in ``GRAD_NAMES`` order, each in its operand's dtype, step by step at
    the rounding points of ``_fused2r_bwd_pallas`` (module docstring)."""
    f = torch.Tensor.float
    receivers, hs, y = _bf16_chain(e0, we, be, pxj, pxi, senders, rowptr,
                                   w_rest, b_rest, w_out, b_out)
    d_h, tail = _bf16_tail_bwd(receivers, hs, y, g, w_rest, w_out, ln_s)
    d16 = _rnd(d_h)
    n, h = rowptr.numel() - 1, we.shape[1]
    live = receivers.numel()
    nodes = torch.zeros(2, n, h, dtype=torch.float32, device=d16.device)
    nodes[0].index_add_(0, senders[:live].long(), d16)
    nodes[1].index_add_(0, receivers, d16)
    grads = (_rows_of(d16 @ f(we).t(), e0.shape[0]), f(e0[:live]).t() @ d16,
             d_h.sum(0), nodes[0], nodes[1], *tail)
    operands = (e0, we, be, pxj, pxi, w_rest, b_rest, w_out, b_out, ln_s,
                ln_b)
    return tuple(d.to(t.dtype) for d, t in zip(grads, operands))


def fused_edge_tail_agg_pregathered_bf16_plain(h0, pxi, rowptr, w_rest,
                                               b_rest, w_out, b_out, ln_s,
                                               ln_b):
    """Plain PyTorch version of the pregathered entry's bf16 build: the
    kernel's operands (module docstring) and its (N, C) f32 result."""
    receivers, _, y = _bf16_pregathered_chain(h0, pxi, rowptr, w_rest, b_rest,
                                              w_out, b_out)
    return _bf16_out(receivers, y, rowptr.numel() - 1, ln_s, ln_b)


def fused_edge_tail_agg_pregathered_bf16_bwd_plain(h0, pxi, rowptr, w_rest,
                                                   b_rest, w_out, b_out,
                                                   ln_s, ln_b, g):
    """Plain backward of the pregathered entry's bf16 build: the gradients
    of ``sum(out * g)`` in ``GRAD_NAMES_PREGATHERED`` order, each in its
    operand's dtype, at the rounding points of ``_fused_bwd_pallas``: d_h0
    the unrounded d_h, d_pxi the f32 sum of bf16(d_h), each then cast to
    bf16 as the JAX VJP casts them (``pallas_kernels.py:617-622``)."""
    receivers, hs, y = _bf16_pregathered_chain(h0, pxi, rowptr, w_rest,
                                               b_rest, w_out, b_out)
    d_h, tail = _bf16_tail_bwd(receivers, hs, y, g, w_rest, w_out, ln_s)
    d_pxi = torch.zeros(rowptr.numel() - 1, h0.shape[1], dtype=torch.float32,
                        device=d_h.device).index_add_(0, receivers, _rnd(d_h))
    operands = (h0, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    return tuple(d.to(t.dtype) for d, t in zip(
        (_rows_of(d_h, h0.shape[0]), d_pxi, *tail), operands))


def _check_bf16(*operands):
    """The bf16 fold entry's operands; returns (E, (Ce, H, C), L1, N)."""
    return _check(*operands, dtype=torch.bfloat16)


def _check_pregathered_bf16(*operands):
    """The bf16 pregathered entry's operands; returns (E, (H, C), L1, N)."""
    return _check_pregathered(*operands, dtype=torch.bfloat16)


def _check_build_bf16(entry: str, widths: tuple, l1: int) -> None:
    """Raise unless ``entry``'s bf16 kernels (``fold``, ``pregathered`` or
    ``pe``) are compiled for ``widths`` ((Ce, H, C) for fold, (H, C) for the
    others) and ``l1`` tail layers."""
    built = KERNEL_WIDTHS[f"{entry}_bf16"]
    if widths not in built or l1 > KERNEL_BWD_MAX_L1:
        names = "(Ce, H, C)" if entry == "fold" else "(H, C)"
        raise NotImplementedError(
            f"the {entry} entry's bf16 CUDA kernels are compiled for {names} "
            f"in {sorted(built)} with at most {KERNEL_BWD_MAX_L1} tail "
            f"layers, got {widths} and L1 = {l1}: no bf16 build at that "
            f"width (ROADMAP.md B.1.1)")


def _check_g(g, dev, n, c):
    """The cotangent of a bf16 forward's result: f32 (n, c) on ``dev``."""
    if (g.device != dev or g.dtype != torch.float32
            or tuple(g.shape) != (n, c) or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 ({n}, {c}) tensor "
                         f"on {dev}")


def _launch_bf16_fwd(e0, we, be, pxj, pxi, senders, rowptr, *tail):
    """The bf16 forward kernel (width 64, or width 128's); (N, C) f32."""
    E, widths, l1, n = _check_bf16(e0, we, be, pxj, pxi, senders, rowptr,
                                   *tail)
    _check_build_bf16("fold", widths, l1)
    _check_device(e0)
    # rows and weights by cp.async
    _check_aligned(e0=e0, pxj=pxj, pxi=pxi, we=we, w_rest=tail[0],
                   w_out=tail[2])
    if widths[1] == 128:
        return _launch_bf16_w128_fwd("fold", e0, we, be, pxj, pxi, senders,
                                     rowptr, *tail)
    ce, h, c = widths
    dev = e0.device
    out = torch.zeros(n, c, dtype=torch.float32, device=dev)
    part = torch.empty(part_rows(E, FWD_TILE), c, dtype=torch.float32,
                       device=dev)
    fn = cuda_build.function(BF16, _ARGTYPES[BF16_FWD], symbol=BF16_FWD)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (e0, we, be, pxj, pxi, senders,
                                          rowptr, *tail, out, part)),
                 n, E, ce, h, c, l1, stream)
    if err != 0:
        raise RuntimeError(f"{BF16_FWD} launch failed: cudaError {err}")
    _bump("launches_bf16")
    return out


def _bf16_bwd64_blocks(dev, n_edges):
    """Partial rows of the width-64 bf16 backward: its grid's blocks, one an
    SM and at most one a tile of ``BWD_TILE`` edges."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(n_sm, -(-n_edges // BWD_TILE))


def _launch_bf16_bwd(e0, we, be, pxj, pxi, senders, rowptr, *tail_and_g):
    """The bf16 backward kernel (width 64, or width 128's launch
    sequence): the gradients in ``GRAD_NAMES`` order, each in its operand's
    dtype."""
    *tail, g = tail_and_g
    E, widths, l1, n = _check_bf16(e0, we, be, pxj, pxi, senders, rowptr,
                                   *tail)
    _check_build_bf16("fold", widths, l1)
    _check_device(e0)
    _check_aligned(e0=e0, pxj=pxj, pxi=pxi)
    ce, h, c = widths
    _check_g(g, e0.device, n, c)
    if h == 128:
        return _launch_bf16_w128_bwd("fold", e0, we, be, pxj, pxi, senders,
                                     rowptr, *tail, g)
    _check_aligned(g=g, we=we, w_rest=tail[0], w_out=tail[2])  # cp.async
    dev = e0.device
    sizes = [ce * h, h, l1 * h * h, l1 * h, h * c, c, c, c]
    n_blocks = _bf16_bwd64_blocks(dev, E)
    d_e0 = torch.empty_like(e0)
    # the kernel adds into these with atomics (one fill for both)
    d_nodes = torch.zeros(2, n, h, dtype=torch.float32, device=dev)
    wgrad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, sum(sizes), dtype=torch.float32,
                          device=dev)
    fn = cuda_build.function(BF16, _ARGTYPES[BF16_BWD], symbol=BF16_BWD)
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (
            e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out,
            b_out, ln_s, g, d_e0, d_nodes[0], d_nodes[1], wgrad, partial)),
            n, E, ce, h, c, l1, n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"{BF16_BWD} launch failed: cudaError {err}")
    _bump("launches_bf16_bwd")
    d_we, d_be, d_wr, d_br, d_wo, d_bo, d_ls, d_lb = wgrad.split(sizes)
    bf = torch.bfloat16
    return (d_e0, d_we.view(ce, h).to(bf), d_be.to(bf), d_nodes[0].to(bf),
            d_nodes[1].to(bf), d_wr.view(l1, h, h).to(bf),
            d_br.view(l1, h).to(bf), d_wo.view(h, c).to(bf), d_bo.to(bf),
            d_ls, d_lb)


class FusedEdgeTailAggBf16(torch.autograd.Function):
    """The fold entry's bf16 build as one differentiable function of the
    eleven float operands, its gradients in their operands' dtypes: the two
    CUDA kernels, or (``plain``) the two plain versions."""

    @staticmethod
    def forward(ctx, plain, *operands):
        operands = tuple(t.detach() for t in operands)
        ctx.plain = plain
        ctx.save_for_backward(*operands)
        if plain:
            return fused_edge_tail_agg_bf16_plain(*operands)
        return _launch_bf16_fwd(*operands)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        bwd = (fused_edge_tail_agg_bf16_bwd_plain if ctx.plain
               else _launch_bf16_bwd)
        grads = bwd(*ctx.saved_tensors, g.contiguous())
        return (None, *grads[:5], None, None, *grads[5:])


def fused_edge_tail_agg_bf16(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                             b_rest, w_out, b_out, ln_s, ln_b,
                             plain: bool = False):
    """``fused_edge_tail_agg`` in the bf16 lane: the same operands, all
    bf16 but ln_s and ln_b (f32); (N, C) f32, differentiable in every float
    operand with its gradient in that operand's dtype.  CUDA tensors
    launch the bf16 kernels (or raise: (Ce, H, C) = (32, 64, 32) and (128,
    128, 128) are built); CPU tensors, or ``plain``, take the plain
    versions."""
    operands = (e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out, ln_s, ln_b)
    _check_bf16(*operands)
    return FusedEdgeTailAggBf16.apply(plain or e0.device.type == "cpu",
                                      *operands)


def fused_edge_tail_agg_bf16_bwd(e0, we, be, pxj, pxi, senders, rowptr,
                                 w_rest, b_rest, w_out, b_out, ln_s, ln_b, g):
    """The eleven gradients of ``sum(fused_edge_tail_agg_bf16(...) * g)``
    in ``GRAD_NAMES`` order: the bf16 backward kernel on CUDA tensors
    (``d_pxj`` and ``d_pxi`` summed with atomics, so their last f32 bits
    vary before the rounding to bf16), the plain version on CPU tensors."""
    operands = (e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest,
                w_out, b_out, ln_s, ln_b)
    if e0.device.type == "cpu":
        _check_bf16(*operands)
        return fused_edge_tail_agg_bf16_bwd_plain(*operands, g)
    return _launch_bf16_bwd(*operands, g.contiguous())


# ---- the pregathered entry's bf16 lane ----------------------------------

def _launch_pregathered_bf16_fwd(h0, pxi, rowptr, *tail):
    """The bf16 pregathered forward kernel (width 64, or width 128's);
    (N, C) f32."""
    E, widths, l1, n = _check_pregathered_bf16(h0, pxi, rowptr, *tail)
    _check_build_bf16("pregathered", widths, l1)
    _check_device(h0)
    _check_aligned(h0=h0, pxi=pxi, w_rest=tail[0], w_out=tail[2])
    if widths == (128, 128):
        return _launch_bf16_w128_fwd("pregathered", h0, None, None, None, pxi,
                                     None, rowptr, *tail)
    h, c = widths
    dev = h0.device
    out = torch.zeros(n, c, dtype=torch.float32, device=dev)
    part = torch.empty(part_rows(E, FWD_TILE), c, dtype=torch.float32,
                       device=dev)
    fn = cuda_build.function(BF16, _ARGTYPES[BF16_PRE_FWD],
                             symbol=BF16_PRE_FWD)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (h0, pxi, rowptr, *tail, out, part)),
                 n, E, h, c, l1, stream)
    if err != 0:
        raise RuntimeError(f"{BF16_PRE_FWD} launch failed: cudaError {err}")
    _bump("launches_pregathered_bf16")
    return out


def _launch_pregathered_bf16_bwd(h0, pxi, rowptr, *tail_and_g):
    """The bf16 pregathered backward kernel (width 64, or width 128's
    launch sequence): the gradients in ``GRAD_NAMES_PREGATHERED`` order,
    each in its operand's dtype."""
    *tail, g = tail_and_g
    E, widths, l1, n = _check_pregathered_bf16(h0, pxi, rowptr, *tail)
    _check_build_bf16("pregathered", widths, l1)
    _check_device(h0)
    _check_aligned(h0=h0, pxi=pxi)
    h, c = widths
    _check_g(g, h0.device, n, c)
    if h == 128:
        return _launch_bf16_w128_bwd("pregathered", h0, None, None, None, pxi,
                                     None, rowptr, *tail, g)
    _check_aligned(g=g, w_rest=tail[0], w_out=tail[2])  # cp.async
    dev = h0.device
    sizes = [l1 * h * h, l1 * h, h * c, c, c, c]
    n_blocks = _bf16_bwd64_blocks(dev, E)
    d_h0 = torch.empty_like(h0)
    d_pxi = torch.zeros(n, h, dtype=torch.float32, device=dev)  # atomics
    wgrad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, sum(sizes), dtype=torch.float32,
                          device=dev)
    fn = cuda_build.function(BF16, _ARGTYPES[BF16_PRE_BWD],
                             symbol=BF16_PRE_BWD)
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (
            h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, g, d_h0,
            d_pxi, wgrad, partial)), n, E, h, c, l1, n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"{BF16_PRE_BWD} launch failed: cudaError {err}")
    _bump("launches_pregathered_bf16_bwd")
    d_wr, d_br, d_wo, d_bo, d_ls, d_lb = wgrad.split(sizes)
    bf = torch.bfloat16
    return (d_h0, d_pxi.to(bf), d_wr.view(l1, h, h).to(bf),
            d_br.view(l1, h).to(bf), d_wo.view(h, c).to(bf), d_bo.to(bf),
            d_ls, d_lb)


class FusedEdgeTailAggPregatheredBf16(torch.autograd.Function):
    """The pregathered entry's bf16 build as one differentiable function of
    (h0, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b), its gradients in
    their operands' dtypes (``rowptr`` gets none): the two CUDA kernels,
    or (``plain``) the two plain versions."""

    @staticmethod
    def forward(ctx, plain, h0, pxi, rowptr, *tail):
        operands = tuple(t.detach() for t in (h0, pxi, rowptr, *tail))
        ctx.plain = plain
        ctx.save_for_backward(*operands)
        if plain:
            return fused_edge_tail_agg_pregathered_bf16_plain(*operands)
        return _launch_pregathered_bf16_fwd(*operands)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        bwd = (fused_edge_tail_agg_pregathered_bf16_bwd_plain if ctx.plain
               else _launch_pregathered_bf16_bwd)
        d_h0, d_pxi, *d_tail = bwd(*ctx.saved_tensors, g.contiguous())
        return (None, d_h0, d_pxi, None, *d_tail)


def fused_edge_tail_agg_pregathered_bf16(h0, pxi, rowptr, w_rest, b_rest,
                                         w_out, b_out, ln_s, ln_b,
                                         plain: bool = False):
    """``fused_edge_tail_agg_pregathered`` in the bf16 lane: the same
    operands, all bf16 but ln_s and ln_b (f32); (N, C) f32, differentiable
    in every float operand with its gradient in that operand's dtype.  CUDA
    tensors launch the bf16 kernels (or raise: (H, C) = (64, 32) and (128,
    128) are built); CPU tensors, or ``plain``, take the plain versions."""
    operands = (h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    _check_pregathered_bf16(*operands)
    return FusedEdgeTailAggPregatheredBf16.apply(
        plain or h0.device.type == "cpu", *operands)


def fused_edge_tail_agg_pregathered_bf16_bwd(h0, pxi, rowptr, w_rest, b_rest,
                                             w_out, b_out, ln_s, ln_b, g):
    """The eight gradients of ``sum(fused_edge_tail_agg_pregathered_bf16(
    ...) * g)`` in ``GRAD_NAMES_PREGATHERED`` order: the bf16 backward
    kernel on CUDA tensors (``d_pxi`` summed with atomics, so its last f32
    bits vary before the rounding to bf16), the plain version on CPU
    tensors."""
    operands = (h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    if h0.device.type == "cpu":
        _check_pregathered_bf16(*operands)
        return fused_edge_tail_agg_pregathered_bf16_bwd_plain(*operands, g)
    return _launch_pregathered_bf16_bwd(*operands, g.contiguous())


# ---- the bf16 lane at width 128: the fold, pe and pregathered entries -----

def _bf16_pe_chain(pe, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out,
                   b_out):
    """The pe entry's bf16 recompute, z = (f32(pe) + f32(pxj[j])) +
    f32(pxi[i]) as ``_fused2_fwd_pallas`` sums it (``pe + g0 + gath``),
    over the first rowptr[-1] rows: (receivers, [h_0 .. h_L1] bf16, y f32
    before LayerNorm)."""
    f = torch.Tensor.float
    receivers = _receivers(rowptr)
    live = receivers.numel()
    z = ((f(pe[:live]) + f(pxj).index_select(0, senders[:live]))
         + f(pxi).index_select(0, receivers))
    return (receivers, *_bf16_tail(z, w_rest, b_rest, w_out, b_out))


def fused_edge_tail_agg_pe_bf16_plain(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                      snd_perm, w_rest, b_rest, w_out, b_out,
                                      ln_s, ln_b):
    """Plain PyTorch version of the pe entry's bf16 build: the kernel's
    operands (module docstring; the sender CSR is read only by the kernel
    path's backward) and its (N, C) f32 result."""
    receivers, _, y = _bf16_pe_chain(pe, pxj, pxi, senders, rowptr, w_rest,
                                     b_rest, w_out, b_out)
    return _bf16_out(receivers, y, rowptr.numel() - 1, ln_s, ln_b)


def fused_edge_tail_agg_pe_bf16_bwd_plain(pe, pxj, pxi, senders, rowptr,
                                          snd_ptr, snd_perm, w_rest, b_rest,
                                          w_out, b_out, ln_s, ln_b, g):
    """Plain backward of the pe entry's bf16 build: the gradients of
    ``sum(out * g)`` in ``GRAD_NAMES_PE`` order, each in its operand's
    dtype, at the rounding points of ``_fused2_bwd_pallas`` and its VJP:
    d_pe = bf16(dz), d_pxi the f32 sum of bf16(dz), d_pxj the f32 sum of
    the unrounded dz over the senders, each rounded once."""
    receivers, hs, y = _bf16_pe_chain(pe, pxj, pxi, senders, rowptr, w_rest,
                                      b_rest, w_out, b_out)
    dz, tail = _bf16_tail_bwd(receivers, hs, y, g, w_rest, w_out, ln_s)
    nodes = torch.zeros(2, rowptr.numel() - 1, pe.shape[1],
                        dtype=torch.float32, device=dz.device)
    nodes[0].index_add_(0, senders[:dz.shape[0]].long(), dz)
    nodes[1].index_add_(0, receivers, _rnd(dz))
    operands = (pe, pxj, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b)
    return tuple(d.to(t.dtype) for d, t in zip(
        (_rows_of(dz, pe.shape[0]), *nodes, *tail), operands))


#: the counter of each entry's width-128 bf16 build
_W128_COUNTER = {"fold": "launches_fold128_bf16", "pe": "launches_pe_bf16",
                 "pregathered": "launches_pregathered128_bf16"}


def _launch_bf16_w128_fwd(entry, src, we, be, pxj, pxi, senders, rowptr,
                          *tail):
    """The width-128 bf16 forward of ``entry`` (``fold``: src is e0;
    ``pe``: pe, and ``we``, ``be`` are None; ``pregathered``: h0, and
    ``we``, ``be``, ``pxj``, ``senders`` are None), its operands checked by
    the caller; (N, 128) f32."""
    E, n, l1 = src.shape[0], rowptr.numel() - 1, tail[0].shape[0]
    dev = src.device
    out = torch.zeros(n, 128, dtype=torch.float32, device=dev)
    part = torch.empty(part_rows(E, FWD_TILE), 128, dtype=torch.float32,
                       device=dev)
    fn = cuda_build.function(BF16_W128, _ARGTYPES[BF16_W128_FWD],
                             symbol=BF16_W128_FWD)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), _ptr(we), _ptr(be), _ptr(pxj),
                 pxi.data_ptr(), _ptr(senders),
                 *(t.data_ptr() for t in (rowptr, *tail, out, part)),
                 n, E, l1, ENTRY[entry], stream)
    if err != 0:
        raise RuntimeError(f"{BF16_W128_FWD} launch failed: cudaError {err}")
    _bump(_W128_COUNTER[entry])
    return out


def _launch_bf16_w128_bwd(entry, src, we, be, pxj, pxi, senders, rowptr,
                          *tail_and_g):
    """The width-128 bf16 backward of ``entry``, operands as
    ``_launch_bf16_w128_fwd``'s, checked by the caller, and g (N, 128) f32.
    fold: the gradients in ``GRAD_NAMES`` order, each in its operand's
    dtype; pe: (d_pe, dz, d_pxi, d_w_rest, d_b_rest, d_w_out, d_b_out,
    d_ln_s, d_ln_b), dz the unrounded f32 (E, 128) from which the caller
    sums d_pxj; pregathered: the gradients in ``GRAD_NAMES_PREGATHERED``
    order, each in its operand's dtype."""
    *tail, g = tail_and_g
    fold, h = entry == "fold", 128
    E, n, l1 = src.shape[0], rowptr.numel() - 1, tail[0].shape[0]
    dev = src.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_w = int(fold) + l1 + 1  # the weights with a gradient, then their biases
    weights, biases = n_w * h * h, (n_w + 2) * h
    d_src = torch.empty_like(src)
    dz = (torch.empty(E, h, dtype=torch.float32, device=dev)
          if entry == "pe" else None)
    # the kernels add into these with atomics (one fill for both)
    d_nodes = torch.zeros(2 if fold else 1, n, h, dtype=torch.float32,
                          device=dev)
    wgrad = torch.empty(weights + biases, dtype=torch.float32, device=dev)
    # a row of partial sums of every packed gradient per cluster of n_w CTAs
    # (at most n_sm / n_w clusters); the kernel keeps h_k and da_k on chip,
    # so no scratch plane
    partial = torch.empty(max(1, n_sm // n_w), weights + biases,
                          dtype=torch.float32, device=dev)
    fn = cuda_build.function(BF16_W128, _ARGTYPES[BF16_W128_BWD],
                             symbol=BF16_W128_BWD)
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), _ptr(we), _ptr(be), _ptr(pxj),
                 pxi.data_ptr(), _ptr(senders),
                 *(t.data_ptr() for t in (rowptr, w_rest, b_rest, w_out,
                                          b_out, ln_s, g, d_src)),
                 _ptr(dz), d_nodes[0].data_ptr() if fold else None,
                 d_nodes[-1].data_ptr(), wgrad.data_ptr(), partial.data_ptr(),
                 None, n, E, l1, ENTRY[entry], n_sm, stream)
    if err != 0:
        raise RuntimeError(f"{BF16_W128_BWD} launch failed: cudaError {err}")
    _bump(_W128_COUNTER[entry] + "_bwd")
    bf = torch.bfloat16
    d_w = wgrad[:weights].view(n_w, h, h)
    d_b = wgrad[weights:].view(n_w + 2, h)
    k = int(fold)  # the first tail weight's place
    tail_grads = (d_w[k:k + l1].to(bf), d_b[k:k + l1].to(bf), d_w[-1].to(bf),
                  d_b[n_w - 1].to(bf), d_b[n_w], d_b[n_w + 1])
    if fold:
        return (d_src, d_w[0].to(bf), d_b[0].to(bf), d_nodes[0].to(bf),
                d_nodes[1].to(bf), *tail_grads)
    if entry == "pregathered":
        return (d_src, d_nodes[0].to(bf), *tail_grads)
    return (d_src, dz, d_nodes[0].to(bf), *tail_grads)


def _launch_pe64_bf16_fwd(pe, pxj, pxi, senders, rowptr, *tail):
    """The width-64 bf16 pe forward, its operands checked by the caller;
    (N, C) f32."""
    (E, h), n, l1 = pe.shape, rowptr.numel() - 1, tail[0].shape[0]
    c = tail[2].shape[1]
    dev = pe.device
    out = torch.zeros(n, c, dtype=torch.float32, device=dev)
    part = torch.empty(part_rows(E, FWD_TILE), c, dtype=torch.float32,
                       device=dev)
    fn = cuda_build.function(BF16, _ARGTYPES[BF16_PE_FWD], symbol=BF16_PE_FWD)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (pe, pxj, pxi, senders, rowptr,
                                          *tail, out, part)),
                 n, E, h, c, l1, stream)
    if err != 0:
        raise RuntimeError(f"{BF16_PE_FWD} launch failed: cudaError {err}")
    _bump("launches_pe64_bf16")
    return out


def _launch_pe64_bf16_bwd(pe, pxj, pxi, senders, rowptr, *tail_and_g):
    """The width-64 bf16 pe backward, its operands checked by the caller,
    and g (N, C) f32: (d_pe, dz, d_pxi, d_w_rest, d_b_rest, d_w_out,
    d_b_out, d_ln_s, d_ln_b), dz the unrounded f32 (E, H) from which the
    caller sums d_pxj, the rest each in its operand's dtype."""
    *tail, g = tail_and_g
    (E, h), n, l1 = pe.shape, rowptr.numel() - 1, tail[0].shape[0]
    c = tail[2].shape[1]
    dev = pe.device
    sizes = [l1 * h * h, l1 * h, h * c, c, c, c]
    _check_aligned(g=g, w_rest=tail[0], w_out=tail[2])  # cp.async
    n_blocks = _bf16_bwd64_blocks(dev, E)
    d_pe = torch.empty_like(pe)
    dz = torch.empty(E, h, dtype=torch.float32, device=dev)
    d_pxi = torch.zeros(n, h, dtype=torch.float32, device=dev)  # atomics
    wgrad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, sum(sizes), dtype=torch.float32,
                          device=dev)
    fn = cuda_build.function(BF16, _ARGTYPES[BF16_PE_BWD], symbol=BF16_PE_BWD)
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (
            pe, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out, ln_s,
            g, d_pe, dz, d_pxi, wgrad, partial)), n, E, h, c, l1, n_blocks,
            stream)
    if err != 0:
        raise RuntimeError(f"{BF16_PE_BWD} launch failed: cudaError {err}")
    _bump("launches_pe64_bf16_bwd")
    d_wr, d_br, d_wo, d_bo, d_ls, d_lb = wgrad.split(sizes)
    bf = torch.bfloat16
    return (d_pe, dz, d_pxi.to(bf), d_wr.view(l1, h, h).to(bf),
            d_br.view(l1, h).to(bf), d_wo.view(h, c).to(bf), d_bo.to(bf),
            d_ls, d_lb)


def _launch_pe_bf16_fwd(pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm,
                        *tail):
    """The pe entry's bf16 forward kernel (width 64, or width 128's);
    (N, C) f32."""
    _, widths, l1, _ = _check_pe(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                 snd_perm, *tail, dtype=torch.bfloat16)
    _check_build_bf16("pe", widths, l1)
    _check_device(pe)
    _check_aligned(pe=pe, pxj=pxj, pxi=pxi, w_rest=tail[0], w_out=tail[2])
    if widths[0] == 64:
        return _launch_pe64_bf16_fwd(pe, pxj, pxi, senders, rowptr, *tail)
    return _launch_bf16_w128_fwd("pe", pe, None, None, pxj, pxi, senders,
                                 rowptr, *tail)


def _launch_pe_bf16_bwd(pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm,
                        *tail_and_g):
    """The pe entry's bf16 backward on the card: kernel #7's bf16 build
    (width 64, or width 128's launch sequence), then d_pxj by the f32
    segment-sum kernel #1 over the sender CSR on the
    unrounded dz, rounded once; the gradients in ``GRAD_NAMES_PE`` order,
    each in its operand's dtype."""
    *tail, g = tail_and_g
    _, (h, c), l1, n = _check_pe(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                 snd_perm, *tail, dtype=torch.bfloat16)
    _check_build_bf16("pe", (h, c), l1)
    _check_device(pe)
    _check_aligned(pe=pe, pxj=pxj, pxi=pxi)
    _check_g(g, pe.device, n, c)
    if h == 64:
        d_pe, dz, d_pxi, *d_tail = _launch_pe64_bf16_bwd(
            pe, pxj, pxi, senders, rowptr, *tail, g)
    else:
        d_pe, dz, d_pxi, *d_tail = _launch_bf16_w128_bwd(
            "pe", pe, None, None, pxj, pxi, senders, rowptr, *tail, g)
    d_pxj = segment_sum(dz, snd_ptr, snd_perm).to(torch.bfloat16)
    return (d_pe, d_pxj, d_pxi, *d_tail)


class FusedEdgeTailAggPeBf16(torch.autograd.Function):
    """The pe entry's bf16 build as one differentiable function of (pe,
    pxj, pxi, w_rest, b_rest, w_out, b_out, ln_s, ln_b), its gradients in
    their operands' dtypes (the integer operands get none): kernels #6 and
    #7 with #1 for d_pxj, or (``plain``) the two plain versions."""

    @staticmethod
    def forward(ctx, plain, *operands):
        operands = tuple(t.detach() for t in operands)
        ctx.plain = plain
        ctx.save_for_backward(*operands)
        if plain:
            return fused_edge_tail_agg_pe_bf16_plain(*operands)
        return _launch_pe_bf16_fwd(*operands)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        bwd = (fused_edge_tail_agg_pe_bf16_bwd_plain if ctx.plain
               else _launch_pe_bf16_bwd)
        grads = bwd(*ctx.saved_tensors, g.contiguous())
        return (None, *grads[:3], None, None, None, None, *grads[3:])


def fused_edge_tail_agg_pe_bf16(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                snd_perm, w_rest, b_rest, w_out, b_out, ln_s,
                                ln_b, plain: bool = False):
    """``fused_edge_tail_agg_pe`` in the bf16 lane: the same operands, all
    bf16 but ln_s and ln_b (f32) and the integer ones; (N, C) f32,
    differentiable in every float operand with its gradient in that
    operand's dtype.  CUDA tensors launch the bf16 kernels (or raise: (H,
    C) = (64, 32) and (128, 128) are built); CPU tensors, or ``plain``, take
    the plain versions."""
    operands = (pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, w_rest,
                b_rest, w_out, b_out, ln_s, ln_b)
    _check_pe(*operands, dtype=torch.bfloat16)
    return FusedEdgeTailAggPeBf16.apply(plain or pe.device.type == "cpu",
                                        *operands)


def fused_edge_tail_agg_pe_bf16_bwd(pe, pxj, pxi, senders, rowptr, snd_ptr,
                                    snd_perm, w_rest, b_rest, w_out, b_out,
                                    ln_s, ln_b, g):
    """The nine gradients of ``sum(fused_edge_tail_agg_pe_bf16(...) * g)``
    in ``GRAD_NAMES_PE`` order: on CUDA tensors the bf16 #7 and the f32 #1
    (``d_pxi`` summed with atomics, so its last f32 bits vary before the
    rounding to bf16), the plain version on CPU tensors."""
    operands = (pe, pxj, pxi, senders, rowptr, snd_ptr, snd_perm, w_rest,
                b_rest, w_out, b_out, ln_s, ln_b)
    if pe.device.type == "cpu":
        _check_pe(*operands, dtype=torch.bfloat16)
        return fused_edge_tail_agg_pe_bf16_bwd_plain(*operands, g)
    return _launch_pe_bf16_bwd(*operands, g.contiguous())
