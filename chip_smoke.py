#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

  python3 chip_smoke.py                 every phase (the full check)
  python3 chip_smoke.py GROUP [GROUP]   only the named groups of phases:
                                        cnn, mpnn_kernels, mpnn_paths, cnn2d,
                                        gnn, gnn2d, fno, no_interaction,
                                        cnn_bf16, cnn2d_bf16, gnn_bf16,
                                        cnn_pe, gnn_pre, par (par_local and
                                        par_dist), par_dist (alone),
                                        par_spc (par_dist's steps_per_call
                                        runs alone), tune, remat, spc (with
                                        spc_graph), spc_graph (alone)

Builds the port's seven CUDA sources from the checkout (all eleven TPU
kernels: the fused GraphNet edge pipeline's forward and backward, each
with its fold, pre-gathered and pe entry at width 64 and 128, the fold,
pre-gathered and pe entries also in bf16 at width 64 and 128; the
fused MPNN message path's forward and backward, each with its
in-kernel-gather and its pre-gathered entry; the segment sum, in f32 and
bf16), holds each kernel against its plain PyTorch version at the
shapes of the paths that launch it, and drives every ported path at full width on data made from a
seed: MAgNet[CNN] 1D through ``magnet_tpu_torch.eval.evaluate`` and
``Trainer.fit`` (with a checkpoint read back and a resume), MPNN-2D
through the same two entry points, one MPNN-1D training step on the
pre-gathered kernels, MAgNet[CNN] 2D through ``evaluate`` (the fold lane)
and ``Trainer.fit`` (the pre-gathered lane, with a checkpoint read back and
a resume), MAgNet[GNN] 1D and 2D (the published 512-node irregular
configuration) through ``evaluate`` and ``Trainer.fit`` on the fold lane
at width 128 and on the pe lane, and FNO-1D, FNO-2D and the MAgNet[CNN]
no-interaction ablation (no kernel of their own) through the same two
entry points, each against the CPU path, and MAgNet[CNN] 1D's bf16 lane
(``graph_dtype=bf16``) through ``evaluate`` and ``Trainer.fit`` on the
fold entry's bf16 kernels, and MAgNet[CNN] 2D's through the same two
entry points, its eval on the fold entry's bf16 #8 and its training on
the pre-gathered entry's bf16 #2/#3 and the bf16 segment sum #1, and
MAgNet[CNN]'s pe lane (``impl="kernel_pe"``, the JAX package's lane
under ``MAGNET_TPU_NO_FUSED2R``) at (H, C) = (64, 32), in f32 and bf16:
1D through ``evaluate`` and ``Trainer.fit`` (checkpoint, resume) and 2D
through ``evaluate``, on #6/#7 with the f32 #1 for d_pxj, and
MAgNet[GNN]'s pre-gathered lane (``impl="kernel_pregathered"``, the JAX
package's lane under ``MAGNET_TPU_NO_FUSED2``) at (H, C) = (128, 128), in
f32 and bf16: 1D and 2D through ``evaluate`` and ``Trainer.fit``
(checkpoint, resume) on #2/#3 with #1 for the sender gather, and one
MAgNet[CNN] 2D ``kernel_pe`` step at its training graph, which the pe
lane rule sends to the pre-gathered (64, 32) builds, and data and graph
parallelism: MAgNet[CNN] 1D, MAgNet[GNN] 1D and MPNN-2D edge-partitioned
over a graph axis with every shard on the card (each step against the
whole graph's; all-gather, halo, and the halo exchange in flight behind
the interior edges' kernels; MAgNet[CNN] 1D in bf16 too), and
``Trainer.fit`` over NCCL ranks, one a card (the all-to-all, the overlap
split, its ring), resumed from rank 0's checkpoint, and a two-trial
sweep of ``magnet_tpu_torch.tune``, and ``remat`` (MAgNet[CNN] 2D at batch
32 and MAgNet[GNN] 1D in f32 and bf16, a training step with each processor
step recomputed in the backward against the step without: the same loss,
twice the forward kernels' launches, the backward's unchanged, peak memory
each way), and ``steps_per_call`` (MPNN 1D on #10 / #11 and FNO-1D fitted
with 4 steps a call at batch 32, the chunks as replays of a captured CUDA
graph, against one step a call: losses, weights, #10 / #11 launches in a
profiler trace of each fit, seconds a step and the device's idle share;
the optimizer, which decides on the device, against a plain Adam that
decides on the host), and ``steps_per_call`` over graphs that differ
(the fold, pe and pre-gathered kernels in f32 and bf16 at both widths,
and #1 in f32 and bf16, on MAgNet[CNN] 1D's and 2D's and MAgNet[GNN] 1D's
training graphs padded past their CSR, against the unpadded launch bit
for bit and against the plain version; MAgNet[CNN] 1D (f32, bf16,
``kernel_pe``), MAgNet[CNN] 2D (f32, bf16), MAgNet[GNN] 1D (f32, bf16,
``kernel_pregathered``) and MAgNet[GNN] 2D (f32, bf16) fitted with new
queries every batch, 4 steps a call replayed on padded graphs against one
step a call: losses, one step padded against unpadded, the lane's kernels
in the trace, seconds a step, idle share, the host's seconds building and
padding graphs), and on hosts of two cards or more ``Trainer.fit`` over
dp ranks with 4 steps a call, the chunks captured with the gradients'
NCCL all-reduce inside the graph (one rank's buckets grown mid-fit in a
second run), against one step a call and one process.  Each group's
seconds go to stderr.
It checks that each path went through its kernels by their launch counts.
Prints one JSON line per phase (``device``, ``build``, ``kernel``,
``slice``, ``kernel_bwd``, ``train``, ``mpnn_kernel``, ``mpnn_kernel_bwd``,
``mpnn_slice``, ``mpnn_train``, ``cnn2d_kernel``, ``cnn2d_kernel_bwd``,
``cnn2d_slice``, ``cnn2d_train``, ``gnn_kernel``, ``gnn_kernel_bwd``,
``gnn_slice``, ``gnn_train``, ``gnn2d_kernel``, ``gnn2d_slice``,
``gnn2d_train``, ``fno_1d``, ``fno_2d``, ``ni_slice``, ``ni_train``,
``bf16_kernel``, ``bf16_kernel_bwd``, ``bf16_slice``, ``bf16_train``,
``bf16_2d_kernel``, ``bf16_2d_kernel_bwd``, ``bf16_2d_slice``,
``bf16_2d_train``, ``gnn_bf16_kernel``, ``gnn_bf16_kernel_bwd``,
``gnn_bf16_slice``, ``gnn_bf16_train``, ``gnn2d_bf16_slice``,
``gnn2d_bf16_train``, ``pe64_kernel``, ``pe64_kernel_bwd``,
``pe64_slice``, ``pe64_train``, ``gnn_pre_kernel``,
``gnn_pre_kernel_bwd``, ``gnn_pre_slice``, ``gnn_pre_train``,
``gnn_pre_c6``, ``par_local``, ``par_dist``, ``remat``, ``spc``,
``spc_graph``), the
card's name and power limit, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero, and
with no CUDA device it exits 1 before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

F32_PEAK = 67e12    # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
# kernel vs plain at one call: f32 on both sides, the matmuls and the
# ~30-edge receiver sums of LayerNorm outputs (|y| ~ 1) taken in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# the whole rollout: 15 autoregressive windows of 10 steps carry those
# differences forward
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-4
# backward kernel vs plain, per gradient: |err| <= BWD_RTOL*|want| +
# BWD_ATOL_REL*max|want| (the gradients span three orders of magnitude
# between operands, so the absolute part scales with each one's largest
# entry).  relu is not smooth: the kernel recomputes the activations with
# its sums in another order, so a pre-activation within rounding of 0 can
# land on the other side of it and change that edge's gradient by O(1)
# (a handful of the training shape's 17M pre-activations do; one such edge
# moves a whole column of dW_e).  So at the training shape the elements
# outside the bound are counted and reported, and each gradient is held to
# a relative L2 error of BWD_L2; on the small graph, which has no such
# tie, every element is held to the bound.
BWD_RTOL, BWD_ATOL_REL, BWD_L2 = 1e-3, 1e-4, 1e-3
# a whole training step, kernel path vs plain path: parameter gradients
# are sums over 7 windows x 10 steps x ~67.7k edges, compared by relative
# L2 error per parameter; the loss is the same forward on both paths
TRAIN_GRAD_L2, TRAIN_LOSS_RTOL = 2e-3, 1e-5
# the smoke run's training data: KS trajectories with a shortened burn-in
# (the solver's default is 40.0), so that the host does not dominate the run
SMOKE_DATA = {"source": "synthetic_ks", "n_train": 96, "n_val": 32,
              "n_test": 1, "burn_in": 10.0, "data_seed": 0}


# the MPNN kernels vs plain at one call: f32 on both sides; a receiver sums
# up to 32 messages with |h2| of order 1 and the H = 128 products are taken
# in another order
MPNN_RTOL, MPNN_ATOL = 1e-4, 1e-4
# an MPNN-2D rollout: 4 autoregressive windows of 5 layers with an
# InstanceNorm after each carry those differences forward
MPNN_SLICE_RTOL, MPNN_SLICE_ATOL = 1e-3, 1e-4
# the smoke run's MPNN-2D data: Burgers-2D trajectories at the datamodule's
# shape (nt 50, 64 x 64, batch 4), fewer of them
MPNN_2D_DATA = {"source": "synthetic_burgers_2d", "n_train": 12, "n_val": 4,
                "n_test": 4, "data_seed": 0}
# the MPNN-1D step's data: the combined equation at the datamodule's shape
# (nt 250, nx 50), a smaller batch and half the solver's time steps, so
# that the host does not dominate the run
MPNN_1D_DATA = {"source": "synthetic_ce", "n_train": 8, "n_val": 1,
                "n_test": 1, "batch_size": 8, "n_steps": 2000, "data_seed": 0}
# MAgNet[CNN] 2D's training data: the MPNN-2D trajectories (Burgers-2D at
# the datamodule's nt 50, 64 x 64) and 12 more from seed 3, in batches of 8
# (the datamodule's 32, cut); validation and test are the MPNN-2D splits
CNN2D_EXTRA_TRAIN, CNN2D_BATCH = 12, 8
# the kernel phases' graph: the datamodule's full training batch
CNN2D_KERNEL_BATCH = 32
# segment sum vs plain: a few adds per row in another order
SEG_RTOL, SEG_ATOL_REL = 1e-5, 1e-6
# MAgNet[GNN] 1D: the eval batch of 16 Heat trajectories at the test
# split's shape (nt 256, nx 256), the smoke run's KS trajectories
# (SMOKE_DATA) through the GNN datamodule (nt 128, 32 queries, batch 32),
# and the width-128 kernels' small graph with one tail layer
GNN_EVAL_TRAJ, GNN_SMALL_L1 = 16, 1
# MAgNet[GNN] 2D is the published 512-node irregular script
# (scripts/magnet_gnn/magnet_gnn_2d_b1_512_irregular.sh): batch 32, 256
# queries, time_slice 10; FNO-2D is h5_datamodule_2d's batch 32 at 64 x 64.
# Each trains on 32 Burgers-2D solves at nt 50 and 64 x 64, and both
# evaluate on 32 more (the datamodules' trajectory counts, cut): MAgNet[GNN]
# 2D trains on its datamodule's seeded irregular source (512 uniform nodes
# drawn from each of its own solves) and evaluates on the eval solves'
# regular 32 x 32 grid (every second row and column, the solver's own
# 32 x 32 output), FNO-2D on its own solves and the eval solves at 64 x 64
GNN2D_HP = {"time_slice": 10}
GNN2D_DATA = {"res_train": 512, "samples": 256}
B2D_TRAJ = 32
# FNO-1D: 32 E3 trajectories at the datamodule's nt 250 and nx 50 with half
# the solver's time steps (as MPNN_1D_DATA), which it trains and evaluates on
CE_TRAJ, CE_STEPS = 32, 2000
# every solve runs in a pool of worker processes while the kernels build;
# the new groups' trajectories in chunks, each from a seed of its own
DATA_WORKERS, DATA_CHUNK = 6, 4
# an FNO's eval loss on the card against the CPU path: f32 on both sides,
# cuFFT against pocketfft and the 1x1 convolutions summed in another order,
# carried over 9 (1D) or 4 (2D) autoregressive windows
FNO_LOSS_RTOL = 1e-4
# depth cuts of earlier paths that keep the full run inside its time limit
# beside spc_graph's eight fits: FNO-2D (no kernel of the port; its CPU
# eval comparison dominates its phase) and the spc phase's MPNN 1D and
# FNO-1D fits run at these depths, their widths the published ones
FNO_2D_SMOKE_LAYERS = 2
SPC_DEPTH = {"mpnn": {"hidden_layer": 2}, "fno_1d": {"num_layers": 2}}
# MAgNet[CNN] no-interaction at its published width: eval on the cnn
# group's 16 Heat trajectories (one batch, 15 windows), and against the CPU
# path on a cut of that batch (NI_CPU_TRAJ trajectories, the first
# NI_CPU_NT times: 3 windows) with the same latents on both sides, its eval
# loss within NI_LOSS_RTOL (f32 on both sides, cuDNN's LSTM and
# convolutions against the CPU's, carried over 3 autoregressive windows of
# 16 + 16 recurrent steps); training on the cnn group's KS data
NI_CPU_TRAJ, NI_CPU_NT, NI_LOSS_RTOL = 2, 64, 1e-4
# MAgNet[CNN] 1D's bf16 lane (graph_dtype=bf16).  Its kernels against
# their bf16 plain versions on the card: the same rounding points with the
# f32 sums in another order, so an activation or an output can round to the
# neighbouring bf16 value (2^-8 relative) and move a receiver's sum by a
# few 1e-3: forward elementwise within BF16_RTOL |want| + BF16_ATOL and at
# relative L2 BF16_L2; backward each gradient at relative L2 BF16_BWD_L2
# (such a rounding can also flip a relu tie downstream), the elements
# outside BF16_RTOL |want| + BF16_BWD_ATOL_REL max|want| counted.  Against
# the f32 kernels on the unrounded operands, the JAX package's own
# bf16-to-f32 bounds (tests/test_ops.py:417-418, 430-437): forward rtol =
# atol = 5e-2, gradients at relative L2 0.08 per operand; the eval loss
# against the f32 lane's within 5e-2 relative (tests/test_models.py:204).
# The JAX test sums about two edges a receiver; here a receiver sums up to
# 64, and bf16 against f32 arithmetic puts the plain versions' sums 2.5-5x
# outside 5e-2 at these graphs, so the forward bound holds the receiver
# means (the sums over the degree, what the model reads), and the sums'
# largest difference is reported.  Likewise the gradients: the JAX test's
# depth is L1 = 1 (BF16_VS_F32_DEPTH); at L1 = 3 the relu ties that bf16
# against f32 arithmetic flips put the plain bf16 version's d_e0, dW_e and
# d_pxj 0.08-0.1 from the plain f32 version's at these graphs, so there a
# gradient past 0.08 is held to BF16_VS_F32_DEEP times the plain versions'
# distance
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
BF16_RTOL, BF16_ATOL, BF16_L2 = 1e-2, 2e-2, 1e-3
BF16_BWD_L2, BF16_BWD_ATOL_REL = 1e-2, 1e-3
BF16_VS_F32_RTOL = BF16_VS_F32_ATOL = 5e-2
BF16_VS_F32_GRAD_L2, BF16_VS_F32_DEPTH, BF16_VS_F32_DEEP = 0.08, 1, 1.25
BF16_LOSS_RTOL = 5e-2
# MAgNet[CNN] 2D's bf16 lane: the pregathered entry's bf16 build (#2/#3)
# against its bf16 plain versions at the BF16_* bounds above; the bf16
# segment sum (#1) elementwise within BF16_SEG_RTOL |want| + SEG_ATOL_REL
# max|want| (each sum rounded once to bf16 from f32 sums taken in another
# order: at most the neighbouring bf16 value, 2^-8 relative)
BF16_SEG_RTOL = 1e-2
# MAgNet[GNN]'s pre-gathered lane (gnn_pre): 1D trains on 32 of the KS
# trajectories (one batch of the GNN datamodule's 32, one step an epoch)
# and validates on 32
GNN_PRE_TRAJ = 32
# data and graph parallelism (par): MPNN-2D's partitioned step at this
# depth (the model's 5 layers, cut); par_dist's launch of its ranks, each
# a fresh process on its card, within this many seconds
PAR_MPNN_LAYERS, PAR_DIST_TIMEOUT = 2, 300
# par_dist's fit over ranks against one process's on the same global
# batches (PAR_FIT_EPOCHS epochs of 3 Adam steps; a step timed in the last,
# warm one): each epoch's train and val losses within PAR_FIT_RTOL, and
# the whole model's update within
# PAR_UPDATE_L2 relative L2 of the one process's.  Not per parameter:
# the backward kernels add with atomics, so two fits differ in a
# gradient's last bits even on one card, and Adam's lr g / (|g| + eps)
# moves a weight whose gradient is near eps by up to lr for such a change
# (one bias's update differed by 0.13 of itself on an H100)
PAR_FIT_EPOCHS, PAR_FIT_RTOL, PAR_UPDATE_L2 = 2, 1e-3, 1e-2
# par_dist's steps_per_call runs (group par_spc alone): the same fit on the
# spc_graph phase's SPC_GRAPH_TRAJ KS trajectories (4 steps an epoch, new
# queries every batch) in one process, over dp = every card at one step a
# call and at SPC_K, the chunks captured with the gradients' all-reduce in
# the graph, and at SPC_K with one rank's edge buckets grown by one
# EDGE_BUCKET before its second chunk (it captures anew while the others
# replay), each held as the fits above, and the SPC_K fit's losses within
# PAR_FIT_RTOL of the dp fit's at one step a call
# par_local's graph with a shard whose boundary region has no edge: B
# samples of PAR_EMPTY_NODES 1D nodes, the first third apart from the rest,
# over G = 3; the overlap processor against the halo one on the card, the
# output and every gradient within TRAIN_GRAD_L2 relative L2 (the same
# kernels, the sums of a receiver split over two launches)
PAR_EMPTY_BATCH, PAR_EMPTY_NODES = 2, 3072
# the tune group: a sweep of TUNE_TRIALS trials of MAgNet[CNN] 1D at its
# published widths, one epoch each, on the seeded KS source cut to these
# sizes (one training batch of 32 an epoch)
TUNE_TRIALS = 2
TUNE_DATA = {"n_train": 32, "n_val": 8, "n_test": 1, "burn_in": 10.0}
# the remat group: a step with each processor step recomputed in the
# backward against the step without, the same forward kernels on the same
# operands (bit for bit: the loss), the backward kernels' atomics in
# another order (every gradient within REMAT_GRAD_L2 relative L2);
# MAgNet[CNN] 2D at the datamodule's batch
REMAT_GRAD_L2, REMAT_CNN2D_BATCH = 1e-6, 32
# the spc group: MPNN 1D and FNO-1D fits of SPC_EPOCHS epochs at the
# datamodules' batch 32 over SPC_TRAJ E3 trajectories (the fno group's 32
# and more from the same solver; 4 steps an epoch), validated on the fno
# group's 32, SPC_K steps a call against one; MPNN 1D's per-step losses
# within SPC_MPNN_LOSS_RTOL and its weights within SPC_MPNN_WEIGHT_L2
# relative L2 of the one-step fit (#11 adds with atomics), FNO-1D's bit
# for bit.  The optimizer, which decides on the device, against a plain
# Adam that decides on the host (a float rate, the finite check read
# back), with non-finite gradients: on the same gradients, SPC_UPDATES
# updates of FNO-1D's parameters, the weights' change from their start
# within SPC_PLAIN_UPDATE_RTOL relative L2 of the plain one's (the
# capturable Adam computes its bias corrections in f32 on the device:
# 1 - f32(0.999) is 0.001 within 1.3e-5, so the first update is the plain
# one within 6.4e-6, the later ones closer); and FNO-1D's fit with a
# planted NaN, the same updates dropped, the losses up to the first
# applied update bit-equal, then per-step losses within
# SPC_PLAIN_FIT_LOSS_RTOL and weights within SPC_PLAIN_FIT_WEIGHT_L2: a
# fit feeds each update's rounding back into the next gradients, and
# Adam moves a weight whose gradient is rounding noise by about the rate
# either way
SPC_MODELS, SPC_K, SPC_TRAJ, SPC_EPOCHS = ("mpnn", "fno_1d"), 4, 128, 2
SPC_MPNN_LOSS_RTOL, SPC_MPNN_WEIGHT_L2 = 1e-5, 1e-5
SPC_UPDATES, SPC_PLAIN_UPDATE_RTOL = 8, 2e-5
SPC_PLAIN_FIT_LOSS_RTOL, SPC_PLAIN_FIT_WEIGHT_L2 = 1e-3, 1e-3
# the spc_graph phase (in the spc group): MAgNet[CNN] 1D and MAgNet[GNN] 1D
# fits of SPC_EPOCHS epochs at the datamodules' batch 32 over SPC_GRAPH_TRAJ
# KS trajectories (the cnn group's 96 and 32 more from their source; 4
# steps an epoch, new queries every batch, so a new graph every step), one
# step a call twice and SPC_K, the SPC_K chunks as replays on graphs padded
# to the trainer's edge buckets; per-step losses of the SPC_K fit and of
# the second one-step fit within SPC_GRAPH_LOSS_RTOL of the first one-step
# fit.  The node gradients add with atomics (#9's d_pxj / d_pxi, autograd's
# index_add_ and the k-NN gather's), so two fits part in their last bits
# after the first update, and Adam magnifies a change where |g| is near
# eps (PAR_FIT_RTOL's reason): MAgNet[CNN] 1D's repeated one-step fit
# stayed within 3.0e-6 of the first over 8 steps, MAgNet[GNN] 1D's within
# 6.0e-5 to 2.1e-4 (four runs, H100 80GB HBM3, 700 W), so the GNN is held
# at PAR_FIT_RTOL and the CNN at 1e-5 (the edge MLPs also run cuBLAS over
# the padded rows, in another blocking).  The f32 fold
# kernels #8/#9 at both widths on those training graphs with a dead tail
# (NaN in e0's dead rows): forward, weight gradients and d_e0's live rows
# bit-equal to the unpadded launch, its dead rows zero, d_pxj and d_pxi
# (atomics) within SPC_GRAPH_ATOMICS_L2 relative L2 of it, and the padded
# launch against the plain version at the kernel phases' bounds
SPC_GRAPH_TRAJ, SPC_GRAPH_ATOMICS_L2 = 128, 1e-6
SPC_GRAPH_LOSS_RTOL = {"magnet_cnn": 1e-5, "magnet_gnn": PAR_FIT_RTOL}
# The same checks on every lane a captured chunk now pads: the f32 pe and
# pre-gathered entries at both widths, the bf16 fold, pe and pre-gathered
# entries at widths 64 and 128 and the segment sum #1 (f32 and bf16) over a
# padded sender CSR, bit for bit where no atomics add.  The bf16 node gradients
# are f32 atomic sums rounded once to bf16: a last-bit change of a sum
# that lies at a rounding boundary moves that element by one bf16 step
# (2^-8 relative), so they are held at SPC_GRAPH_ATOMICS_BF16_L2 (a few in
# 10^5 elements so moved give ~2e-5), the unpadded launch's repeat beside
# it.  The fits: MAgNet[CNN] 2D (pre-gathered lane) and 1D on kernel_pe
# at 1e-5 as MAgNet[CNN] 1D; MAgNet[GNN] 1D on kernel_pregathered and
# the bf16 MAgNet[CNN] fits (1D, 2D) at PAR_FIT_RTOL, as their repeated
# one-step fit is (the backward kernels' atomics; bf16 roundings that
# such a change flips); MAgNet[GNN] 2D and the bf16 MAgNet[GNN] fits
# below.  MAgNet[CNN] 2D and MAgNet[GNN] 2D fit SPC_GRAPH_TRAJ
# trajectories made by repeating the cnn2d and gnn2d groups' solves
# (queries drawn anew for every sample), so that no new solve is made
SPC_GRAPH_ATOMICS_BF16_L2 = 1e-4
# Every fit's first step on the padded graph against the unpadded one: the
# loss bit-equal and every gradient within SPC_GRAPH_FIRST_STEP_L2 relative
# L2 of the graph's dtype.  The edge encoder's MLP runs cuBLAS over the
# padded rows, which sums its weight gradient in another order: 1.3e-7 to
# 2.7e-7 in f32; in bf16 some of its elements round to the neighbouring
# bf16 number, 1.4e-5 (MAgNet[GNN] 1D) to 1.1e-3 (MAgNet[GNN] 2D), and one
# such step on every element would be 2^-8 to 2^-7 (H100 80GB HBM3, 700 W)
SPC_GRAPH_FIRST_STEP_L2 = {"float32": 1e-6, "bf16": 2.0 ** -8}
# MAgNet[GNN] 2D's repeated one-step fit lay 2.4e-4 to 8.9e-4 from the
# first in six runs and 1.1e-3 and 1.45e-3 in two more (the k-NN gather's
# and the backward kernels' atomics through Adam), its SPC_K fit 1.1e-4 to
# 9.2e-4 (H100 80GB HBM3, 700 W): both are held at SPC_GRAPH_GNN2D_RTOL
SPC_GRAPH_GNN2D_RTOL = 3e-3
# The bf16 MAgNet[GNN] 1D (its one-step fit twice) and 2D fold fits: the
# width-128 bf16 kernels are bit-equal padded and unpadded, but the edge
# encoder's bf16 weight gradient differs in its roundings (above), and
# Adam turns those into per-step losses 3.73e-3 (1D) and 5.74e-3 (2D) from
# the one-step fit's after 8 steps, the same in three runs (H100 80GB HBM3,
# 700 W), beyond PAR_FIT_RTOL.  So the SPC_K fit is held against the same
# fit with its chunks run eagerly on the same padded graphs (``EagerStep``:
# what the capture replays, without it) within PAR_FIT_RTOL, the repeat
# within PAR_FIT_RTOL, and the SPC_K fit against the one-step fit on
# unpadded graphs within SPC_GRAPH_BF16_GNN_RTOL, a bound that the bf16
# one-step fit's distance from the f32 one's (the same weights and data)
# must exceed, so that it tells the two precisions apart
SPC_GRAPH_BF16_GNN_RTOL = 1e-2
GROUPS = ("cnn", "mpnn_kernels", "mpnn_paths", "cnn2d", "gnn", "gnn2d",
          "fno", "no_interaction", "cnn_bf16", "cnn2d_bf16", "gnn_bf16",
          "cnn_pe", "gnn_pre", "par", "par_dist", "par_spc", "tune", "remat",
          "spc", "spc_graph")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(got, want, rtol, atol) -> dict:
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    return {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-30)).max()),
        "max_err_over_bound": float((err / bound).max()),
        "rtol": rtol, "atol": atol,
        "ok": bool((err <= bound).all()),
    }


def compare_grad(got, want, elementwise: bool, rtol=BWD_RTOL,
                 atol_rel=BWD_ATOL_REL, max_l2=BWD_L2) -> dict:
    """A gradient against its reference: relative L2 within ``max_l2``,
    the elements outside ``rtol`` |want| + ``atol_rel`` max|want| counted
    (and, ``elementwise``, none allowed)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    top = float(want.abs().max())
    outside = err > rtol * want.abs() + atol_rel * top
    n_outside = int(outside.sum())
    l2 = float(err.norm() / want.norm().clamp_min(1e-30))
    return {"max_abs_err": float(err.max()), "max_abs_want": top,
            "max_rel_err": float((err / want.abs().clamp_min(1e-30)).max()),
            "rel_l2_err": l2, "n_outside": n_outside, "n": want.numel(),
            "ok": l2 <= max_l2 and not (elementwise and n_outside)}


def small_line_graph():
    """200 nodes on a line within radius 0.4 of each other, at most 64
    senders a receiver and no self loops, node 17 moved away: a receiver of
    degree 0 and receivers of up to 64 edges."""
    from magnet_tpu_torch.ops.graph import csr_from_edges, radius_graph

    pos = np.linspace(-1, 1, 200, dtype=np.float32)[:, None]
    pos[17, 0] = 9.0
    s, r = radius_graph(torch.from_numpy(pos), 0.4, loop=False,
                        max_num_neighbors=64)
    return csr_from_edges(s, r, 200)


def kernel_operands(graph, ce, h, c, l1, seed, dev):
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    n, e = graph.n_node, graph.n_edge
    return (f(e, ce), f(ce, h), f(h), f(n, h), f(n, h),
            graph.senders.to(dev), graph.rowptr.to(dev), f(l1, h, h),
            f(l1, h), f(h, c), f(c), 1 + f(c, scale=0.1), f(c, scale=0.1))


def bound(kernel: str, graph, ce, h, c, l1) -> dict:
    """Least time on the card for one call of the forward (``"fwd"``) or
    backward (``"bwd"``) kernel: its operations over the f32 peak, and each
    input read once plus each output written once over the HBM rate.  The
    forward is 2·(multiply-adds of the four matrix products); the backward
    recomputes them and forms the data and the weight gradients, three
    times that."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * (ce * h + l1 * h * h + h * c)
    weights = ce * h + h + l1 * (h * h + h) + h * c + 3 * c
    inputs = e * ce + e + (n + 1) + 2 * n * h + weights
    if kernel == "fwd":
        nbytes = 4.0 * (inputs + n * c)
    elif kernel == "bwd":
        flops *= 3.0
        nbytes = 4.0 * (inputs + n * c + e * ce + 2 * n * h + weights)
    else:
        raise ValueError(kernel)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def tc_bound(b: dict) -> dict:
    """The bound of a kernel whose f32 products run on the tensor cores in
    error-compensated TF32 (csrc/tile_mm.cuh, tf32x3): three TF32 products
    per f32 product at the TF32 peak, against the same bytes as ``b``'s f32
    bound."""
    t_ops, t_bytes = 3.0 * b["flops"] / TF32_PEAK * 1e3, b["bytes"] / HBM_RATE * 1e3
    return {"tc_bound_ms": max(t_ops, t_bytes),
            "tc_bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ptxas_lines(lib) -> list[str]:
    """ptxas's report of each kernel of a library: its name, registers,
    spills."""
    report = lib.parent / f"{lib.stem}.ptxas.txt"
    return [ln.strip() for ln in report.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def bwd_w64_build() -> list[dict]:
    """Each width-64 backward instantiation (entry, L1): ptxas's lines
    (registers, spills) and the dynamic shared memory a block takes."""
    import ctypes
    import re

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    lib = cuda_build.build(fe.BWD)
    smem = ctypes.CDLL(str(lib)).fused_edge_tail_agg_bwd_w64_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    found, lines = [], []
    names = {v: k for k, v in fe.ENTRY.items()}
    for ln in ptxas_lines(lib) + ["entry function (end)"]:
        if "entry function" in ln:
            m = re.search(r"edge_tail_bwd_kernelILi(\d)ELN7tile1285EntryE(\d)E",
                          lines[0] if lines else "")
            if m:
                entry = names[int(m.group(2))]
                found.append({"entry": entry, "l1": int(m.group(1)),
                              "smem_bytes": smem(fe.ENTRY[entry],
                                                 int(m.group(1))),
                              "ptxas": lines[1:]})
            lines = []
        lines.append(ln)
    return sorted(found, key=lambda f: (f["entry"], f["l1"]))


def bits_equal_bwd(fn, ops, g, names) -> dict:
    """Two launches of a backward give the same bits in every gradient but
    the node tables the kernels sum with atomics (d_pxj, d_pxi)."""
    a, b = fn(*ops, g), fn(*ops, g)
    checked = [n for n in names if n not in ("pxj", "pxi")]
    return {"checked": checked,
            "ok": all(torch.equal(x, y) for n, x, y in zip(names, a, b)
                      if n in checked)}


def check_bwd_w64(entry, cases, g_gen, c) -> tuple[dict, tuple]:
    """The width-64 backward of ``entry`` (fold, pregathered, or pe with
    the segment sum #1 for d_pxj) vs plain,
    every gradient, on each (label, graph, operands) of ``cases``: by
    relative L2 at ``train_shape``, where it is also bit-equal from launch
    to launch but the atomic node sums, and elementwise elsewhere with the
    degree-0 d_pxi rows zero.  g (N, c) is drawn from ``g_gen``; at
    ``train_shape`` it is zero on the receivers of relu ties
    (tie_receivers, counted): the tensor cores' recompute lands more
    near-zero pre-activations on the other side of 0 than an f32 one, enough
    to put that shape's relative L2 over BWD_L2 without the guard.  Returns
    the results and the training shape's (g, gradients)."""
    from magnet_tpu_torch.ops import fused_edge as fe

    fn, plain, names = {
        "fold": (fe.fused_edge_tail_agg_bwd, fe.fused_edge_tail_agg_bwd_plain,
                 fe.GRAD_NAMES),
        "pregathered": (fe.fused_edge_tail_agg_pregathered_bwd,
                        fe.fused_edge_tail_agg_pregathered_bwd_plain,
                        fe.GRAD_NAMES_PREGATHERED),
        "pe": (fe.fused_edge_tail_agg_pe_bwd,
               fe.fused_edge_tail_agg_pe_bwd_plain, fe.GRAD_NAMES_PE)}[entry]
    # w_rest's place among the operands (after the integer ones)
    w_rest_at = {"fold": 7, "pregathered": 3, "pe": 7}[entry]
    out, train = {}, None
    for label, gr, ops in cases:
        dev = ops[0].device
        g = torch.randn(gr.n_node, c, generator=g_gen).to(dev)
        train_shape = label == "train_shape"
        if train_shape:
            ties = tie_receivers(entry, ops, ops[w_rest_at].shape[0])
            g[ties] = 0.0
        got = fn(*ops, g)
        torch.cuda.synchronize()
        want = plain(*ops, g)
        out[label] = {name: compare_grad(a, b, elementwise=not train_shape)
                      for name, a, b in zip(names, got, want)}
        if train_shape:
            out[label]["tie_receivers_zeroed"] = int(ties.numel())
            out[label]["bits_equal_run_to_run"] = bits_equal_bwd(fn, ops, g,
                                                                 names)
            train = (g, got)
        else:
            zero = gr.degree.to(dev) == 0
            out[label]["degree0_rows_zero"] = {
                "ok": bool((got[names.index("pxi")][zero] == 0).all()),
                "n_degree0": int(zero.sum())}
    return out, train


def bwd_tile_edges(sms: int, seed: int):
    """``tile_edges_graph`` at the width-64 backward's tile, with more than
    2 ``sms`` tiles: the grid of at most one block an SM gives every block
    3 consecutive tiles (the last block fewer), its receiver hint carried
    from tile to tile.  Returns the graph and its tiling."""
    from magnet_tpu_torch.ops import fused_edge as fe

    graph = tile_edges_graph(fe.BWD_TILE, seed,
                             n_edge_min=2 * sms * fe.BWD_TILE + 1)
    n_tiles = -(-graph.n_edge // fe.BWD_TILE)
    per_block = -(-n_tiles // sms)
    return graph, {"n_edge": graph.n_edge, "tile": fe.BWD_TILE,
                   "n_tiles": n_tiles, "tiles_per_block": per_block,
                   "blocks": -(-n_tiles // per_block),
                   "max_degree": int(graph.degree.max())}


def timed(fn) -> float:
    """Host seconds of ``fn()`` with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fit_checkpoint_resume(make_model, hp, loaders, dev, n_epochs, reset,
                          counts, prepare=None) -> tuple[dict, object]:
    """``Trainer.fit`` of ``make_model()`` for ``n_epochs`` on ``loaders``
    with ``hp``'s optimiser settings, its last checkpoint read back, and a
    second new model resumed from it for one epoch more.  ``prepare``, where
    given, instruments the first trainer before its fit; ``counts()``, read
    after ``reset()`` and the first fit, gives its kernel launches.  Returns
    that fit's record (launches, seconds, peak memory; the metrics rows of
    both fits and their training losses; whether the checkpoint holds the
    fitted model at its last step and epoch, and whether the resume went on
    from there) and the resumed trainer, for timing steps."""
    from magnet_tpu_torch.train.checkpoint import load_checkpoint
    from magnet_tpu_torch.train.trainer import Trainer

    steps = len(loaders["train"])
    with tempfile.TemporaryDirectory() as workdir:
        def trainer_for(max_epochs):
            return Trainer(make_model(), max_epochs=max_epochs, lr=hp["lr"],
                           weight_decay=hp["weight_decay"],
                           factor=hp["factor"], step_size=hp["step_size"],
                           workdir=workdir, device=dev)

        trainer = trainer_for(n_epochs)
        if prepare is not None:
            prepare(trainer)
        reset()
        torch.cuda.reset_peak_memory_stats()
        fit_s = timed(lambda: trainer.fit(loaders["train"], loaders["val"]))
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        last = os.path.join(workdir, "checkpoints", "last.pt")
        state, meta = load_checkpoint(last, require=("model", "optimizer"))
        ckpt_ok = (state["step"] == steps * n_epochs
                   and meta.get("epoch") == n_epochs - 1
                   and all(torch.equal(v.cpu(), state["model"][k])
                           for k, v in trainer.model.state_dict().items()))
        resumed = trainer_for(n_epochs + 1)
        resumed.fit(loaders["train"], loaders["val"], resume=last)
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    epochs = [r["epoch"] for r in rows]
    return {"launches": launches, "steps_per_epoch": steps,
            "epochs": n_epochs, "rows": rows,
            "epoch_train_losses": [r["train_loss"] for r in rows],
            "losses_finite": all(np.isfinite(v) for r in rows
                                 for v in r.values()),
            "checkpoint_ok": ckpt_ok,
            "resume_ok": (epochs == list(range(n_epochs + 1))
                          and resumed.optimizer.step_count
                          == steps * (n_epochs + 1)),
            "resumed_epochs": epochs, "seconds_fit": fit_s,
            "peak_mem_bytes": peak}, resumed


def cnn_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``kernel``, ``slice``, ``kernel_bwd`` and ``train``: the fused
    GraphNet edge kernels and the two MAgNet[CNN] 1D paths.  Returns the
    exit code (0: all passed), the two kernels' entries and no launches of
    another group's kernel."""
    from magnet_tpu_torch.config import (
        DATAMODULE_IMPLICIT,
        HEAT_TEST,
        MAGNET_CNN,
    )
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.utils import to_device

    # 3. kernel vs plain at the slice's shapes: B=16 LR∪HR graphs flattened
    hp = dict(MAGNET_CNN)
    batches = data["heat"]
    model = create_model("magnet_cnn", hp, device=dev, seed=0)
    graph = model.build_graph(
        {k: torch.as_tensor(v) for k, v in batches[0].items()})
    ce, h, c = hp["latent_dim"], hp["mlp_hidden"], hp["latent_dim"]
    l1 = hp["mlp_layers"] - 1
    ops = kernel_operands(graph, ce, h, c, l1, seed=1, dev=dev)
    got = fe.fused_edge_tail_agg(*ops)
    torch.cuda.synchronize()
    want = fe.fused_edge_tail_agg_plain(*ops)
    big = compare(got, want, KERNEL_RTOL, KERNEL_ATOL)
    # a small graph with a node of degree 0 (isolated, no self loop) and
    # receivers of up to 64 edges (two 32-edge rounds of a warp), with one
    # tail layer: the L1=3 launches timed after it check that a launch
    # for another L1 leaves the kernel's shared-memory opt-in large enough
    small_graph = small_line_graph()
    ops_s = kernel_operands(small_graph, ce, h, c, 1, seed=2, dev=dev)
    got_s = fe.fused_edge_tail_agg(*ops_s)
    want_s = fe.fused_edge_tail_agg_plain(*ops_s)
    small = compare(got_s, want_s, KERNEL_RTOL, KERNEL_ATOL)
    small["degree0_row_zero"] = bool((got_s[17] == 0).all())
    small["max_degree"] = int(small_graph.degree.max())
    small["l1"] = 1
    # a graph that crosses the forward's tiles in every way
    tiles = tile_edges_graph(fe.FWD_TILE, seed=26)
    ops_t = kernel_operands(tiles, ce, h, c, l1, seed=27, dev=dev)
    got_t = fe.fused_edge_tail_agg(*ops_t)
    tile_case = compare(got_t, fe.fused_edge_tail_agg_plain(*ops_t),
                        KERNEL_RTOL, KERNEL_ATOL)
    zero = tiles.degree.to(dev) == 0
    tile_case.update(n_edge=tiles.n_edge, tile=fe.FWD_TILE,
                     max_degree=int(tiles.degree.max()),
                     n_degree0=int(zero.sum()),
                     degree0_rows_zero=bool((got_t[zero] == 0).all()))
    # no atomics: two launches give the same bits
    bits_equal = torch.equal(fe.fused_edge_tail_agg(*ops),
                             fe.fused_edge_tail_agg(*ops))
    ms = cuda_ms(lambda: fe.fused_edge_tail_agg(*ops), reps=50)
    plain_ms = cuda_ms(lambda: fe.fused_edge_tail_agg_plain(*ops), reps=20)
    bnd = bound("fwd", graph, ce, h, c, l1)
    bnd.update(tc_bound(bnd))
    kernel_ok = (big["ok"] and small["ok"] and small["degree0_row_zero"]
                 and tile_case["ok"] and tile_case["degree0_rows_zero"]
                 and bits_equal)
    emit({"phase": "kernel", "n_node": graph.n_node, "n_edge": graph.n_edge,
          "ce": ce, "h": h, "c": c, "l1": l1, "slice_shape": big,
          "small_case": small, "tile_edges": tile_case,
          "bits_equal_run_to_run": bits_equal, "ms": ms,
          "plain_ms": plain_ms, "library_ms": None, **bnd,
          "share_of_tc_bound": bnd["tc_bound_ms"] / ms,
          "ptxas": ptxas_lines(cuda_build.build("fused_edge_tail_agg")),
          "ok": kernel_ok})
    if not kernel_ok:
        return 2, [], {}

    # 4. the slice: evaluate() at full width on 16 Heat trajectories
    fe.launches = 0
    t0 = time.perf_counter()
    metrics, preds = evaluate(model, batches, dev, return_predictions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fe.launches
    want_launches = 150 * len(batches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    evaluate(model, batches, dev)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model.impl = "plain"
    t0 = time.perf_counter()
    metrics_plain, preds_plain = evaluate(model, batches, dev,
                                          return_predictions=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    model.impl = "kernel"
    cmp = compare(torch.cat(preds), torch.cat(preds_plain), SLICE_RTOL,
                  SLICE_ATOL)
    finite = all(bool(torch.isfinite(p).all()) for p in preds) and all(
        np.isfinite(v) for v in metrics.values())
    shape_ok = all(tuple(p.shape) == (b["hr_points"].shape[0], 240, 256, 1)
                   for p, b in zip(preds, batches))
    slice_ok = (launches == want_launches and finite and shape_ok
                and cmp["ok"])
    emit({"phase": "slice", "batches": len(batches), "batch_size": 16,
          "nt": HEAT_TEST["nt"], "nx": HEAT_TEST["nx"], "L": 128, "N": 256,
          "kernel_launches": launches, "expected_launches": want_launches,
          "finite": finite, "shape_ok": shape_ok, **metrics,
          "plain_metrics": metrics_plain, "vs_plain": cmp,
          "seconds_per_batch_first": first_s / len(batches),
          "seconds_per_batch": steady_s / len(batches),
          "seconds_per_batch_plain": plain_s / len(batches),
          "peak_mem_bytes": peak, "ok": slice_ok})

    if not slice_ok:
        return 3, [], {}
    del preds, preds_plain

    # 5. the backward kernel vs plain, every gradient, at the training
    # shape (B=32 graphs of 128 LR + 32 HR nodes, flattened), on the small
    # graph above (degree-0 node, 64-edge receivers, L1=1) and on a graph
    # that crosses the backward's tiles in every way (check_bwd_w64)
    data_cfg = {**DATAMODULE_IMPLICIT, **SMOKE_DATA}
    loaders, t_data = data["ks_loaders"], data["ks_seconds"]
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    tgraph = model.build_graph(batch0)
    bwd_tiles, tiles_info = bwd_tile_edges(
        torch.cuda.get_device_properties(dev).multi_processor_count, seed=29)
    ops_t = kernel_operands(tgraph, ce, h, c, l1, 3, dev)
    bwd, (g_t, _) = check_bwd_w64(
        "fold", (("train_shape", tgraph, ops_t),
                 ("small_case", small_graph, ops_s),
                 ("tile_edges", bwd_tiles,
                  kernel_operands(bwd_tiles, ce, h, c, l1, 30, dev))),
        torch.Generator().manual_seed(5), c)
    bwd["tile_edges"]["graph"] = tiles_info
    bwd_ms = cuda_ms(lambda: fe.fused_edge_tail_agg_bwd(*ops_t, g_t), reps=50)
    bwd_plain_ms = cuda_ms(
        lambda: fe.fused_edge_tail_agg_bwd_plain(*ops_t, g_t), reps=10)
    fwd_t = compare(fe.fused_edge_tail_agg(*ops_t),
                    fe.fused_edge_tail_agg_plain(*ops_t), KERNEL_RTOL,
                    KERNEL_ATOL)
    fwd_ms_t = cuda_ms(lambda: fe.fused_edge_tail_agg(*ops_t), reps=50)
    fwd_plain_ms_t = cuda_ms(lambda: fe.fused_edge_tail_agg_plain(*ops_t),
                             reps=20)
    bnd_bwd = bound("bwd", tgraph, ce, h, c, l1)
    bnd_bwd.update(tc_bound(bnd_bwd))
    bnd_fwd_t = bound("fwd", tgraph, ce, h, c, l1)
    bnd_fwd_t.update(tc_bound(bnd_fwd_t),
                     share_of_tc_bound=tc_bound(bnd_fwd_t)["tc_bound_ms"]
                     / fwd_ms_t)
    bwd_ok = fwd_t["ok"] and all(
        v["ok"] for case in bwd.values() for v in case.values()
        if isinstance(v, dict) and "ok" in v)
    bwd_err = max(v["max_abs_err"] for case in bwd.values()
                  for v in case.values()
                  if isinstance(v, dict) and "max_abs_err" in v)
    emit({"phase": "kernel_bwd", "n_node": tgraph.n_node,
          "n_edge": tgraph.n_edge,
          "mean_degree": float(tgraph.degree.mean()),
          "max_degree": int(tgraph.degree.max()), "l1": l1,
          "tolerance": {"rtol": BWD_RTOL, "atol_rel_to_max": BWD_ATOL_REL,
                        "max_rel_l2": BWD_L2,
                        "elementwise": "small_case and tile_edges"},
          **bwd, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "library_ms": None,
          **bnd_bwd, "share_of_tc_bound": bnd_bwd["tc_bound_ms"] / bwd_ms,
          "build": bwd_w64_build(),
          "forward_at_this_shape": {"vs_plain": fwd_t, "ms": fwd_ms_t,
                                    "plain_ms": fwd_plain_ms_t, **bnd_fwd_t},
          "ok": bwd_ok})
    if not bwd_ok:
        return 4, [], {}

    # 6. training: Trainer.fit at full width on seeded KS data
    def fresh_model():
        return create_model("magnet_cnn", hp, device=dev, seed=0)

    def loss_and_grads(m, impl):
        m.impl = impl
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(batch0, tgraph, train=True)
        loss.backward()
        m.impl = "kernel"
        return loss.detach(), {k: p.grad.clone()
                               for k, p in m.named_parameters()}

    tmodel = fresh_model()
    first_step_s = timed(lambda: loss_and_grads(tmodel, "kernel"))
    loss_k, grads_k = loss_and_grads(tmodel, "kernel")
    loss_p, grads_p = loss_and_grads(tmodel, "plain")
    grad_l2 = {k: float((grads_k[k].double() - grads_p[k].double()).norm()
                        / grads_p[k].double().norm().clamp_min(1e-30))
               for k in grads_p}
    worst = max(grad_l2, key=grad_l2.get)
    grads_finite = all(bool(torch.isfinite(v).all()) for v in grads_k.values())
    loss_rel = float((loss_k - loss_p).abs() / loss_p.abs())
    vs_plain_ok = (grads_finite and grad_l2[worst] <= TRAIN_GRAD_L2
                   and loss_rel <= TRAIN_LOSS_RTOL)

    n_epochs, steps = 2, len(loaders["train"])
    val_batches = len(loaders["val"])
    mp = hp["num_message_passing_steps"]
    windows = (data_cfg["nt_train"] - hp["time_slice"]) // hp["time_slice"]
    step_losses = []

    def record_steps(trainer):
        inner_step = trainer.device_step

        def recording_step(batch, graph):
            metrics = inner_step(batch, graph)
            step_losses.append(metrics["loss"])
            return metrics

        trainer.device_step = recording_step

    def reset():
        fe.launches = fe.launches_bwd = 0

    fit, resumed = fit_checkpoint_resume(
        fresh_model, hp, loaders, dev, n_epochs, reset,
        lambda: (fe.launches, fe.launches_bwd), prepare=record_steps)
    train_launches, train_launches_bwd = fit.pop("launches")
    want_bwd = windows * mp * steps * n_epochs
    want_fwd = want_bwd + windows * mp * val_batches * n_epochs
    step_losses = [float(v) for v in step_losses]
    losses_finite = (all(np.isfinite(v) for v in step_losses)
                     and fit["losses_finite"])
    # seconds per step, steady: kernel path, then the plain path
    host_batches = list(loaders["train"])
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    resumed.model.impl = "plain"
    step_plain_s = timed(lambda: [resumed.train_step(b)
                                  for b in host_batches]) / steps
    resumed.model.impl = "kernel"
    train_ok = (train_launches == want_fwd and train_launches_bwd == want_bwd
                and losses_finite and step_losses[-1] < step_losses[0]
                and vs_plain_ok and fit["checkpoint_ok"] and fit["resume_ok"])
    emit({"phase": "train", "batch_size": data_cfg["batch_size"],
          "val_batches_per_epoch": val_batches, "windows_per_step": windows,
          "data": {**SMOKE_DATA, "seconds_to_make": t_data},
          "launches": train_launches, "expected_launches": want_fwd,
          "launches_bwd": train_launches_bwd,
          "expected_launches_bwd": want_bwd,
          "launches_per_train_step": {"fwd": windows * mp, "bwd": windows * mp},
          "step_losses": step_losses, **fit,
          "losses_finite": losses_finite, "grads_finite": grads_finite,
          "vs_plain": {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
                       "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
                       "worst_grad_rel_l2": grad_l2[worst],
                       "worst_grad": worst, "grad_rel_l2_tol": TRAIN_GRAD_L2,
                       "ok": vs_plain_ok},
          "seconds_first_loss_and_backward": first_step_s, "seconds_per_step": step_s,
          "seconds_per_step_plain": step_plain_s, "ok": train_ok})

    # the kernels' entries: #8's times are those at the eval slice's shape
    kernels = [{
        "name": "fused_edge_tail_agg", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg.cu",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1356",
        "launches": launches + train_launches, "launches_eval": launches,
        "launches_train": train_launches,
        "max_abs_err": max(big["max_abs_err"], small["max_abs_err"],
                           tile_case["max_abs_err"], fwd_t["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
        "bound_by": bnd["bound_by"], "tc_bound_ms": bnd["tc_bound_ms"],
        "tc_bound_by": bnd["tc_bound_by"], "library_ms": None,
        "ms_train_shape": fwd_ms_t, "plain_ms_train_shape": fwd_plain_ms_t,
        "bound_ms_train_shape": bnd_fwd_t["bound_ms"],
        "tc_bound_ms_train_shape": bnd_fwd_t["tc_bound_ms"],
        "ok": kernel_ok and slice_ok and train_ok}, {
        "name": "fused_edge_tail_agg_bwd", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bwd.cu",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1665",
        "launches": train_launches_bwd, "max_abs_err": bwd_err,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bnd_bwd["bound_ms"], "bound_by": bnd_bwd["bound_by"],
        "tc_bound_ms": bnd_bwd["tc_bound_ms"],
        "tc_bound_by": bnd_bwd["tc_bound_by"],
        "library_ms": None, "ok": bwd_ok and train_ok}]
    return (0 if train_ok else 5), kernels, {}


def bf16_bound(kernel: str, graph, ce, h, c, l1) -> dict:
    """Least time on the card for one call of the bf16 forward (``"fwd"``)
    or backward (``"bwd"``): its operations at the dense bf16 rate (the
    backward three times the forward's, as ``bound``), against each input
    read once and each output written once over the HBM rate, the bf16
    operands and gradients at 2 bytes, ln_s, ln_b, g, out and d_ln at 4,
    the indices at 4."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * (ce * h + l1 * h * h + h * c)
    weights = ce * h + h + l1 * (h * h + h) + h * c + c
    inputs = 2.0 * (e * ce + 2 * n * h + weights) + 4.0 * (2 * c + e + n + 1)
    if kernel == "fwd":
        nbytes = inputs + 4.0 * n * c
    elif kernel == "bwd":
        flops *= 3.0
        nbytes = (inputs + 4.0 * n * c
                  + 2.0 * (e * ce + 2 * n * h + weights) + 4.0 * 2 * c)
    else:
        raise ValueError(kernel)
    t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def compare_bf16(got, want) -> dict:
    """A bf16 forward against its plain version: elementwise within
    BF16_RTOL |want| + BF16_ATOL and at relative L2 BF16_L2."""
    out = compare(got, want, BF16_RTOL, BF16_ATOL)
    l2 = float((got.double() - want.double()).norm()
               / want.double().norm().clamp_min(1e-30))
    out.update(rel_l2_err=l2, max_rel_l2=BF16_L2, ok=out["ok"] and l2 <= BF16_L2)
    return out


def worst(found) -> float:
    """The largest max_abs_err anywhere in a nest of results."""
    if not isinstance(found, dict):
        return 0.0
    return max([float(found.get("max_abs_err", 0.0))]
               + [worst(v) for v in found.values()])


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def tie_receivers_bf16(ops, l1, entry="fold"):
    """``tie_receivers`` on the bf16 lane's recompute (the plain version's
    f32 pre-activations, each activation rounded to bf16): the receivers of
    the edges with a pre-activation within 1e-5 of zero relative to its
    layer's RMS, where the kernel's sums in another order may take the
    other side of 0.  ``ops`` are the wrapper's operands of ``entry``
    (fold, pregathered or pe).  The pregathered and pe entries' first
    pre-activation, h0 + pxi[i] or (pe + pxj[j]) + pxi[i], is the same f32
    sum of bf16 values in the kernel and the plain version (no product), so
    only the tail layers' are searched there."""
    f = [t.float() if t is not None and t.is_floating_point() else t
         for t in ops]
    if entry == "fold":
        e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest = f[:9]
    elif entry == "pregathered":
        h0, pxi, rowptr, w_rest, b_rest = f[:5]
    else:
        pe, pxj, pxi, senders, rowptr = f[:5]
        w_rest, b_rest = f[7], f[8]
    n = rowptr.numel() - 1
    deg = (rowptr[1:] - rowptr[:-1]).long()
    receivers = torch.repeat_interleave(torch.arange(n, device=pxi.device),
                                        deg)
    if entry == "fold":
        z = e0 @ we + be + (pxj[senders.long()] + pxi[receivers])
    elif entry == "pregathered":
        z = h0 + pxi[receivers]
    else:
        z = (pe + pxj[senders.long()]) + pxi[receivers]
    near = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    for k in range(l1 + 1):
        if k or entry == "fold":
            near |= (z.abs() < 1e-5 * z.pow(2).mean().sqrt()).any(1)
        if k < l1:
            z = torch.relu(z).bfloat16().float() @ w_rest[k] + b_rest[k]
    return torch.unique(receivers[near])


def bf16_ptxas() -> dict:
    """The bf16 library's ptxas lines and each kernel's dynamic shared
    memory (the fold, pregathered and pe entries' forward and backward, by
    L1)."""
    import ctypes

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    lib = cuda_build.build(fe.BF16)
    smem = ctypes.CDLL(str(lib)).fused_edge_tail_agg_bf16_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {"ptxas": ptxas_lines(lib),
            "smem_bytes": {which: {l1: smem(i, l1) for l1 in range(4)}
                           for i, which in enumerate((
                               "fwd", "bwd", "pregathered_fwd",
                               "pregathered_bwd", "pe_fwd", "pe_bwd"))}}


def wgmma_ptxas(lines) -> list[str]:
    """ptxas's lines (entry, spills, registers) of the width-64 bf16
    backward's wgmma kernel, a group an entry and L1."""
    out, keep = [], False
    for ln in lines:
        if "entry function" in ln:
            keep = "wgmma_bwd_kernel" in ln
        if keep:
            out.append(ln)
    return out


def bwd64_bf16_launches() -> int:
    """Kernels the width-64 bf16 backward's last call launched (the
    library's own count)."""
    import ctypes

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    count = ctypes.CDLL(str(cuda_build.build(fe.BF16))) \
        .fused_edge_tail_agg_bf16_bwd_launches
    count.restype = ctypes.c_int
    return count()


def bwd64_bf16_checks(entry, dev, sms, seed) -> dict:
    """The width-64 bf16 backward of ``entry`` (fold #9, pregathered #3 or
    pe #7 with the f32 #1 for d_pxj; the wgmma kernel, two warpgroups a
    block) against its bf16 plain version at L1 = 0..3 on the small graph
    (a degree-0 receiver, fewer tiles than blocks: one tile a block, its
    second warpgroup idle), at E = 1 and on a tile graph
    (``tile_edges_graph`` with more than four tiles a block: both
    warpgroups walk two tiles or more, the receiver hint carried from tile
    to tile), every gradient by relative L2 within BF16_BWD_L2 (the
    elements outside BF16_RTOL |want| + BF16_BWD_ATOL_REL max|want|
    counted), in its operand's dtype, the degree-0 rows of d_pxi
    zero, the same bits from run to run in every gradient but d_pxj / d_pxi
    (f32 atomics), and the kernels a call launches (at most 2).  Returns
    the results; ``ok`` gates them all."""
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.time_fwd import operands as c_operands
    from magnet_tpu_torch.time_fwd import to_bf16

    h, c = 64, 32
    fn, plain, names = {
        "fold": (fe.fused_edge_tail_agg_bf16_bwd,
                 fe.fused_edge_tail_agg_bf16_bwd_plain, fe.GRAD_NAMES),
        "pregathered": (fe.fused_edge_tail_agg_pregathered_bf16_bwd,
                        fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain,
                        fe.GRAD_NAMES_PREGATHERED),
        "pe": (fe.fused_edge_tail_agg_pe_bf16_bwd,
               fe.fused_edge_tail_agg_pe_bf16_bwd_plain,
               fe.GRAD_NAMES_PE)}[entry]

    def operands(graph, l1, s):
        if entry == "fold":
            return to_bf16(kernel_operands(graph, c, h, c, l1, s, dev))
        if entry == "pregathered":
            return to_bf16(pregathered_operands(graph, h, c, l1, s, dev))
        src, _, _, pxj, pxi, senders, rowptr, *tail = to_bf16(
            c_operands("pe", graph, h, h, c, l1, s, dev))
        return (src, pxj, pxi, senders, rowptr, graph.snd_ptr.to(dev),
                graph.snd_perm.to(dev), *tail)

    gen = torch.Generator().manual_seed(seed)
    # more than 4 sms tiles: each warpgroup walks two tiles at least, the
    # receiver hint carried from tile to tile
    tiles = tile_edges_graph(fe.BWD_TILE, seed + 1,
                             n_edge_min=4 * sms * fe.BWD_TILE + 1)
    n_tiles = -(-tiles.n_edge // fe.BWD_TILE)
    blocks = min(sms, n_tiles)
    per_group = [(b1 - b0 + g) // 2 for b in range(blocks)
                 for b0, b1 in [(b * n_tiles // blocks,
                                 (b + 1) * n_tiles // blocks)]
                 for g in (0, 1)]
    tiles_info = {"n_edge": tiles.n_edge, "tile": fe.BWD_TILE,
                  "n_tiles": n_tiles, "blocks": blocks,
                  "tiles_per_warpgroup": [min(per_group), max(per_group)],
                  "max_degree": int(tiles.degree.max())}
    out, ok, calls = {}, True, set()
    for label, graph in (("small_case", small_line_graph()),
                         ("one_edge", one_edge_graph()),
                         ("tile_edges", tiles)):
        for l1 in range(4):
            ops = operands(graph, l1, seed + 2 + l1)
            g = torch.randn(graph.n_node, c, generator=gen).to(dev)
            got = fn(*ops, g)
            torch.cuda.synchronize()
            calls.add(bwd64_bf16_launches())
            want = plain(*ops, g)
            res = {name: compare_grad(a, b, elementwise=False,
                                      rtol=BF16_RTOL,
                                      atol_rel=BF16_BWD_ATOL_REL,
                                      max_l2=BF16_BWD_L2)
                   for name, a, b in zip(names, got, want) if b.numel()}
            zero = graph.degree.to(dev) == 0
            res["dtypes_ok"] = ([a.dtype for a in got]
                                == [b.dtype for b in want])
            res["degree0_rows_zero"] = bool(
                (got[names.index("pxi")][zero] == 0).all())
            res["bits_equal_run_to_run"] = bits_equal_bwd(fn, ops, g, names)
            res["n_edge"] = graph.n_edge
            ok = ok and res["dtypes_ok"] and res["degree0_rows_zero"] \
                and res["bits_equal_run_to_run"]["ok"] and all(
                    v["ok"] for v in res.values()
                    if isinstance(v, dict) and "ok" in v)
            out[f"{label}_l1_{l1}"] = res
            del ops, got, want
    out["tile_edges_graph"] = tiles_info
    out["launches_per_call"] = sorted(calls)
    out["ok"] = ok and max(calls) <= 2
    return out


def fwd_bf16_library(width):
    """The bf16 forward's library at ``width`` (64 or 128), loaded, and the
    prefix of its C entries."""
    import ctypes

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    name = fe.BF16 if width == 64 else fe.BF16_W128
    return ctypes.CDLL(str(cuda_build.build(name))), name


def fwd_bf16_ptxas(width) -> dict:
    """ptxas's lines (entry, spills, registers) of the bf16 forward's wgmma
    kernel at ``width``, one group an entry, whether any spills, and each
    entry's dynamic shared memory at L1 = 0..3."""
    import ctypes

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    lib, name = fwd_bf16_library(width)
    lines, keep = [], False
    for ln in ptxas_lines(cuda_build.build(name)):
        if "entry function" in ln:
            keep = "wgmma_fwd_kernel" in ln
        if keep:
            lines.append(ln)
    spills = [ln for ln in lines if "spill" in ln and not (
        "0 bytes spill stores" in ln and "0 bytes spill loads" in ln)]
    if width == 64:
        smem = lib.fused_edge_tail_agg_bf16_smem
        which = {"fold": 0, "pregathered": 2, "pe": 4}
        get = lambda entry, l1: smem(which[entry], l1)  # noqa: E731
    else:
        smem = lib.fused_edge_tail_agg_bf16_w128_fwd_smem
        get = lambda entry, l1: smem(fe.ENTRY[entry], l1)  # noqa: E731
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {"ptxas": lines, "spills": spills, "no_spill": not spills,
            "kernels": sum("entry function" in ln for ln in lines),
            "smem_bytes": {entry: {l1: get(entry, l1) for l1 in range(4)}
                           for entry in ("fold", "pe", "pregathered")}}


def fwd_bf16_checks(entry, width, dev, seed, paths=(), smalls=True) -> dict:
    """The bf16 forward of ``entry`` (fold #8, pregathered #2 or pe #6; the
    wgmma kernel, two warpgroups a block, every weight resident) at width
    64 ((32, 64, 32) / (64, 32)) or 128 against its bf16 plain version at
    L1 = 0..3 on the small graph (a degree-0 receiver, receivers of up to
    64 edges, fewer tiles than blocks: the second warpgroup of a block
    idle), at E = 1, on a tile graph (``tile_edges_graph`` with more than
    four tiles a block: both warpgroups walk two tiles or more, receivers
    crossing tile and warpgroup boundaries) and on the path graphs
    ``paths`` ((label, graph) pairs; ``smalls`` False: those alone), each
    within ``compare_bf16``'s tolerance, the degree-0 rows zero; out
    bit-equal over two calls; the kernels a call launches (its library's
    own count: 2, 1 for one tile); the blocks of a call and the blocks an
    SM holds; ptxas (no spill).  Returns the results; ``ok`` gates them
    all."""
    import ctypes

    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.time_fwd import operands as c_operands
    from magnet_tpu_torch.time_fwd import to_bf16

    ce, h, c = (32, 64, 32) if width == 64 else (128, 128, 128)
    fn, plain = {
        "fold": (fe.fused_edge_tail_agg_bf16,
                 fe.fused_edge_tail_agg_bf16_plain),
        "pregathered": (fe.fused_edge_tail_agg_pregathered_bf16,
                        fe.fused_edge_tail_agg_pregathered_bf16_plain),
        "pe": (fe.fused_edge_tail_agg_pe_bf16,
               fe.fused_edge_tail_agg_pe_bf16_plain)}[entry]
    lib, name = fwd_bf16_library(width)
    launches = getattr(lib, f"{name}_fwd_launches")
    launches.restype = ctypes.c_int
    blocks = getattr(lib, f"{name}_fwd_blocks")
    blocks.argtypes, blocks.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int

    def operands(graph, l1, s):
        if entry == "fold":
            return to_bf16(kernel_operands(graph, ce, h, c, l1, s, dev))
        if entry == "pregathered":
            return to_bf16(pregathered_operands(graph, h, c, l1, s, dev))
        src, _, _, pxj, pxi, senders, rowptr, *tail = to_bf16(
            c_operands("pe", graph, h, h, c, l1, s, dev))
        return (src, pxj, pxi, senders, rowptr, graph.snd_ptr.to(dev),
                graph.snd_perm.to(dev), *tail)

    cap = blocks(fe.ENTRY[entry], 1 << 30)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = tile_edges_graph(fe.FWD_TILE, seed + 1,
                             n_edge_min=4 * cap * fe.FWD_TILE + 1)
    n_tiles = -(-tiles.n_edge // fe.FWD_TILE)
    per_group = [(b1 - b0 + g) // 2 for b in range(cap)
                 for b0, b1 in [(b * n_tiles // cap, (b + 1) * n_tiles // cap)]
                 for g in (0, 1)]
    out = {"widths": [ce, h, c] if entry == "fold" else [h, c],
           "grid_cap_blocks": cap, "sms": sms, "blocks_an_sm": cap / sms,
           "tile_edges_graph": {
               "n_edge": tiles.n_edge, "n_tiles": n_tiles,
               "tiles_per_warpgroup": [min(per_group), max(per_group)],
               "max_degree": int(tiles.degree.max())}}
    ok, calls = True, {}
    cases = [("small_case", small_line_graph()), ("one_edge", one_edge_graph()),
             ("tile_edges", tiles)] if smalls else []
    cases += list(paths)
    for label, graph in cases:
        for l1 in range(4):
            ops = operands(graph, l1, seed + 2 + l1)
            got = fn(*ops)
            torch.cuda.synchronize()
            n_launch = launches()
            res = compare_bf16(got, plain(*ops))
            zero = graph.degree.to(dev) == 0
            res.update(n_edge=graph.n_edge, launches_a_call=n_launch,
                       blocks=blocks(fe.ENTRY[entry], graph.n_edge),
                       degree0_rows_zero=bool((got[zero] == 0).all()),
                       bits_equal_run_to_run=torch.equal(got, fn(*ops)))
            want_launches = 1 if graph.n_edge <= fe.FWD_TILE else 2
            calls[n_launch] = calls.get(n_launch, 0) + 1
            ok = (ok and res["ok"] and res["degree0_rows_zero"]
                  and res["bits_equal_run_to_run"]
                  and n_launch == want_launches)
            out[f"{label}_l1_{l1}"] = res
            del ops, got
    build = fwd_bf16_ptxas(width)
    out.update(launches_per_call=calls, ptxas_no_spill=build["no_spill"],
               smem_bytes=build["smem_bytes"][entry],
               ok=ok and build["no_spill"] and cap >= sms)
    return out


def cnn_bf16_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``bf16_kernel``, ``bf16_kernel_bwd``, ``bf16_slice`` and
    ``bf16_train``: MAgNet[CNN] 1D's bf16 lane (``graph_dtype=bf16``), its
    two kernels (the fold entry's bf16 build of #8 and #9 at (32, 64, 32))
    against their bf16 plain versions and the f32 kernels, ``evaluate`` on
    the cnn group's 16 Heat trajectories and ``Trainer.fit`` on its KS
    data, each on the bf16 kernels alone.  Returns the exit code, the two
    kernels' entries and no launches of another group's kernel."""
    from magnet_tpu_torch.config import DATAMODULE_IMPLICIT, MAGNET_CNN
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.time_bwd import runner as bwd_runner
    from magnet_tpu_torch.time_bwd import runner_bf16 as bwd_runner_bf16
    from magnet_tpu_torch.time_fwd import bind, in_turns, runner, runner_bf16
    from magnet_tpu_torch.time_fwd import to_bf16
    from magnet_tpu_torch.train.trainer import Trainer
    from magnet_tpu_torch.utils import to_device

    hp = dict(MAGNET_CNN)
    hp_bf = {**hp, "graph_dtype": "bf16"}
    ce, h, c = hp["latent_dim"], hp["mlp_hidden"], hp["latent_dim"]
    l1 = hp["mlp_layers"] - 1
    batches, loaders = data["heat"], data["ks_loaders"]
    model = create_model("magnet_cnn", hp_bf, device=dev, seed=0)
    egraph = model.build_graph(
        {k: torch.as_tensor(v) for k, v in batches[0].items()})
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    tgraph = model.build_graph(batch0)
    small = small_line_graph()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bwd_tiles, tiles_info = bwd_tile_edges(sms, seed=29)
    build = bf16_ptxas()
    fn32 = bind(cuda_build.build(fe.FWD), fe.FWD)
    fn32_bwd = bind(cuda_build.build(fe.BWD), fe.BWD)

    # bf16_kernel: #8's bf16 build vs its plain version and vs the f32
    # kernel on the unrounded operands, at the eval and training graphs,
    # the small graph (degree-0 receiver, 64-edge receivers, L1 = 1) and
    # the forward's tile graph; bit-equal launches; times in turns with the
    # f32 build
    t_phase = time.perf_counter()
    fwd, ops = {}, {}
    for label, graph, l1c, seed in (
            ("eval_shape", egraph, l1, 1), ("train_shape", tgraph, l1, 3),
            ("small_case", small, 1, 2),
            ("tile_edges", tile_edges_graph(fe.FWD_TILE, seed=26), l1, 27)):
        ops[label] = kernel_operands(graph, ce, h, c, l1c, seed, dev)
        ops_bf = to_bf16(ops[label])
        got = fe.fused_edge_tail_agg_bf16(*ops_bf)
        torch.cuda.synchronize()
        res = compare_bf16(got, fe.fused_edge_tail_agg_bf16_plain(*ops_bf))
        # the receiver means, as the model reads them (see BF16_VS_F32_RTOL)
        deg = graph.degree.to(dev).clamp_min(1.0)[:, None]
        got32 = fe.fused_edge_tail_agg(*ops[label])
        res["vs_f32_kernel"] = compare(got / deg, got32 / deg,
                                       BF16_VS_F32_RTOL, BF16_VS_F32_ATOL)
        res["vs_f32_kernel"]["sums_max_abs_err"] = float(
            (got - got32).abs().max())
        zero = graph.degree.to(dev) == 0
        res.update(n_edge=graph.n_edge, l1=l1c,
                   max_degree=int(graph.degree.max()),
                   n_degree0=int(zero.sum()),
                   degree0_rows_zero=bool((got[zero] == 0).all()))
        fwd[label] = res
    ops_e = to_bf16(ops["eval_shape"])
    bits_equal = torch.equal(fe.fused_edge_tail_agg_bf16(*ops_e),
                             fe.fused_edge_tail_agg_bf16(*ops_e))
    timing = {}
    for label, graph in (("eval_shape", egraph), ("train_shape", tgraph)):
        ops_bf = to_bf16(ops[label])
        order, times, mean = in_turns(
            {"f32": runner(fn32, "fold", ops[label], (ce, h, c)),
             "bf16": runner_bf16(ops_bf)}, first="f32", then="bf16")
        timing[label] = {
            "order": order, "ms": times, "mean_ms": mean,
            "plain_ms": cuda_ms(
                lambda: fe.fused_edge_tail_agg_bf16_plain(*ops_bf), reps=20),
            **bf16_bound("fwd", graph, ce, h, c, l1)}
    # the wgmma kernel at L1 = 0..3 on the small, E = 1 and tile graphs and
    # at the 1D eval and training graphs
    wgmma_fwd = fwd_bf16_checks("fold", 64, dev, seed=400, paths=(
        ("eval_shape", egraph), ("train_shape", tgraph)))
    fwd_ok = bits_equal and wgmma_fwd["ok"] and all(
        r["ok"] and r["vs_f32_kernel"]["ok"] and r["degree0_rows_zero"]
        for r in fwd.values())
    emit({"phase": "bf16_kernel", "ce": ce, "h": h, "c": c,
          "tolerance": {"vs_plain": {"rtol": BF16_RTOL, "atol": BF16_ATOL,
                                     "max_rel_l2": BF16_L2},
                        "vs_f32_kernel": {"rtol": BF16_VS_F32_RTOL,
                                          "atol": BF16_VS_F32_ATOL}},
          **fwd, "bits_equal_run_to_run": bits_equal, "timing": timing,
          "library_ms": None, **build, "wgmma_fwd_checks": wgmma_fwd,
          "wgmma_fwd_ptxas": fwd_bf16_ptxas(64),
          "seconds": time.perf_counter() - t_phase, "ok": fwd_ok})
    if not fwd_ok:
        return 24, [], {}

    # bf16_kernel_bwd: #9's bf16 build vs its plain version (every
    # gradient, in its operand's dtype) and vs the f32 kernel, at the
    # training graph (g zero on the receivers of relu ties, counted), the
    # small graph and the backward's tile graph; times in turns
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    bwd, train_g = {}, None
    operand_dtypes = [t.dtype for t in to_bf16(ops["train_shape"])
                      if t.is_floating_point()]
    for label, graph, ops32 in (
            ("train_shape", tgraph, ops["train_shape"]),
            ("small_case", small, ops["small_case"]),
            ("tile_edges", bwd_tiles,
             kernel_operands(bwd_tiles, ce, h, c, l1, 30, dev))):
        ops_bf = to_bf16(ops32)
        g = torch.randn(graph.n_node, c, generator=gen).to(dev)
        res = {}
        if label == "train_shape":
            ties = tie_receivers_bf16(ops_bf, l1)
            g[ties] = 0.0
            res["tie_receivers_zeroed"] = int(ties.numel())
            train_g = g
        got = fe.fused_edge_tail_agg_bf16_bwd(*ops_bf, g)
        torch.cuda.synchronize()
        want = fe.fused_edge_tail_agg_bf16_bwd_plain(*ops_bf, g)
        want32 = fe.fused_edge_tail_agg_bwd(*ops32, g)
        plain32 = fe.fused_edge_tail_agg_bwd_plain(*ops32, g)
        deep = ops32[7].shape[0] > BF16_VS_F32_DEPTH
        for name, a, b, b32, p32 in zip(fe.GRAD_NAMES, got, want, want32,
                                        plain32):
            res[name] = compare_grad(a, b, elementwise=False, rtol=BF16_RTOL,
                                     atol_rel=BF16_BWD_ATOL_REL,
                                     max_l2=BF16_BWD_L2)
            if b32.numel():
                l2, l2_plain = rel_l2(a, b32), rel_l2(b, p32)
                res[name].update(vs_f32_kernel_rel_l2=l2,
                                 plain_bf16_vs_plain_f32_rel_l2=l2_plain,
                                 vs_f32_ok=l2 < BF16_VS_F32_GRAD_L2 or (
                                     deep and l2 <= BF16_VS_F32_DEEP * l2_plain))
        res["dtypes_ok"] = ([a.dtype for a in got] == operand_dtypes)
        res["vs_f32_kernel_ok"] = all(
            v.get("vs_f32_ok", True) for v in res.values()
            if isinstance(v, dict))
        zero = graph.degree.to(dev) == 0
        res["degree0_rows_zero"] = bool((got[4][zero] == 0).all())
        res["n_edge"] = graph.n_edge
        if label == "train_shape":
            res["bits_equal_run_to_run"] = bits_equal_bwd(
                fe.fused_edge_tail_agg_bf16_bwd, ops_bf, g, fe.GRAD_NAMES)
        bwd[label] = res
    bwd["tile_edges"]["graph"] = tiles_info
    ops_bf = to_bf16(ops["train_shape"])
    order, times, mean = in_turns(
        {"f32": bwd_runner(fn32_bwd, "fold", ops["train_shape"], train_g,
                           (ce, h, c)),
         "bf16": bwd_runner_bf16(ops_bf, train_g)}, first="f32", then="bf16")
    bwd_timing = {"order": order, "ms": times, "mean_ms": mean,
                  "plain_ms": cuda_ms(
                      lambda: fe.fused_edge_tail_agg_bf16_bwd_plain(
                          *ops_bf, train_g), reps=10),
                  **bf16_bound("bwd", tgraph, ce, h, c, l1)}
    bwd_ok = all(
        all(v["ok"] for v in r.values() if isinstance(v, dict) and "ok" in v)
        and r["dtypes_ok"] and r["vs_f32_kernel_ok"] and r["degree0_rows_zero"]
        for r in bwd.values())
    # the wgmma kernel at L1 = 0..3 on the small, E = 1 and tile graphs
    wgmma = bwd64_bf16_checks("fold", dev, sms, seed=300)
    bwd_ok = (bwd_ok and bwd["train_shape"]["bits_equal_run_to_run"]["ok"]
              and wgmma["ok"])
    emit({"phase": "bf16_kernel_bwd", "l1": l1,
          "tolerance": {"vs_plain": {"max_rel_l2": BF16_BWD_L2,
                                     "counted_outside": {
                                         "rtol": BF16_RTOL,
                                         "atol_rel_to_max": BF16_BWD_ATOL_REL}},
                        "vs_f32_kernel_max_rel_l2": BF16_VS_F32_GRAD_L2,
                        "vs_f32_kernel_deeper_than_l1": BF16_VS_F32_DEPTH,
                        "vs_f32_kernel_deep_times_plain": BF16_VS_F32_DEEP},
          **bwd, "timing": bwd_timing, "library_ms": None,
          "wgmma_checks": wgmma, "wgmma_ptxas": wgmma_ptxas(build["ptxas"]),
          "seconds": time.perf_counter() - t_phase, "ok": bwd_ok})
    if not bwd_ok:
        return 25, [], {}
    del ops, ops_bf, ops_e

    # bf16_slice: evaluate() on the 16 Heat trajectories, on the bf16
    # kernels alone; its eval loss against the f32 lane's
    t_phase = time.perf_counter()
    reset_every_launch()
    t0 = time.perf_counter()
    metrics, preds = evaluate(model, batches, dev, return_predictions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eval_counts = every_launch()
    torch.cuda.reset_peak_memory_stats()
    steady_s = timed(lambda: evaluate(model, batches, dev))
    peak = torch.cuda.max_memory_allocated()
    model32 = create_model("magnet_cnn", hp, device=dev, seed=0)
    metrics32 = evaluate(model32, batches, dev)
    steady32_s = timed(lambda: evaluate(model32, batches, dev))
    del model32
    loss_rel = (abs(metrics["test_loss"] - metrics32["test_loss"])
                / abs(metrics32["test_loss"]))
    want_launches = 150 * len(batches)
    launches_ok = (eval_counts["fused_edge_bf16_fwd"] == want_launches
                   and not any(v for k, v in eval_counts.items()
                               if k != "fused_edge_bf16_fwd"))
    finite = (all(bool(torch.isfinite(p).all()) for p in preds)
              and all(np.isfinite(v) for v in metrics.values()))
    shape_ok = all(tuple(p.shape) == (b["hr_points"].shape[0], 240, 256, 1)
                   for p, b in zip(preds, batches))
    del preds
    slice_ok = (launches_ok and finite and shape_ok
                and loss_rel <= BF16_LOSS_RTOL)
    emit({"phase": "bf16_slice", "graph_dtype": "bf16",
          "batches": len(batches), "batch_size": 16, "metrics": metrics,
          "metrics_f32": metrics32, "loss_rel_err_vs_f32": loss_rel,
          "loss_rtol_vs_f32": BF16_LOSS_RTOL, "launches": eval_counts,
          "expected_bf16_launches": want_launches, "finite": finite,
          "shape_ok": shape_ok,
          "seconds_per_batch_first": first_s / len(batches),
          "seconds_per_batch": steady_s / len(batches),
          "seconds_per_batch_f32": steady32_s / len(batches),
          "peak_mem_bytes": peak,
          "seconds": time.perf_counter() - t_phase, "ok": slice_ok})
    if not slice_ok:
        return 26, [], {}

    # bf16_train: Trainer.fit on the KS data on the bf16 kernels alone:
    # falling loss, finite gradients, checkpoint and resume; one step on
    # the kernels against the plain versions; seconds a step beside the
    # f32 lane's
    t_phase = time.perf_counter()

    def fresh(params=hp_bf):
        return create_model("magnet_cnn", params, device=dev, seed=0)

    def loss_and_grads(m, impl):
        m.impl = impl
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(batch0, tgraph, train=True)
        loss.backward()
        m.impl = "kernel"
        return loss.item(), {k: p.grad.clone()
                             for k, p in m.named_parameters()}

    tmodel = fresh()
    loss_k, grads_k = loss_and_grads(tmodel, "kernel")
    loss_p, grads_p = loss_and_grads(tmodel, "plain")
    del tmodel
    grads_ok = all(bool(torch.isfinite(v).all()) and bool(v.abs().max() > 0)
                   for v in grads_k.values())
    grad_l2 = {k: rel_l2(grads_k[k], grads_p[k]) for k in grads_p}
    worst = max(grad_l2, key=grad_l2.get)
    step_vs_plain = {"loss_kernel": loss_k, "loss_plain": loss_p,
                     "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
                     "worst_grad_rel_l2": grad_l2[worst], "worst_grad": worst}
    step_losses = []

    def record_steps(trainer):
        inner = trainer.device_step

        def recording_step(batch, graph):
            metrics = inner(batch, graph)
            step_losses.append(float(metrics["loss"]))
            return metrics

        trainer.device_step = recording_step

    n_epochs, steps = 2, len(loaders["train"])
    fit, resumed = fit_checkpoint_resume(
        fresh, hp, loaders, dev, n_epochs, reset_every_launch, every_launch,
        prepare=record_steps)
    counts = fit.pop("launches")
    nt = DATAMODULE_IMPLICIT["nt_train"]
    windows = (nt - hp["time_slice"]) // hp["time_slice"]
    per_step = windows * hp["num_message_passing_steps"]
    want_bwd = per_step * steps * n_epochs
    want_fwd = want_bwd + per_step * len(loaders["val"]) * n_epochs
    launches_ok = (counts["fused_edge_bf16_fwd"] == want_fwd
                   and counts["fused_edge_bf16_bwd"] == want_bwd
                   and not any(v for k, v in counts.items()
                               if k not in ("fused_edge_bf16_fwd",
                                            "fused_edge_bf16_bwd")))
    host_batches = list(loaders["train"])
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    with tempfile.TemporaryDirectory() as workdir:
        trainer32 = Trainer(fresh(hp), max_epochs=1, lr=hp["lr"],
                            weight_decay=hp["weight_decay"],
                            factor=hp["factor"], step_size=hp["step_size"],
                            device=dev, workdir=workdir)
        trainer32.setup(steps)
        trainer32.train_step(host_batches[0])
        step32_s = timed(lambda: [trainer32.train_step(b)
                                  for b in host_batches]) / steps
        del trainer32
    losses_finite = (all(np.isfinite(v) for v in step_losses)
                     and fit["losses_finite"])
    loss_falls = falls(fit["epoch_train_losses"])
    train_ok = (launches_ok and losses_finite and grads_ok and loss_falls
                and step_vs_plain["loss_rel_err"] <= 1e-3
                and fit["checkpoint_ok"] and fit["resume_ok"])
    emit({"phase": "bf16_train", "graph_dtype": "bf16",
          "launches": counts, "expected_launches": {
              "fused_edge_bf16_fwd": want_fwd, "fused_edge_bf16_bwd": want_bwd},
          "launches_per_train_step": per_step, "step_losses": step_losses,
          **fit, "loss_falls": loss_falls, "grads_finite_nonzero": grads_ok,
          "step_vs_plain": step_vs_plain,
          "seconds_per_step": step_s, "seconds_per_step_f32": step32_s,
          "seconds": time.perf_counter() - t_phase, "ok": train_ok})

    e_t = timing["eval_shape"]
    b_t = bwd_timing
    kernels = [{
        "name": "fused_edge_tail_agg_bf16", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bf16.cu",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1356",
        "launches": eval_counts["fused_edge_bf16_fwd"]
        + counts["fused_edge_bf16_fwd"],
        "launches_eval": eval_counts["fused_edge_bf16_fwd"],
        "launches_train": counts["fused_edge_bf16_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in fwd.values()),
        "ms": e_t["mean_ms"]["bf16"], "ms_f32_build_in_turns":
        e_t["mean_ms"]["f32"], "plain_ms": e_t["plain_ms"],
        "bound_ms": e_t["bound_ms"], "bound_by": e_t["bound_by"],
        "library_ms": None,
        "ms_train_shape": timing["train_shape"]["mean_ms"]["bf16"],
        "plain_ms_train_shape": timing["train_shape"]["plain_ms"],
        "bound_ms_train_shape": timing["train_shape"]["bound_ms"],
        "share_of_bound": e_t["bound_ms"] / e_t["mean_ms"]["bf16"],
        "share_against": "bound_ms (bf16, 989 TFLOP/s)",
        "ok": fwd_ok and slice_ok and train_ok}, {
        "name": "fused_edge_tail_agg_bf16_bwd", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bf16.cu",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1665",
        "launches": counts["fused_edge_bf16_bwd"],
        "max_abs_err": max(v["max_abs_err"] for r in bwd.values()
                           for v in r.values()
                           if isinstance(v, dict) and "max_abs_err" in v),
        "ms": b_t["mean_ms"]["bf16"], "ms_f32_build_in_turns":
        b_t["mean_ms"]["f32"], "plain_ms": b_t["plain_ms"],
        "bound_ms": b_t["bound_ms"], "bound_by": b_t["bound_by"],
        "library_ms": None,
        "share_of_bound": b_t["bound_ms"] / b_t["mean_ms"]["bf16"],
        "share_against": "bound_ms (bf16, 989 TFLOP/s)",
        "ok": bwd_ok and train_ok}]
    return (0 if train_ok else 27), kernels, {}


def pregathered_bf16_bound(kernel: str, graph, h, c, l1) -> dict:
    """Least time on the card for one call of the bf16 pregathered forward
    (``"fwd"``) or backward (``"bwd"``): 2·E·(L1·H² + H·C) operations
    (three times that backward) at the dense bf16 rate, against each input
    read once and each output written once over the HBM rate: h0, pxi, the
    weights and (backward) d_h0, d_pxi and the weight gradients at 2 bytes,
    ln_s, ln_b, out, g and d_ln at 4, rowptr at 4."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * (l1 * h * h + h * c)
    weights = l1 * (h * h + h) + h * c + c
    inputs = 2.0 * (e * h + n * h + weights) + 4.0 * (2 * c + n + 1)
    if kernel == "fwd":
        nbytes = inputs + 4.0 * n * c
    elif kernel == "bwd":
        flops *= 3.0
        nbytes = (inputs + 4.0 * n * c + 2.0 * (e * h + n * h + weights)
                  + 4.0 * 2 * c)
    else:
        raise ValueError(kernel)
    t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def cnn2d_bf16_kernel_phases(dev) -> tuple[int, dict]:
    """Phases ``bf16_2d_kernel`` and ``bf16_2d_kernel_bwd``: the
    pregathered entry's bf16 build (#2, #3) and the bf16 segment sum (#1)
    against their bf16 plain versions at MAgNet[CNN] 2D's training graph
    (the datamodule's batch of 32), the small line graph and the tile
    graphs, and the fold entry's bf16 #8 at the 2D eval graph; each timed in
    turns with its f32 build, with its bf16 bound.  Returns the exit code
    and each kernel's numbers for the ``kernels`` line."""
    from magnet_tpu_torch.config import MAGNET_CNN_2D
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import segment as seg
    from magnet_tpu_torch.time_bwd import runner as bwd_runner
    from magnet_tpu_torch.time_bwd import runner_pregathered_bf16 as bwd_bf16
    from magnet_tpu_torch.time_bwd import runner_segment
    from magnet_tpu_torch.time_fwd import (
        bind,
        in_turns,
        runner,
        runner_bf16,
        runner_pregathered_bf16,
        to_bf16,
    )
    from magnet_tpu_torch.utils import make_coord_np

    hp = dict(MAGNET_CNN_2D)
    h, c = hp["mlp_hidden"], hp["latent_dim"]
    l1 = hp["mlp_layers"] - 1
    model = create_model("magnet_cnn_2d", {**hp, "graph_dtype": "bf16"},
                         device=dev, seed=0)
    graph = cnn2d_graph(model, CNN2D_KERNEL_BATCH, seed=7)
    mesh = make_coord_np([64, 64])
    egraph = model.build_graph(
        {"coords": torch.from_numpy(np.broadcast_to(mesh, (4, *mesh.shape))
                                    .copy()),
         "lr_frames": torch.zeros(1, 1, 1, 32, 32)})
    small = small_line_graph()
    tiles = tile_edges_graph(fe.FWD_TILE, seed=45)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bwd_tiles, tiles_info = bwd_tile_edges(sms, seed=46)
    build = bf16_ptxas()
    fn32 = bind(cuda_build.build(fe.FWD), fe.FWD)
    fn32_bwd = bind(cuda_build.build(fe.BWD), fe.BWD)

    def as_f32_entry(ops, gr):
        """The f32 C entry's 13 operands of pregathered operands: pxj and
        senders are not read by the pregathered entry."""
        h0, pxi, rowptr, *tail = ops
        return (h0, None, None, pxi, pxi, gr.senders.to(dev), rowptr, *tail)

    # bf16_2d_kernel: #2 bf16 vs its plain version at the training graph,
    # the small graph (degree-0 receiver, L1 = 1) and the forward's tile
    # graph; bit-equal launches; the receiver means against the f32 kernel
    # on the unrounded operands; then #8 bf16 at the 2D eval graph
    t_phase = time.perf_counter()
    fwd, ops = {}, {}
    for label, gr, l1c, seed in (("train_shape", graph, l1, 47),
                                 ("small_case", small, 1, 48),
                                 ("tile_edges", tiles, l1, 49)):
        ops[label] = pregathered_operands(gr, h, c, l1c, seed, dev)
        ops_bf = to_bf16(ops[label])
        got = fe.fused_edge_tail_agg_pregathered_bf16(*ops_bf)
        torch.cuda.synchronize()
        res = compare_bf16(
            got, fe.fused_edge_tail_agg_pregathered_bf16_plain(*ops_bf))
        deg = gr.degree.to(dev).clamp_min(1.0)[:, None]
        got32 = fe.fused_edge_tail_agg_pregathered(*ops[label])
        res["vs_f32_kernel"] = compare(got / deg, got32 / deg,
                                       BF16_VS_F32_RTOL, BF16_VS_F32_ATOL)
        res["vs_f32_kernel"]["sums_max_abs_err"] = float(
            (got - got32).abs().max())
        zero = gr.degree.to(dev) == 0
        res.update(n_edge=gr.n_edge, l1=l1c, max_degree=int(gr.degree.max()),
                   n_degree0=int(zero.sum()),
                   degree0_rows_zero=bool((got[zero] == 0).all()))
        fwd[label] = res
    ops_bf = to_bf16(ops["train_shape"])
    bits_equal = torch.equal(fe.fused_edge_tail_agg_pregathered_bf16(*ops_bf),
                             fe.fused_edge_tail_agg_pregathered_bf16(*ops_bf))
    order, times, mean = in_turns(
        {"f32": runner(fn32, "pregathered",
                       as_f32_entry(ops["train_shape"], graph), (h, h, c)),
         "bf16": runner_pregathered_bf16(ops_bf)}, first="f32", then="bf16")
    pre_timing = {"order": order, "ms": times, "mean_ms": mean,
                  "plain_ms": cuda_ms(
                      lambda: fe.fused_edge_tail_agg_pregathered_bf16_plain(
                          *ops_bf), reps=20),
                  **pregathered_bf16_bound("fwd", graph, h, c, l1)}
    # #8 bf16 at the 2D eval graph (the bf16 eval's launches)
    ops_e = kernel_operands(egraph, c, h, c, l1, 50, dev)
    ops_e_bf = to_bf16(ops_e)
    got = fe.fused_edge_tail_agg_bf16(*ops_e_bf)
    torch.cuda.synchronize()
    fold_2d = compare_bf16(got, fe.fused_edge_tail_agg_bf16_plain(*ops_e_bf))
    fold_2d["bits_equal_run_to_run"] = torch.equal(
        got, fe.fused_edge_tail_agg_bf16(*ops_e_bf))
    order, times, mean = in_turns(
        {"f32": runner(fn32, "fold", ops_e, (c, h, c)),
         "bf16": runner_bf16(ops_e_bf)}, first="f32", then="bf16")
    fold_2d.update(n_edge=egraph.n_edge, lane=egraph.lane, order=order,
                   ms=times, mean_ms=mean,
                   plain_ms=cuda_ms(lambda: fe.fused_edge_tail_agg_bf16_plain(
                       *ops_e_bf), reps=5),
                   **bf16_bound("fwd", egraph, c, h, c, l1))
    del ops_e, ops_e_bf, got
    # the wgmma kernel: #2 at L1 = 0..3 on the small, E = 1 and tile graphs
    # and at the training graph; #8 at L1 = 0..3 at the 2D eval graph
    wgmma_fwd = {
        "pregathered": fwd_bf16_checks("pregathered", 64, dev, seed=420,
                                       paths=(("train_shape", graph),)),
        "fold_2d_eval": fwd_bf16_checks("fold", 64, dev, seed=430,
                                        paths=(("eval_2d", egraph),),
                                        smalls=False)}
    fwd_ok = (graph.lane == "pregathered" and egraph.lane == "fold"
              and all(r["ok"] for r in wgmma_fwd.values())
              and bits_equal and fold_2d["ok"]
              and fold_2d["bits_equal_run_to_run"]
              and all(r["ok"] and r["vs_f32_kernel"]["ok"]
                      and r["degree0_rows_zero"] for r in fwd.values()))
    emit({"phase": "bf16_2d_kernel", "h": h, "c": c, "l1": l1,
          "train_graph": {"n_node": graph.n_node, "n_edge": graph.n_edge,
                          "lane": graph.lane},
          "tolerance": {"vs_plain": {"rtol": BF16_RTOL, "atol": BF16_ATOL,
                                     "max_rel_l2": BF16_L2},
                        "vs_f32_kernel_receiver_means": {
                            "rtol": BF16_VS_F32_RTOL,
                            "atol": BF16_VS_F32_ATOL}},
          **fwd, "bits_equal_run_to_run": bits_equal,
          "timing": pre_timing, "library_ms": None,
          "fold_bf16_at_2d_eval_shape": fold_2d, **build,
          "wgmma_fwd_checks": wgmma_fwd, "wgmma_fwd_ptxas": fwd_bf16_ptxas(64),
          "seconds": time.perf_counter() - t_phase, "ok": fwd_ok})
    if not fwd_ok:
        return 28, {}

    # bf16_2d_kernel_bwd: #3 bf16 vs its plain version (every gradient, in
    # its operand's dtype) at the training graph (g zero on the receivers
    # of relu ties, counted), the small graph and the backward's tile graph;
    # then #1 bf16 over the training graph's sender CSR on #3's d_h0
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(51)
    names = fe.GRAD_NAMES_PREGATHERED
    bwd, train_g, d_h0 = {}, None, None
    for label, gr, ops32 in (
            ("train_shape", graph, ops["train_shape"]),
            ("small_case", small, ops["small_case"]),
            ("tile_edges", bwd_tiles,
             pregathered_operands(bwd_tiles, h, c, l1, 52, dev))):
        ops_bf = to_bf16(ops32)
        g = torch.randn(gr.n_node, c, generator=gen).to(dev)
        res = {}
        if label == "train_shape":
            ties = tie_receivers_bf16(ops_bf, l1, entry="pregathered")
            g[ties] = 0.0
            res["tie_receivers_zeroed"] = int(ties.numel())
            train_g = g
        got = fe.fused_edge_tail_agg_pregathered_bf16_bwd(*ops_bf, g)
        torch.cuda.synchronize()
        want = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(*ops_bf, g)
        for name, a, b in zip(names, got, want):
            res[name] = compare_grad(a, b, elementwise=False, rtol=BF16_RTOL,
                                     atol_rel=BF16_BWD_ATOL_REL,
                                     max_l2=BF16_BWD_L2)
        res["dtypes_ok"] = ([a.dtype for a in got]
                            == [t.dtype for t in ops_bf
                                if t.is_floating_point()])
        zero = gr.degree.to(dev) == 0
        res["degree0_rows_zero"] = bool((got[1][zero] == 0).all())
        res["n_edge"] = gr.n_edge
        if label == "train_shape":
            res["bits_equal_run_to_run"] = bits_equal_bwd(
                fe.fused_edge_tail_agg_pregathered_bf16_bwd, ops_bf, g, names)
            d_h0 = got[0]
        bwd[label] = res
    bwd["tile_edges"]["graph"] = tiles_info
    ops_bf = to_bf16(ops["train_shape"])
    order, times, mean = in_turns(
        {"f32": bwd_runner(fn32_bwd, "pregathered",
                           as_f32_entry(ops["train_shape"], graph), train_g,
                           (h, h, c)),
         "bf16": bwd_bf16(ops_bf, train_g)}, first="f32", then="bf16")
    bwd_timing = {"order": order, "ms": times, "mean_ms": mean,
                  "plain_ms": cuda_ms(
                      lambda: fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(
                          *ops_bf, train_g), reps=10),
                  **pregathered_bf16_bound("bwd", graph, h, c, l1)}
    bwd_ok = all(
        all(v["ok"] for v in r.values() if isinstance(v, dict) and "ok" in v)
        and r["dtypes_ok"] and r["degree0_rows_zero"] for r in bwd.values())
    bwd_ok = bwd_ok and bwd["train_shape"]["bits_equal_run_to_run"]["ok"]
    # the wgmma kernel at L1 = 0..3 on the small, E = 1 and tile graphs
    wgmma = bwd64_bf16_checks("pregathered", dev, sms, seed=320)
    bwd_ok = bwd_ok and wgmma["ok"]

    # #1 bf16: the sender gather's backward at the training graph
    ptr, perm = graph.snd_ptr.to(dev), graph.snd_perm.to(dev)
    senders = graph.senders.to(dev).long()
    got_s = seg.segment_sum(d_h0, ptr, perm)
    again = seg.segment_sum(d_h0, ptr, perm)
    torch.cuda.synchronize()
    want_s = seg.segment_sum_plain(d_h0, ptr, perm)

    def library():
        """The library's sum: f32 index_add_, then rounded (two calls)."""
        return torch.zeros(graph.n_node, h, device=dev).index_add_(
            0, senders, d_h0.float()).bfloat16()

    lib_s = library()
    out_deg = torch.bincount(senders, minlength=graph.n_node)
    tol = (BF16_SEG_RTOL * want_s.double().abs()
           + SEG_ATOL_REL * float(want_s.float().abs().max()))
    err = (got_s.double() - want_s.double()).abs()
    seg_cmp = {"vs_plain": {"max_abs_err": float(err.max()),
                            "n_differing": int((got_s != want_s).sum()),
                            "ok": bool((err <= tol).all())},
               "vs_index_add": {
                   "max_abs_err": float((got_s.double() - lib_s.double())
                                        .abs().max()),
                   "ok": bool(((got_s.double() - lib_s.double()).abs()
                               <= tol).all())},
               "dtype": str(got_s.dtype),
               "equal_bits_run_to_run": bool(torch.equal(got_s, again)),
               "degree0_row_zero": bool((got_s[out_deg == 0] == 0).all()),
               "tolerance": {"rtol": BF16_SEG_RTOL,
                             "atol_rel_to_max": SEG_ATOL_REL}}
    order, times, mean = in_turns(
        {"f32": runner_segment(d_h0.float(), ptr, perm),
         "bf16": runner_segment(d_h0, ptr, perm)}, first="f32", then="bf16")
    seg_timing = {"order": order, "ms": times, "mean_ms": mean,
                  "plain_ms": cuda_ms(
                      lambda: seg.segment_sum_plain(d_h0, ptr, perm), reps=20),
                  "library_ms": cuda_ms(library, reps=50),
                  "library": "index_add_ in f32, then .bfloat16() (two calls)",
                  **segment_bound(graph, h, size=2.0)}
    seg_ok = (seg_cmp["vs_plain"]["ok"] and seg_cmp["vs_index_add"]["ok"]
              and seg_cmp["equal_bits_run_to_run"]
              and seg_cmp["degree0_row_zero"]
              and got_s.dtype == torch.bfloat16)
    emit({"phase": "bf16_2d_kernel_bwd", "l1": l1,
          "tolerance": {"vs_plain": {"max_rel_l2": BF16_BWD_L2,
                                     "counted_outside": {
                                         "rtol": BF16_RTOL,
                                         "atol_rel_to_max": BF16_BWD_ATOL_REL}}},
          **bwd, "timing": bwd_timing, "library_ms": None,
          "wgmma_checks": wgmma, "wgmma_ptxas": wgmma_ptxas(build["ptxas"]),
          "segment_sum_bf16": {**seg_cmp, "timing": seg_timing,
                               "ok": seg_ok},
          "seconds": time.perf_counter() - t_phase,
          "ok": bwd_ok and seg_ok})
    if not (bwd_ok and seg_ok):
        return 29, {}

    return 0, {"fwd": {"timing": pre_timing, "max_abs_err": worst(fwd)},
               "bwd": {"timing": bwd_timing, "max_abs_err": worst(bwd)},
               "seg": {"timing": seg_timing,
                       "max_abs_err": seg_cmp["vs_plain"]["max_abs_err"]},
               "fold_2d": fold_2d}


def cnn2d_bf16_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``bf16_2d_kernel``, ``bf16_2d_kernel_bwd``, ``bf16_2d_slice``
    and ``bf16_2d_train``: MAgNet[CNN] 2D's bf16 lane
    (``graph_dtype=bf16``), its kernels (``cnn2d_bf16_kernel_phases``),
    ``evaluate`` on the ``cnn2d`` group's eval batch (the fold lane's bf16
    #8) and ``Trainer.fit`` at its training shape (the pregathered lane's
    bf16 #2, #3 and #1), each on bf16 kernels alone.  Returns the exit
    code, the three new kernels' entries and the bf16 #8's launches and
    times at the 2D graphs."""
    from magnet_tpu_torch.config import DATAMODULE_IMPLICIT_2D, MAGNET_CNN_2D
    from magnet_tpu_torch.data.loader import DataLoader
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.train.trainer import Trainer
    from magnet_tpu_torch.utils import to_device

    rc, kern = cnn2d_bf16_kernel_phases(dev)
    if rc:
        return rc, [], {}
    hp = dict(MAGNET_CNN_2D)
    hp_bf = {**hp, "graph_dtype": "bf16"}
    mp, ts = hp["num_message_passing_steps"], hp["time_slice"]

    def fresh(params=hp_bf):
        return create_model("magnet_cnn_2d", params, device=dev, seed=0)

    # bf16_2d_slice: evaluate() on the cnn2d group's eval batch (4 at 64²),
    # on the bf16 #8 alone; its eval loss against the f32 lane's
    t_phase = time.perf_counter()
    loaders = data["cnn2d_loaders"]
    batches = list(DataLoader(loaders["test"].dataset, 4, shuffle=False,
                              drop_last=False))
    nt = DATAMODULE_IMPLICIT_2D["nt_test"]
    n_win = (nt - ts) // ts
    per_batch = n_win * mp
    model = fresh()
    reset_every_launch()
    t0 = time.perf_counter()
    metrics, preds = evaluate(model, batches, dev, return_predictions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eval_counts = every_launch()
    torch.cuda.reset_peak_memory_stats()
    steady_s = timed(lambda: evaluate(model, batches, dev))
    peak = torch.cuda.max_memory_allocated()
    model32 = fresh(hp)
    metrics32 = evaluate(model32, batches, dev)
    steady32_s = timed(lambda: evaluate(model32, batches, dev))
    del model32
    loss_rel = (abs(metrics["test_loss"] - metrics32["test_loss"])
                / abs(metrics32["test_loss"]))
    want_launches = per_batch * len(batches)
    launches_ok = (eval_counts["fused_edge_bf16_fwd"] == want_launches
                   and not any(v for k, v in eval_counts.items()
                               if k != "fused_edge_bf16_fwd"))
    finite = (all(bool(torch.isfinite(p).all()) for p in preds)
              and all(np.isfinite(v) for v in metrics.values()))
    shape_ok = all(tuple(p.shape) == (b["hr_points"].shape[0], n_win * ts,
                                      64 * 64, 1)
                   for p, b in zip(preds, batches))
    del preds
    slice_ok = (launches_ok and finite and shape_ok
                and loss_rel <= BF16_LOSS_RTOL)
    emit({"phase": "bf16_2d_slice", "graph_dtype": "bf16",
          "batches": len(batches), "batch_size": 4, "nt": nt, "res": 64,
          "metrics": metrics, "metrics_f32": metrics32,
          "loss_rel_err_vs_f32": loss_rel, "loss_rtol_vs_f32": BF16_LOSS_RTOL,
          "launches": eval_counts, "expected_bf16_launches": want_launches,
          "launches_per_batch": per_batch, "finite": finite,
          "shape_ok": shape_ok,
          "seconds_per_batch_first": first_s / len(batches),
          "seconds_per_batch": steady_s / len(batches),
          "seconds_per_batch_f32": steady32_s / len(batches),
          "peak_mem_bytes": peak,
          "seconds": time.perf_counter() - t_phase, "ok": slice_ok})
    if not slice_ok:
        return 30, [], {}

    # bf16_2d_train: Trainer.fit at the cnn2d group's training shape (batch
    # 8) on the bf16 kernels alone: the pregathered lane's #2, #3 and #1 a
    # step and the fold lane's #8 a validation batch; falling loss, finite
    # gradients, checkpoint and resume; one step against the plain versions
    # of the same lane; seconds a step beside the f32 lane's
    t_phase = time.perf_counter()
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)

    def loss_and_grads(m, gr, impl):
        m.impl = impl
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(batch0, gr, train=True)
        loss.backward()
        m.impl = "kernel"
        return loss.item(), {k: p.grad.clone()
                             for k, p in m.named_parameters()}

    tmodel = fresh()
    tgraph = tmodel.build_graph(batch0)
    loss_k, grads_k = loss_and_grads(tmodel, tgraph, "kernel")
    loss_p, grads_p = loss_and_grads(tmodel, tgraph, "plain")
    del tmodel
    # the JAX step's bf16 pe = s·pe + (1 − s)·b_e: where 1 − s rounds to −s
    # in bf16 (s = 2^9), b_e's two paths cancel exactly and its gradient is
    # zero in both packages; every other gradient is nonzero
    frozen = {f"_processor.gnn_stacks.{k}.edge_fn.0.layers.0.bias"
              for k in range(mp)
              if float(torch.tensor(1.0 - 2.0 ** k, dtype=torch.bfloat16))
              == -2.0 ** k}
    zero = {k for k, v in grads_k.items() if not v.abs().max() > 0}
    grads_ok = (all(bool(torch.isfinite(v).all()) for v in grads_k.values())
                and zero == frozen)
    grad_l2 = {k: rel_l2(grads_k[k], grads_p[k]) for k in grads_p}
    worst_g = max(grad_l2, key=grad_l2.get)
    step_vs_plain = {"loss_kernel": loss_k, "loss_plain": loss_p,
                     "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
                     "worst_grad_rel_l2": grad_l2[worst_g],
                     "worst_grad": worst_g}
    del grads_k, grads_p
    step_losses = []

    def record_steps(trainer):
        inner = trainer.device_step

        def recording_step(batch, graph):
            m = inner(batch, graph)
            step_losses.append(float(m["loss"]))
            return m

        trainer.device_step = recording_step

    n_epochs, steps = 2, len(loaders["train"])
    val_batches = len(loaders["val"])
    fit, resumed = fit_checkpoint_resume(
        fresh, hp, loaders, dev, n_epochs, reset_every_launch, every_launch,
        prepare=record_steps)
    counts = fit.pop("launches")
    nt_train = DATAMODULE_IMPLICIT_2D["nt_train"]
    per_step = ((nt_train - ts) // ts) * mp
    want_step = per_step * steps * n_epochs
    want = {"fused_edge_pregathered_bf16_fwd": want_step,
            "fused_edge_pregathered_bf16_bwd": want_step,
            "segment_sum_bf16": want_step,
            "fused_edge_bf16_fwd": per_batch * val_batches * n_epochs}
    launches_ok = all(counts[k] == v for k, v in want.items()) and not any(
        v for k, v in counts.items() if k not in want)
    host_batches = list(loaders["train"])
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    with tempfile.TemporaryDirectory() as workdir:
        trainer32 = Trainer(fresh(hp), max_epochs=1, lr=hp["lr"],
                            weight_decay=hp["weight_decay"],
                            factor=hp["factor"], step_size=hp["step_size"],
                            device=dev, workdir=workdir)
        trainer32.setup(steps)
        trainer32.train_step(host_batches[0])
        step32_s = timed(lambda: [trainer32.train_step(b)
                                  for b in host_batches]) / steps
        del trainer32
    losses_finite = (all(np.isfinite(v) for v in step_losses)
                     and fit["losses_finite"])
    loss_falls = falls(fit["epoch_train_losses"])
    train_ok = (tgraph.lane == "pregathered" and launches_ok
                and losses_finite and grads_ok and loss_falls
                and step_vs_plain["loss_rel_err"] <= 1e-3
                and fit["checkpoint_ok"] and fit["resume_ok"])
    emit({"phase": "bf16_2d_train", "graph_dtype": "bf16",
          "batch_size": CNN2D_BATCH, "val_batches_per_epoch": val_batches,
          "train_graph": {"n_node": tgraph.n_node, "n_edge": tgraph.n_edge,
                          "lane": tgraph.lane},
          "launches": counts, "expected_launches": want,
          "launches_per_train_step": per_step, "step_losses": step_losses,
          **fit, "loss_falls": loss_falls, "grads_finite_nonzero": grads_ok,
          "zero_grads": sorted(zero), "zero_grads_expected": sorted(frozen),
          "step_vs_plain": step_vs_plain,
          "seconds_per_step": step_s, "seconds_per_step_f32": step32_s,
          "seconds": time.perf_counter() - t_phase, "ok": train_ok})

    def row(name, part, replaces, launches):
        t = kern[part]["timing"]
        return {"name": name, "route": "cuda",
                "source": "magnet_tpu_torch/csrc/" + (
                    "segment_sum.cu" if part == "seg"
                    else "fused_edge_tail_agg_bf16.cu"),
                "replaces": f"magnet_tpu/ops/pallas_kernels.py:{replaces}",
                "launches": launches,
                "max_abs_err": kern[part]["max_abs_err"],
                "ms": t["mean_ms"]["bf16"],
                "ms_f32_build_in_turns": t["mean_ms"]["f32"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"),
                "share_of_bound": t["bound_ms"] / t["mean_ms"]["bf16"],
                "share_against": "bound_ms (bf16, 989 TFLOP/s; 3.35 TB/s)",
                "ok": train_ok}

    kernels = [
        row("fused_edge_tail_agg_pregathered_bf16", "fwd", 278,
            counts["fused_edge_pregathered_bf16_fwd"]),
        row("fused_edge_tail_agg_pregathered_bf16_bwd", "bwd", 376,
            counts["fused_edge_pregathered_bf16_bwd"]),
        {**row("segment_sum_bf16", "seg", 79, counts["segment_sum_bf16"]),
         "library": kern["seg"]["timing"]["library"]}]
    fold_2d = kern["fold_2d"]
    return ((0 if train_ok else 31), kernels,
            {"fused_edge_tail_agg_bf16": {
                "launches_cnn2d_bf16": eval_counts["fused_edge_bf16_fwd"]
                + counts["fused_edge_bf16_fwd"],
                "max_abs_err_2d_eval_shape": fold_2d["max_abs_err"],
                "ms_2d_eval_shape": fold_2d["mean_ms"]["bf16"],
                "ms_f32_build_2d_eval_shape": fold_2d["mean_ms"]["f32"],
                "plain_ms_2d_eval_shape": fold_2d["plain_ms"],
                "bound_ms_2d_eval_shape": fold_2d["bound_ms"]}})


def pe_bf16_bound(kernel: str, graph, h, c, l1) -> dict:
    """``bf16_bound`` for the pe entry's bf16 build (#6, #7): its
    operations 2·E·(L1·H² + H·C) at the dense bf16 rate (three times that
    backward), against pe, the node tables and the bf16 weights read at 2
    bytes, ln_s, ln_b, g, out, the indices and d_ln at 4, and backward
    d_pe (bf16) and dz (f32) written per edge."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * (l1 * h * h + h * c)
    weights = l1 * (h * h + h) + h * c + c
    inputs = 2.0 * (e * h + 2 * n * h + weights) + 4.0 * (2 * c + e + n + 1)
    if kernel == "fwd":
        nbytes = inputs + 4.0 * n * c
    elif kernel == "bwd":
        flops *= 3.0
        nbytes = (inputs + 4.0 * n * c + 2.0 * (e * h + n * h + weights)
                  + 4.0 * (e * h + 2 * c))
    else:
        raise ValueError(kernel)
    t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bf16_w128_build(l1: int) -> dict:
    """The width-128 bf16 library's ptxas lines, each kernel's dynamic
    shared memory, and for each entry at depth ``l1`` its backward's cluster
    on this card: CTAs a cluster (one a weight), the clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``) and the SMs they
    take."""
    import ctypes

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    lib = ctypes.CDLL(str(cuda_build.build(fe.BF16_W128)))
    smem = lib.fused_edge_tail_agg_bf16_w128_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    clusters = lib.fused_edge_tail_agg_bf16_w128_bwd_clusters
    clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p]
    clusters.restype = ctypes.c_int
    bwd = {}
    for entry in ("fold", "pe", "pregathered"):
        ctas, active = ctypes.c_int(), ctypes.c_int()
        err = clusters(fe.ENTRY[entry], l1, ctypes.byref(ctas),
                       ctypes.byref(active))
        bwd[entry] = {"ctas_a_cluster": ctas.value,
                      "active_clusters": active.value,
                      "sms_used": ctas.value * active.value,
                      "sms": torch.cuda.get_device_properties(0)
                      .multi_processor_count, "cuda_error": err}
    return {"ptxas": ptxas_lines(cuda_build.build(fe.BF16_W128)),
            "smem_bytes": {"fwd": smem(0), "bwd_cluster_cta": smem(1)},
            "bwd_clusters": bwd}


def bwd128_call(entry, ops_bf, g) -> dict:
    """One call of the width-128 bf16 backward of ``entry`` through its
    launcher on the C entry's operands ``ops_bf``: the kernels the C entry
    launched (its own count, and the port's kernels torch.profiler saw over
    three calls, not PyTorch's fills and casts around them) and the call's
    peak allocation, in (E, 128) bf16 planes (its outputs and partial rows;
    no scratch plane)."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe

    count = ctypes.CDLL(str(cuda_build.build(fe.BF16_W128))) \
        .fused_edge_tail_agg_bf16_w128_bwd_launches
    count.restype = ctypes.c_int
    fe._launch_bf16_w128_bwd(entry, *ops_bf, g)
    torch.cuda.synchronize()
    launches = count()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fe._launch_bf16_w128_bwd(entry, *ops_bf, g)
        torch.cuda.synchronize()
    seen = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "(anonymous namespace)::" in ev.name):
            seen[ev.name[:80]] = seen.get(ev.name[:80], 0) + 1
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fe._launch_bf16_w128_bwd(entry, *ops_bf, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del got
    plane = ops_bf[0].shape[0] * 128 * 2
    return {"launches_per_call": launches,
            "profiled_kernels_in_three_calls": seen,
            "peak_bytes": peak, "plane_bytes": plane,
            "peak_in_planes": peak / plane}


def cluster_ptxas(lines) -> list[str]:
    """ptxas's lines (entry, spills, registers) of the width-128 bf16
    backward's cluster kernel, a group an entry."""
    out, keep = [], False
    for ln in lines:
        if "entry function" in ln:
            keep = "cluster_bwd_kernel" in ln
        if keep:
            out.append(ln)
    return out


def one_edge_graph():
    """E = 1: node 1 sends to node 0; node 2 receives nothing."""
    from magnet_tpu_torch.ops.graph import csr_from_edges

    return csr_from_edges(torch.tensor([1], dtype=torch.int32),
                          torch.tensor([0], dtype=torch.int32), 3)


def gnn_bf16_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``gnn_bf16_kernel``, ``gnn_bf16_kernel_bwd``,
    ``gnn_bf16_slice``, ``gnn_bf16_train``, ``gnn2d_bf16_slice`` and
    ``gnn2d_bf16_train``: MAgNet[GNN]'s bf16 lane (``graph_dtype=bf16``) at
    its published width, its four kernels (the width-128 bf16 builds of #8,
    #9, #6 and #7 in ``csrc/fused_edge_tail_agg_bf16_w128.cu``) against
    their bf16 plain versions and the f32 kernels, then MAgNet[GNN] 1D
    through ``evaluate`` and ``Trainer.fit`` (and the pe lane), and 2D at
    the published 512-node irregular configuration, each on the bf16
    kernels alone and its eval loss against the f32 lane's.  Returns the
    exit code, the four kernels' entries and no launches of another
    group's kernel."""
    from magnet_tpu_torch.config import MAGNET_GNN
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.time_fwd import bind, in_turns
    from magnet_tpu_torch.time_fwd import operands as c_operands
    from magnet_tpu_torch.time_fwd import runner, runner_bf16_w128, to_bf16
    from magnet_tpu_torch.utils import to_device

    hp = {**MAGNET_GNN, "graph_dtype": "bf16"}
    hp2d = {**hp, **GNN2D_HP}
    h, l1 = hp["mlp_hidden"], hp["mlp_layers"] - 1
    mp, ts = hp["num_message_passing_steps"], hp["time_slice"]
    kind2d = "h5_implicit_gnn_2d"
    model = create_model("magnet_gnn", hp, device=dev, seed=0)
    eval_batches = data["gnn_eval"]
    loaders = data["gnn_loaders"]
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    eg = model.build_graph(to_device(eval_batches[0], dev))
    tg = model.build_graph(batch0)
    model2d = create_model("magnet_gnn", hp2d, device=dev, seed=0,
                           kind=kind2d)
    eg2d = model2d.build_graph(to_device(data["gnn2d_eval"][0], dev))
    graphs = {"eval_lr": eg.lr, "eval_all": eg.all, "train_lr": tg.lr,
              "train_all": tg.all, "gnn2d_eval_all": eg2d.all}
    small = gnn_small_graph()
    tiles = tile_edges_graph(fe.FWD_TILE, seed=51)
    fn32 = bind(cuda_build.build(fe.FWD), fe.FWD)
    build = bf16_w128_build(l1)

    def wrapper_ops(entry, ops, graph):
        """The wrapper's operands of the C entry's ``ops``."""
        if entry == "fold":
            return ops
        src, _, _, pxj, pxi, senders, rowptr, *tail = ops
        return (src, pxj, pxi, senders, rowptr, graph.snd_ptr.to(dev),
                graph.snd_perm.to(dev), *tail)

    fns = {"fold": (fe.fused_edge_tail_agg_bf16,
                    fe.fused_edge_tail_agg_bf16_plain,
                    fe.fused_edge_tail_agg, fe.fused_edge_tail_agg_bf16_bwd,
                    fe.fused_edge_tail_agg_bf16_bwd_plain,
                    fe.fused_edge_tail_agg_bwd,
                    fe.fused_edge_tail_agg_bwd_plain, fe.GRAD_NAMES),
           "pe": (fe.fused_edge_tail_agg_pe_bf16,
                  fe.fused_edge_tail_agg_pe_bf16_plain,
                  fe.fused_edge_tail_agg_pe,
                  fe.fused_edge_tail_agg_pe_bf16_bwd,
                  fe.fused_edge_tail_agg_pe_bf16_bwd_plain,
                  fe.fused_edge_tail_agg_pe_bwd,
                  fe.fused_edge_tail_agg_pe_bwd_plain, fe.GRAD_NAMES_PE)}

    def bound_of(kernel, entry, graph):
        return (bf16_bound(kernel, graph, h, h, h, l1) if entry == "fold"
                else pe_bf16_bound(kernel, graph, h, h, l1))

    # gnn_bf16_kernel: the width-128 bf16 #8 and #6 vs their bf16 plain
    # versions and vs the f32 kernels on the unrounded operands (receiver
    # means), at MAgNet[GNN] 1D's eval and training graphs, the 2D eval
    # graph, the small graph (a degree-0 receiver, a receiver over three
    # tiles, L1 = 1) and the forward's tile graph; bit-equal launches; times
    # in turns with the f32 builds
    t_phase = time.perf_counter()
    fwd = {}
    for entry, (fn, plain, fn32_w, *_) in fns.items():
        rows = {}
        cases = [(label, gr, l1) for label, gr in graphs.items()]
        cases += [("small_case", small, GNN_SMALL_L1), ("tile_edges", tiles, l1)]
        for label, gr, l1c in cases:
            ops32 = c_operands(entry, gr, h, h, h, l1c, seed=52, dev=dev)
            ops_bf = to_bf16(ops32)
            wops_bf = wrapper_ops(entry, ops_bf, gr)
            got = fn(*wops_bf)
            torch.cuda.synchronize()
            res = compare_bf16(got, plain(*wops_bf))
            deg = gr.degree.to(dev).clamp_min(1.0)[:, None]
            got32 = fn32_w(*wrapper_ops(entry, ops32, gr))
            res["vs_f32_kernel"] = compare(got / deg, got32 / deg,
                                           BF16_VS_F32_RTOL, BF16_VS_F32_ATOL)
            res["vs_f32_kernel"]["sums_max_abs_err"] = float(
                (got - got32).abs().max())
            zero = gr.degree.to(dev) == 0
            res.update(n_node=gr.n_node, n_edge=gr.n_edge, l1=l1c,
                       lane=gr.lane, max_degree=int(gr.degree.max()),
                       n_degree0=int(zero.sum()),
                       degree0_rows_zero=bool((got[zero] == 0).all()))
            if label in ("eval_all", "train_all"):
                order, times, mean = in_turns(
                    {"f32": runner(fn32, entry, ops32, (h, h, h)),
                     "bf16": runner_bf16_w128(entry, ops_bf)},
                    first="f32", then="bf16")
                res["timing"] = {
                    "order": order, "ms": times, "mean_ms": mean,
                    "plain_ms": cuda_ms(lambda: plain(*wops_bf), reps=10),
                    **bound_of("fwd", entry, gr)}
            if label == "eval_all":
                res["bits_equal_run_to_run"] = torch.equal(fn(*wops_bf),
                                                           fn(*wops_bf))
            rows[label] = res
            del ops32, ops_bf, wops_bf, got, got32
        fwd[entry] = rows
    # the wgmma kernels at L1 = 0..3 on the small, E = 1 and tile graphs
    # and at the eval and training LR ∪ HR graphs
    wgmma_fwd = {entry: fwd_bf16_checks(
        entry, 128, dev, seed=440 + 10 * i,
        paths=(("eval_all", eg.all), ("train_all", tg.all)))
        for i, entry in enumerate(("fold", "pe"))}
    fwd_ok = all(r["ok"] and r["vs_f32_kernel"]["ok"] and r["degree0_rows_zero"]
                 and r.get("bits_equal_run_to_run", True)
                 for rows in fwd.values() for r in rows.values()) and all(
        gr.lane == "fold" for gr in graphs.values()) and all(
        r["ok"] for r in wgmma_fwd.values())
    emit({"phase": "gnn_bf16_kernel", "ce": h, "h": h, "c": h, "l1": l1,
          "small_case_l1": GNN_SMALL_L1,
          "tolerance": {"vs_plain": {"rtol": BF16_RTOL, "atol": BF16_ATOL,
                                     "max_rel_l2": BF16_L2},
                        "vs_f32_kernel": {"rtol": BF16_VS_F32_RTOL,
                                          "atol": BF16_VS_F32_ATOL,
                                          "of": "receiver means"}},
          "fold_bf16_w128": fwd["fold"], "pe_bf16": fwd["pe"],
          "library_ms": None, **build, "wgmma_fwd_checks": wgmma_fwd,
          "wgmma_fwd_ptxas": fwd_bf16_ptxas(128),
          "seconds": time.perf_counter() - t_phase, "ok": fwd_ok})
    if not fwd_ok:
        return 34, [], {}

    # gnn_bf16_kernel_bwd: the width-128 bf16 #9 and #7 (+ the f32 #1 for
    # the pe entry's d_pxj) vs their bf16 plain versions, every gradient in
    # its operand's dtype, and vs the f32 kernels, at the training graphs (g
    # zero on the receivers of relu ties, counted), the small graph, the
    # tile graph, a tile graph of more tiles than the backward's clusters
    # (ties guarded as at the training graphs) and E = 1; bit-equal
    # launches; times in turns with the f32 builds; the backward's launches
    # a call and peak allocation
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(53)
    cluster_tiles, cluster_tiles_info = bwd_tile_edges(
        torch.cuda.get_device_properties(0).multi_processor_count, seed=55)
    one = one_edge_graph()
    bwd, calls = {}, {}
    for entry, (*_, fn_bwd, plain_bwd, fn32_bwd, plain32_bwd,
                names) in fns.items():
        rows = {}
        for label, gr, l1c in (("train_all", tg.all, l1),
                               ("train_lr", tg.lr, l1),
                               ("small_case", small, GNN_SMALL_L1),
                               ("tile_edges", tiles, l1),
                               ("tile_edges_clusters", cluster_tiles, l1),
                               ("one_edge", one, l1)):
            ops32 = c_operands(entry, gr, h, h, h, l1c, seed=54, dev=dev)
            ops_bf = to_bf16(ops32)
            wops32 = wrapper_ops(entry, ops32, gr)
            wops_bf = wrapper_ops(entry, ops_bf, gr)
            g = torch.randn(gr.n_node, h, generator=gen).to(dev)
            res = {}
            if label.startswith("train") or label == "tile_edges_clusters":
                ties = tie_receivers_bf16(wops_bf, l1c, entry)
                g[ties] = 0.0
                res["tie_receivers_zeroed"] = int(ties.numel())
            got = fn_bwd(*wops_bf, g)
            torch.cuda.synchronize()
            want = plain_bwd(*wops_bf, g)
            want32 = fn32_bwd(*wops32, g)
            plain32 = plain32_bwd(*wops32, g)
            deep = l1c > BF16_VS_F32_DEPTH
            for name, a, b, b32, p32 in zip(names, got, want, want32,
                                            plain32):
                res[name] = compare_grad(a, b, elementwise=False,
                                         rtol=BF16_RTOL,
                                         atol_rel=BF16_BWD_ATOL_REL,
                                         max_l2=BF16_BWD_L2)
                if b32.numel():
                    l2, l2_plain = rel_l2(a, b32), rel_l2(b, p32)
                    res[name].update(
                        vs_f32_kernel_rel_l2=l2,
                        plain_bf16_vs_plain_f32_rel_l2=l2_plain,
                        vs_f32_ok=l2 < BF16_VS_F32_GRAD_L2 or (
                            deep and l2 <= BF16_VS_F32_DEEP * l2_plain))
            res["dtypes_ok"] = ([a.dtype for a in got]
                                == [b.dtype for b in want])
            res["vs_f32_kernel_ok"] = all(
                v.get("vs_f32_ok", True) for v in res.values()
                if isinstance(v, dict))
            zero = gr.degree.to(dev) == 0
            res["degree0_rows_zero"] = bool(
                (got[names.index("pxi")][zero] == 0).all())
            res.update(n_node=gr.n_node, n_edge=gr.n_edge, l1=l1c)
            if label == "train_all":
                res["bits_equal_run_to_run"] = bits_equal_bwd(
                    fn_bwd, wops_bf, g, names)
                calls[entry] = bwd128_call(entry, ops_bf, g)
                order, times, mean = in_turns(
                    {"f32": lambda: fe._launch_bwd(entry, *ops32, g),
                     "bf16": lambda: fe._launch_bf16_w128_bwd(entry, *ops_bf,
                                                              g)},
                    first="f32", then="bf16")
                res["timing"] = {
                    "order": order, "ms": times, "mean_ms": mean,
                    "of": "the kernels' launch sequences (pe: #7 without #1)",
                    "with_segment_sum_ms": (cuda_ms(
                        lambda: fn_bwd(*wops_bf, g), reps=10)
                        if entry == "pe" else None),
                    "plain_ms": cuda_ms(lambda: plain_bwd(*wops_bf, g),
                                        reps=5),
                    **bound_of("bwd", entry, gr)}
            rows[label] = res
            del ops32, ops_bf, wops32, wops_bf, got, want, want32, plain32
        bwd[entry] = rows
    bwd_ok = all(
        all(v["ok"] for v in r.values() if isinstance(v, dict) and "ok" in v)
        and r["dtypes_ok"] and r["vs_f32_kernel_ok"] and r["degree0_rows_zero"]
        and r.get("bits_equal_run_to_run", {"ok": True})["ok"]
        for rows in bwd.values() for r in rows.values()) and all(
        c["launches_per_call"] <= 3 for c in calls.values())
    emit({"phase": "gnn_bf16_kernel_bwd", "l1": l1,
          "tile_edges_clusters_graph": cluster_tiles_info,
          "bwd_clusters": build["bwd_clusters"],
          "bwd_ptxas": cluster_ptxas(build["ptxas"]),
          "bwd_calls_at_train_all": calls,
          "tolerance": {"vs_plain": {"max_rel_l2": BF16_BWD_L2,
                                     "counted_outside": {
                                         "rtol": BF16_RTOL,
                                         "atol_rel_to_max": BF16_BWD_ATOL_REL}},
                        "vs_f32_kernel_max_rel_l2": BF16_VS_F32_GRAD_L2,
                        "vs_f32_kernel_deeper_than_l1": BF16_VS_F32_DEPTH,
                        "vs_f32_kernel_deep_times_plain": BF16_VS_F32_DEEP},
          "fold_bf16_w128": bwd["fold"], "pe_bf16": bwd["pe"],
          "library_ms": None, "seconds": time.perf_counter() - t_phase,
          "ok": bwd_ok})
    if not bwd_ok:
        return 35, [], {}

    def eval_lane(m, batches, impl, expect):
        """``evaluate`` of ``m`` on ``batches`` on lane ``impl``, its
        launches (every counter 0 but ``expect``'s) and times."""
        m.impl = impl
        reset_every_launch()
        t0 = time.perf_counter()
        metrics, preds = evaluate(m, batches, dev, return_predictions=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = every_launch()
        m.impl = "kernel"
        finite = (all(bool(torch.isfinite(p).all()) for p in preds)
                  and all(np.isfinite(v) for v in metrics.values()))
        return {"metrics": metrics, "launches": counts,
                "expected_launches": {k: expect.get(k, 0) for k in counts},
                "finite": finite, "seconds_per_batch_first":
                first_s / len(batches),
                "shapes": [list(p.shape) for p in preds[:1]]}

    def eval_vs_f32(m, m32, batches):
        """The bf16 model's eval on ``batches`` (its launches counted)
        against the f32 model's: loss within BF16_LOSS_RTOL, seconds per
        batch of each in turns."""
        n_win = (batches[0]["t"].shape[1] - m.time_slice) // m.time_slice
        want = n_win * 2 * mp * len(batches)
        lane = eval_lane(m, batches, "kernel",
                         {"fused_edge_fold128_bf16_fwd": want})
        metrics32 = evaluate(m32, batches, dev)
        order = ["f32", "bf16", "bf16", "f32"]
        secs = [timed(lambda: evaluate(m32 if o == "f32" else m, batches,
                                       dev)) / len(batches) for o in order]
        loss_rel = (abs(lane["metrics"]["test_loss"] - metrics32["test_loss"])
                    / abs(metrics32["test_loss"]))
        lane.update(metrics_f32=metrics32, loss_rel_err_vs_f32=loss_rel,
                    loss_rtol_vs_f32=BF16_LOSS_RTOL,
                    launches_per_batch=n_win * 2 * mp,
                    seconds_per_batch_in_turns={"order": order,
                                                "seconds": secs},
                    ok=(lane["launches"] == lane["expected_launches"]
                        and lane["finite"] and loss_rel <= BF16_LOSS_RTOL))
        return lane

    # gnn_bf16_slice: evaluate() on the 16 Heat trajectories on the bf16
    # fold kernels alone (90 launches a batch), its eval loss against the
    # f32 lane's; then the batch on the pe lane's bf16 kernels
    t_phase = time.perf_counter()
    model32 = create_model("magnet_gnn", MAGNET_GNN, device=dev, seed=0)
    slice_1d = eval_vs_f32(model, model32, eval_batches)
    n_win = (eval_batches[0]["t"].shape[1] - ts) // ts
    pe_lane = eval_lane(model, eval_batches[:1], "kernel_pe",
                        {"fused_edge_pe_bf16_fwd": n_win * 2 * mp})
    pe_lane["loss_rel_err_vs_fold_lane"] = (
        abs(pe_lane["metrics"]["test_loss"]
            - slice_1d["metrics"]["test_loss"])
        / abs(slice_1d["metrics"]["test_loss"]))
    pe_lane["ok"] = (pe_lane["launches"] == pe_lane["expected_launches"]
                     and pe_lane["finite"]
                     and pe_lane["loss_rel_err_vs_fold_lane"] <= BF16_LOSS_RTOL)
    del model32
    slice_ok = slice_1d["ok"] and pe_lane["ok"]
    emit({"phase": "gnn_bf16_slice", "model": "magnet_gnn",
          "graph_dtype": "bf16", "batches": len(eval_batches),
          "batch_size": GNN_EVAL_TRAJ,
          "eval_lr_graph": {"n_node": eg.lr.n_node, "n_edge": eg.lr.n_edge},
          "eval_all_graph": {"n_node": eg.all.n_node,
                             "n_edge": eg.all.n_edge},
          "fold_lane": slice_1d, "pe_lane": pe_lane,
          "seconds": time.perf_counter() - t_phase, "ok": slice_ok})
    if not slice_ok:
        return 36, [], {}
    eval_launches = (slice_1d["launches"]["fused_edge_fold128_bf16_fwd"],
                     pe_lane["launches"]["fused_edge_pe_bf16_fwd"])

    def fit_bf16(new_model, hp_, loaders_, per_step):
        """``fit_checkpoint_resume`` over two epochs on the bf16 fold
        kernels alone, its launches checked; the first step's loss and
        gradients on the kernels against the plain versions; seconds a step
        beside the f32 lane's, in turns."""
        tmodel = new_model(hp_)
        loaders_["train"].set_epoch(0)
        b0 = to_device(next(iter(loaders_["train"])), dev)
        g0 = tmodel.build_graph(b0)
        plain = gnn_loss_and_grads(tmodel, "plain", b0, g0)
        step_vs_plain = gnn_vs_plain(tmodel, "kernel", plain, b0, g0)
        del tmodel
        n_epochs, steps = 2, len(loaders_["train"])
        val_batches = len(loaders_["val"])
        fit, resumed = fit_checkpoint_resume(
            lambda: new_model(hp_), hp_, loaders_, dev, n_epochs,
            reset_every_launch, every_launch)
        counts = fit.pop("launches")
        want = {k: 0 for k in counts}
        want["fused_edge_fold128_bf16_fwd"] = per_step * (
            steps * n_epochs + val_batches * n_epochs)
        want["fused_edge_fold128_bf16_bwd"] = per_step * steps * n_epochs
        host_batches = [to_device(b, dev) for b in loaders_["train"]]
        with tempfile.TemporaryDirectory() as workdir:
            from magnet_tpu_torch.train.trainer import Trainer

            f32_hp = {k: v for k, v in hp_.items() if k != "graph_dtype"}
            trainer32 = Trainer(new_model(f32_hp), max_epochs=1,
                                lr=hp_["lr"], weight_decay=hp_["weight_decay"],
                                factor=hp_["factor"],
                                step_size=hp_["step_size"], device=dev,
                                workdir=workdir)
            trainer32.setup(steps)
            trainer32.train_step(host_batches[0])
            order = ["f32", "bf16", "bf16", "f32"]
            secs = [timed(lambda: [(trainer32 if o == "f32" else resumed)
                                   .train_step(b) for b in host_batches])
                    / steps for o in order]
            del trainer32
        bf16_step(step_vs_plain)
        ok = (counts == want and fit["losses_finite"] and step_vs_plain["ok"]
              and fit["checkpoint_ok"] and fit["resume_ok"])
        return {"launches": counts, "expected_launches": want,
                "launches_per_train_step": per_step, **fit,
                "loss_falls": falls(fit["epoch_train_losses"]),
                "step_vs_plain": step_vs_plain,
                "seconds_per_step_in_turns": {"order": order,
                                              "seconds": secs},
                "ok": ok}

    # gnn_bf16_train: Trainer.fit on the KS data through the GNN
    # datamodule on the bf16 fold kernels alone (40 + 40 launches a step),
    # checkpoint read back, resume; then one step on the pe lane's bf16
    # kernels (40 each of #6, #7 and of the f32 #1 for d_pxj)
    t_phase = time.perf_counter()
    nt_train = loaders["train"].dataset.data["t"].shape[1]
    per_step = ((nt_train - ts) // ts) * 2 * mp

    def new_1d(params):
        return create_model("magnet_gnn", params, device=dev, seed=0)

    train_1d = fit_bf16(new_1d, hp, loaders, per_step)
    tmodel = new_1d(hp)
    plain = gnn_loss_and_grads(tmodel, "plain", batch0, tg)
    reset_every_launch()
    cmp_pe = gnn_vs_plain(tmodel, "kernel_pe", plain, batch0, tg)
    cmp_pe["launches"] = every_launch()
    cmp_pe["expected_launches"] = {
        k: per_step if k in ("fused_edge_pe_bf16_fwd", "fused_edge_pe_bf16_bwd",
                             "segment_sum") else 0
        for k in cmp_pe["launches"]}
    cmp_pe["ok"] = (bf16_step(cmp_pe)
                    and cmp_pe["launches"] == cmp_pe["expected_launches"])
    del tmodel, plain
    train_ok = train_1d["ok"] and cmp_pe["ok"]
    emit({"phase": "gnn_bf16_train", "model": "magnet_gnn",
          "graph_dtype": "bf16", "batch_size": loaders["train"].batch_size,
          "nt": nt_train,
          "train_all_graph": {"n_node": tg.all.n_node,
                              "n_edge": tg.all.n_edge},
          **train_1d, "pe_lane_step": cmp_pe,
          "seconds": time.perf_counter() - t_phase, "ok": train_ok})
    if not train_ok:
        return 37, [], {}

    # gnn2d_bf16_slice / gnn2d_bf16_train: MAgNet[GNN] 2D at the published
    # 512-node irregular configuration: one eval batch of the regular 32 x
    # 32 test grid against the f32 lane, then Trainer.fit on the irregular
    # split (one step an epoch), each on the bf16 fold kernels alone
    t_phase = time.perf_counter()
    model2d32 = create_model("magnet_gnn", {**MAGNET_GNN, **GNN2D_HP},
                             device=dev, seed=0, kind=kind2d)
    slice_2d = eval_vs_f32(model2d, model2d32, data["gnn2d_eval"][:1])
    del model2d32
    emit({"phase": "gnn2d_bf16_slice", "model": "magnet_gnn", "pos_dim": 2,
          "graph_dtype": "bf16",
          "eval_all_graph": {"n_node": eg2d.all.n_node,
                             "n_edge": eg2d.all.n_edge},
          **slice_2d, "seconds": time.perf_counter() - t_phase,
          "ok": slice_2d["ok"]})
    if not slice_2d["ok"]:
        return 38, [], {}
    t_phase = time.perf_counter()
    loaders2d = data["gnn2d_loaders"]
    nt2d = loaders2d["train"].dataset.data["t"].shape[1]
    per_step_2d = ((nt2d - hp2d["time_slice"]) // hp2d["time_slice"]) * 2 * mp

    def new_2d(params):
        return create_model("magnet_gnn", params, device=dev, seed=0,
                            kind=kind2d)

    train_2d = fit_bf16(new_2d, hp2d, loaders2d, per_step_2d)
    emit({"phase": "gnn2d_bf16_train", "model": "magnet_gnn", "pos_dim": 2,
          "graph_dtype": "bf16",
          "batch_size": loaders2d["train"].batch_size, **train_2d,
          "seconds": time.perf_counter() - t_phase, "ok": train_2d["ok"]})
    if not train_2d["ok"]:
        return 39, [], {}

    def row(name, entry, direction, replaces, launches, found, timing):
        return {
            "name": name, "route": "cuda",
            "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bf16_w128.cu",
            "entry": entry, "widths": [h, h, h] if entry == "fold" else [h, h],
            "replaces": f"magnet_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": launches, "max_abs_err": worst(found),
            "ms": timing["mean_ms"]["bf16"],
            "ms_f32_build_in_turns": timing["mean_ms"]["f32"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "share_of_bound": timing["bound_ms"] / timing["mean_ms"]["bf16"],
            "share_against": "bound_ms (bf16, 989 TFLOP/s)",
            "shape": ("eval LR ∪ HR graph" if direction == "fwd"
                      else "training LR ∪ HR graph"), "ok": True}

    fold_fwd = (eval_launches[0]
                + train_1d["launches"]["fused_edge_fold128_bf16_fwd"]
                + slice_2d["launches"]["fused_edge_fold128_bf16_fwd"]
                + train_2d["launches"]["fused_edge_fold128_bf16_fwd"])
    fold_bwd = (train_1d["launches"]["fused_edge_fold128_bf16_bwd"]
                + train_2d["launches"]["fused_edge_fold128_bf16_bwd"])
    kernels = [
        row("fused_edge_tail_agg_bf16_w128", "fold", "fwd", 1356, fold_fwd,
            fwd["fold"], fwd["fold"]["eval_all"]["timing"]),
        row("fused_edge_tail_agg_bf16_w128_bwd", "fold", "bwd", 1665,
            fold_bwd, bwd["fold"], bwd["fold"]["train_all"]["timing"]),
        row("fused_edge_tail_agg_pe_bf16", "pe", "fwd", 929,
            eval_launches[1] + cmp_pe["launches"]["fused_edge_pe_bf16_fwd"],
            fwd["pe"], fwd["pe"]["eval_all"]["timing"]),
        row("fused_edge_tail_agg_pe_bf16_bwd", "pe", "bwd", 1046,
            cmp_pe["launches"]["fused_edge_pe_bf16_bwd"], bwd["pe"],
            bwd["pe"]["train_all"]["timing"])]
    return 0, kernels, {
        "segment_sum": {"launches_gnn_bf16": cmp_pe["launches"]["segment_sum"]}}


def gnn_pre_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``gnn_pre_kernel``, ``gnn_pre_kernel_bwd``, ``gnn_pre_slice``,
    ``gnn_pre_train`` and ``gnn_pre_c6``: MAgNet[GNN]'s pre-gathered lane
    (``impl="kernel_pregathered"``, the JAX package's lane under
    ``MAGNET_TPU_NO_FUSED2``) at its published width, in f32 and bf16.  Its
    kernels (#2 and #3 at (H, C) = (128, 128): the f32 builds of
    ``csrc/fused_edge_tail_agg.cu`` / ``fused_edge_tail_agg_bwd.cu`` and the
    bf16 builds of ``csrc/fused_edge_tail_agg_bf16_w128.cu``) against their
    plain versions and each other; MAgNet[GNN] 1D and 2D through
    ``evaluate`` and ``Trainer.fit`` on that lane alone (#2, #3 and the
    sender gather's #1), its eval loss against the fold lane's and its
    seconds a batch and a step in turns with the fold lane's; and one
    MAgNet[CNN] 2D training step on ``impl="kernel_pe"`` at its training
    graph, which has no sender-tile layout, so that the pe lane rule sends
    it to the pre-gathered (64, 32) builds, as the JAX step under
    ``MAGNET_TPU_NO_FUSED2R`` goes.  Returns the exit code, the four
    width-128 kernels' entries and the launches of the other groups'
    kernels (#1, and #2/#3 at width 64) on these paths."""
    from magnet_tpu_torch.config import (
        DATAMODULE_IMPLICIT_2D,
        MAGNET_CNN_2D,
        MAGNET_GNN,
    )
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.time_fwd import bind, in_turns
    from magnet_tpu_torch.time_fwd import operands as c_operands
    from magnet_tpu_torch.time_fwd import runner, runner_bf16_w128, to_bf16
    from magnet_tpu_torch.utils import to_device

    hp32 = dict(MAGNET_GNN)
    h, l1 = hp32["mlp_hidden"], hp32["mlp_layers"] - 1
    mp, ts = hp32["num_message_passing_steps"], hp32["time_slice"]
    hps = {"f32": hp32, "bf16": {**hp32, "graph_dtype": "bf16"}}
    kind2d = "h5_implicit_gnn_2d"
    eval_batches = data["gnn_eval"][:1]
    loaders = data["gnn_pre_loaders"]
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    model = create_model("magnet_gnn", hp32, device=dev, seed=0)
    eg = model.build_graph(to_device(eval_batches[0], dev))
    tg = model.build_graph(batch0)
    del model
    small = gnn_small_graph()
    tiles = tile_edges_graph(fe.FWD_TILE, seed=61)
    fn32 = bind(cuda_build.build(fe.FWD), fe.FWD)
    build = bf16_w128_build(l1)
    # every MAgNet[GNN] graph has both sender layouts: the JAX package sums
    # the sender gather's cotangent in f32 there, as the port's #1 does
    layouts_ok = all(gr.layout.snd2 and gr.layout.snd_transpose
                     for gr in (eg.lr, eg.all, tg.lr, tg.all))
    ts_of = {1: ts, 2: GNN2D_HP["time_slice"]}

    def wrapper_ops(ops):
        """The pregathered wrapper's operands of the C entry's ``ops``."""
        return (ops[0], ops[4], ops[6], *ops[7:])

    # gnn_pre_kernel: bf16 #2 at (128, 128) vs its bf16 plain version and
    # vs the f32 #2 at width 128 on the unrounded operands (receiver
    # means), the f32 #2 vs its plain version, at MAgNet[GNN] 1D's eval and
    # training LR ∪ HR graphs, the small graph (a degree-0 receiver, a
    # receiver over three tiles, L1 = 1) and the forward's tile graph;
    # bit-equal launches; times in turns with the f32 build
    t_phase = time.perf_counter()
    fwd = {}
    for label, gr, l1c in (("eval_all", eg.all, l1), ("train_all", tg.all, l1),
                           ("small_case", small, GNN_SMALL_L1),
                           ("tile_edges", tiles, l1)):
        ops32 = c_operands("pregathered", gr, h, h, h, l1c, seed=62, dev=dev)
        ops_bf = to_bf16(ops32)
        w32, wbf = wrapper_ops(ops32), wrapper_ops(ops_bf)
        got = fe.fused_edge_tail_agg_pregathered_bf16(*wbf)
        torch.cuda.synchronize()
        res = compare_bf16(got, fe.fused_edge_tail_agg_pregathered_bf16_plain(
            *wbf))
        got32 = fe.fused_edge_tail_agg_pregathered(*w32)
        res["f32_vs_plain"] = compare(
            got32, fe.fused_edge_tail_agg_pregathered_plain(*w32),
            KERNEL_RTOL, KERNEL_ATOL)
        deg = gr.degree.to(dev).clamp_min(1.0)[:, None]
        res["vs_f32_kernel"] = compare(got / deg, got32 / deg,
                                       BF16_VS_F32_RTOL, BF16_VS_F32_ATOL)
        res["vs_f32_kernel"]["sums_max_abs_err"] = float(
            (got - got32).abs().max())
        zero = gr.degree.to(dev) == 0
        res.update(n_node=gr.n_node, n_edge=gr.n_edge, l1=l1c,
                   max_degree=int(gr.degree.max()),
                   n_degree0=int(zero.sum()),
                   degree0_rows_zero=bool((got[zero] == 0).all()
                                          and (got32[zero] == 0).all()))
        if label == "eval_all":
            order, times, mean = in_turns(
                {"f32": runner(fn32, "pregathered", ops32, (h, h, h)),
                 "bf16": runner_bf16_w128("pregathered", ops_bf)},
                first="f32", then="bf16")
            b32 = pregathered_bound("fwd", gr, h, h, l1)
            res["timing"] = {
                "order": order, "ms": times, "mean_ms": mean,
                "plain_ms": cuda_ms(lambda: fe.
                                    fused_edge_tail_agg_pregathered_bf16_plain(
                                        *wbf), reps=10),
                "f32_plain_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pregathered_plain(*w32),
                    reps=10),
                **pregathered_bf16_bound("fwd", gr, h, h, l1),
                "f32_bound": {**b32, **tc_bound(b32)}}
            res["bits_equal_run_to_run"] = (
                torch.equal(fe.fused_edge_tail_agg_pregathered_bf16(*wbf),
                            fe.fused_edge_tail_agg_pregathered_bf16(*wbf))
                and torch.equal(fe.fused_edge_tail_agg_pregathered(*w32),
                                fe.fused_edge_tail_agg_pregathered(*w32)))
        fwd[label] = res
        del ops32, ops_bf, w32, wbf, got, got32
    # the wgmma kernel at L1 = 0..3 on the small, E = 1 and tile graphs and
    # at the eval and training LR ∪ HR graphs
    wgmma_fwd = fwd_bf16_checks("pregathered", 128, dev, seed=470, paths=(
        ("eval_all", eg.all), ("train_all", tg.all)))
    fwd_ok = layouts_ok and wgmma_fwd["ok"] and all(
        r["ok"] and r["f32_vs_plain"]["ok"] and r["vs_f32_kernel"]["ok"]
        and r["degree0_rows_zero"] and r.get("bits_equal_run_to_run", True)
        for r in fwd.values())
    emit({"phase": "gnn_pre_kernel", "h": h, "c": h, "l1": l1,
          "small_case_l1": GNN_SMALL_L1, "layouts_ok": layouts_ok,
          "tolerance": {"vs_plain": {"rtol": BF16_RTOL, "atol": BF16_ATOL,
                                     "max_rel_l2": BF16_L2},
                        "f32_vs_plain": {"rtol": KERNEL_RTOL,
                                         "atol": KERNEL_ATOL},
                        "vs_f32_kernel": {"rtol": BF16_VS_F32_RTOL,
                                          "atol": BF16_VS_F32_ATOL,
                                          "of": "receiver means"}},
          "pregathered_bf16_w128": fwd, "library_ms": None, **build,
          "wgmma_fwd_checks": wgmma_fwd,
          "wgmma_fwd_ptxas": fwd_bf16_ptxas(128),
          "seconds": time.perf_counter() - t_phase, "ok": fwd_ok})
    if not fwd_ok:
        return 41, [], {}

    # gnn_pre_kernel_bwd: bf16 #3 at (128, 128) vs its bf16 plain version,
    # every gradient in its operand's dtype, and vs the f32 #3 at width
    # 128, the f32 #3 vs its plain version, at the training LR ∪ HR and LR
    # graphs (g zero on the receivers of relu ties of either recompute,
    # counted), the small graph, the tile graph, a tile graph of more tiles
    # than the bf16 backward's clusters (ties guarded as at the training
    # graphs) and E = 1; bit-equal launches; times in turns with the f32
    # build; the bf16 backward's launches a call and peak allocation
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(63)
    names = fe.GRAD_NAMES_PREGATHERED
    cluster_tiles, cluster_tiles_info = bwd_tile_edges(
        torch.cuda.get_device_properties(0).multi_processor_count, seed=65)
    bwd, calls = {}, {}
    for label, gr, l1c in (("train_all", tg.all, l1), ("train_lr", tg.lr, l1),
                           ("small_case", small, GNN_SMALL_L1),
                           ("tile_edges", tiles, l1),
                           ("tile_edges_clusters", cluster_tiles, l1),
                           ("one_edge", one_edge_graph(), l1)):
        ops32 = c_operands("pregathered", gr, h, h, h, l1c, seed=64, dev=dev)
        ops_bf = to_bf16(ops32)
        w32, wbf = wrapper_ops(ops32), wrapper_ops(ops_bf)
        g = torch.randn(gr.n_node, h, generator=gen).to(dev)
        res = {}
        guarded = label.startswith("train") or label == "tile_edges_clusters"
        if guarded:
            ties = torch.unique(torch.cat([
                tie_receivers_bf16(wbf, l1c, "pregathered"),
                tie_receivers("pregathered", w32, l1c)]))
            g[ties] = 0.0
            res["tie_receivers_zeroed"] = int(ties.numel())
        got = fe.fused_edge_tail_agg_pregathered_bf16_bwd(*wbf, g)
        torch.cuda.synchronize()
        want = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(*wbf, g)
        got32 = fe.fused_edge_tail_agg_pregathered_bwd(*w32, g)
        plain32 = fe.fused_edge_tail_agg_pregathered_bwd_plain(*w32, g)
        elementwise32 = not guarded
        deep = l1c > BF16_VS_F32_DEPTH
        for name, a, b, a32, p32 in zip(names, got, want, got32, plain32):
            res[name] = compare_grad(a, b, elementwise=False, rtol=BF16_RTOL,
                                     atol_rel=BF16_BWD_ATOL_REL,
                                     max_l2=BF16_BWD_L2)
            res[name]["f32_vs_plain"] = compare_grad(
                a32, p32, elementwise=elementwise32)
            if a32.numel():
                l2, l2_plain = rel_l2(a, a32), rel_l2(b, p32)
                res[name].update(
                    vs_f32_kernel_rel_l2=l2,
                    plain_bf16_vs_plain_f32_rel_l2=l2_plain,
                    vs_f32_ok=l2 < BF16_VS_F32_GRAD_L2 or (
                        deep and l2 <= BF16_VS_F32_DEEP * l2_plain))
        res["dtypes_ok"] = [a.dtype for a in got] == [b.dtype for b in want]
        res["vs_f32_kernel_ok"] = all(
            v.get("vs_f32_ok", True) for v in res.values()
            if isinstance(v, dict))
        res["f32_vs_plain_ok"] = all(
            v["f32_vs_plain"]["ok"] for v in res.values()
            if isinstance(v, dict))
        zero = gr.degree.to(dev) == 0
        res["degree0_rows_zero"] = bool(
            (got[1][zero] == 0).all() and (got32[1][zero] == 0).all())
        res.update(n_node=gr.n_node, n_edge=gr.n_edge, l1=l1c)
        if label == "train_all":
            res["bits_equal_run_to_run"] = (
                bits_equal_bwd(fe.fused_edge_tail_agg_pregathered_bf16_bwd,
                               wbf, g, names)["ok"]
                and bits_equal_bwd(fe.fused_edge_tail_agg_pregathered_bwd,
                                   w32, g, names)["ok"])
            calls["pregathered"] = bwd128_call("pregathered", ops_bf, g)
            order, times, mean = in_turns(
                {"f32": lambda: fe._launch_bwd("pregathered", *ops32, g),
                 "bf16": lambda: fe._launch_bf16_w128_bwd("pregathered",
                                                          *ops_bf, g)},
                first="f32", then="bf16")
            b32 = pregathered_bound("bwd", gr, h, h, l1)
            res["timing"] = {
                "order": order, "ms": times, "mean_ms": mean,
                "of": "the kernels' launch sequences",
                "plain_ms": cuda_ms(lambda: fe.
                                    fused_edge_tail_agg_pregathered_bf16_bwd_plain(
                                        *wbf, g), reps=5),
                "f32_plain_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pregathered_bwd_plain(
                        *w32, g), reps=5),
                **pregathered_bf16_bound("bwd", gr, h, h, l1),
                "f32_bound": {**b32, **tc_bound(b32)}}
        bwd[label] = res
        del ops32, ops_bf, w32, wbf, got, want, got32, plain32
    bwd_ok = all(
        all(v["ok"] for v in r.values() if isinstance(v, dict) and "ok" in v)
        and r["dtypes_ok"] and r["vs_f32_kernel_ok"] and r["f32_vs_plain_ok"]
        and r["degree0_rows_zero"] and r.get("bits_equal_run_to_run", True)
        for r in bwd.values()) and all(
        c["launches_per_call"] <= 3 for c in calls.values())
    emit({"phase": "gnn_pre_kernel_bwd", "l1": l1,
          "tile_edges_clusters_graph": cluster_tiles_info,
          "bwd_clusters": build["bwd_clusters"],
          "bwd_ptxas": cluster_ptxas(build["ptxas"]),
          "bwd_calls_at_train_all": calls,
          "tolerance": {"vs_plain": {"max_rel_l2": BF16_BWD_L2,
                                     "counted_outside": {
                                         "rtol": BF16_RTOL,
                                         "atol_rel_to_max": BF16_BWD_ATOL_REL}},
                        "f32_vs_plain": {
                            "rtol": BWD_RTOL, "atol_rel_to_max": BWD_ATOL_REL,
                            "max_rel_l2": BWD_L2,
                            "elementwise": "small and tile graphs"},
                        "vs_f32_kernel_max_rel_l2": BF16_VS_F32_GRAD_L2,
                        "vs_f32_kernel_deeper_than_l1": BF16_VS_F32_DEPTH,
                        "vs_f32_kernel_deep_times_plain": BF16_VS_F32_DEEP},
          "pregathered_bf16_w128": bwd, "library_ms": None,
          "seconds": time.perf_counter() - t_phase, "ok": bwd_ok})
    if not bwd_ok:
        return 42, [], {}

    counters = {"f32": ("fused_edge_pregathered128_fwd",
                        "fused_edge_pregathered128_bwd", "segment_sum"),
                "bf16": ("fused_edge_pregathered128_bf16_fwd",
                         "fused_edge_pregathered128_bf16_bwd",
                         "segment_sum_bf16")}
    loss_rtol = {"f32": 1e-5, "bf16": BF16_LOSS_RTOL}

    def new_model(dtype, pos_dim, impl="kernel_pregathered"):
        params = {**hps[dtype], **(GNN2D_HP if pos_dim == 2 else {})}
        m = create_model("magnet_gnn", params, device=dev, seed=0,
                         **({"kind": kind2d} if pos_dim == 2 else {}))
        m.impl = impl
        return m

    def eval_pre(dtype, pos_dim, batches):
        """``evaluate`` on the pre-gathered lane (#2 alone), its eval loss
        against the fold lane's, seconds a batch in turns with it."""
        m = new_model(dtype, pos_dim)
        fwd_key = counters[dtype][0]
        n_win = (batches[0]["t"].shape[1] - m.time_slice) // m.time_slice
        reset_every_launch()
        metrics, preds = evaluate(m, batches, dev, return_predictions=True)
        torch.cuda.synchronize()
        counts = every_launch()
        want = {k: n_win * 2 * mp * len(batches) if k == fwd_key else 0
                for k in counts}
        m.impl = "kernel"
        metrics_fold = evaluate(m, batches, dev)
        order = ["fold", "pregathered", "pregathered", "fold"]
        secs = []
        for o in order:
            m.impl = "kernel" if o == "fold" else "kernel_pregathered"
            secs.append(timed(lambda: evaluate(m, batches, dev))
                        / len(batches))
        m.impl = "kernel"
        loss_rel = (abs(metrics["test_loss"] - metrics_fold["test_loss"])
                    / abs(metrics_fold["test_loss"]))
        finite = (all(bool(torch.isfinite(p).all()) for p in preds)
                  and all(np.isfinite(v) for v in metrics.values()))
        return {"metrics": metrics, "metrics_fold_lane": metrics_fold,
                "loss_rel_err_vs_fold_lane": loss_rel,
                "loss_rtol_vs_fold_lane": loss_rtol[dtype],
                "launches": counts, "expected_launches": want,
                "launches_per_batch": n_win * 2 * mp, "finite": finite,
                "shapes": [list(p.shape) for p in preds[:1]],
                "seconds_per_batch_in_turns": {"order": order,
                                               "seconds": secs},
                "ok": (counts == want and finite
                       and loss_rel <= loss_rtol[dtype])}

    # gnn_pre_slice: one eval batch of MAgNet[GNN] 1D (16 Heat
    # trajectories) and of 2D (the regular 32 x 32 test grid), each in f32
    # and bf16, on #2 at width 128 alone
    t_phase = time.perf_counter()
    slices = {f"{dtype}_{pos_dim}d": eval_pre(dtype, pos_dim, batches)
              for pos_dim, batches in ((1, eval_batches),
                                       (2, data["gnn2d_eval"][:1]))
              for dtype in ("f32", "bf16")}
    slice_ok = all(s["ok"] for s in slices.values())
    emit({"phase": "gnn_pre_slice", "model": "magnet_gnn",
          "impl": "kernel_pregathered",
          "eval_all_graph_1d": {"n_node": eg.all.n_node,
                                "n_edge": eg.all.n_edge},
          **slices, "seconds": time.perf_counter() - t_phase,
          "ok": slice_ok})
    if not slice_ok:
        return 43, [], {}

    def train_pre(dtype, pos_dim, loaders_):
        """``Trainer.fit`` on the pre-gathered lane alone over two epochs of
        one step (#2, #3 and the sender gather's #1 a layer call, #2 a
        validation batch), the checkpoint read back and one resumed step;
        the first step against the plain path; seconds a step in turns with
        the fold lane's."""
        fwd_key, bwd_key, seg_key = counters[dtype]
        tm = new_model(dtype, pos_dim)
        loaders_["train"].set_epoch(0)
        b0 = to_device(next(iter(loaders_["train"])), dev)
        g0 = tm.build_graph(b0)
        plain = gnn_loss_and_grads(tm, "plain", b0, g0)
        reset_every_launch()
        step = gnn_vs_plain(tm, "kernel_pregathered", plain, b0, g0)
        step["launches"] = every_launch()
        del tm, plain
        nt = loaders_["train"].dataset.data["t"].shape[1]
        per_step = ((nt - ts_of[pos_dim]) // ts_of[pos_dim]) * 2 * mp
        step["expected_launches"] = {
            k: per_step if k in (fwd_key, bwd_key, seg_key) else 0
            for k in step["launches"]}
        if dtype == "bf16":
            bf16_step(step)
        step["ok"] = step["ok"] and (step["launches"]
                                     == step["expected_launches"])
        n_epochs, steps = 2, len(loaders_["train"])
        val_batches = len(loaders_["val"])
        fit, resumed = fit_checkpoint_resume(
            lambda: new_model(dtype, pos_dim), hps[dtype], loaders_, dev,
            n_epochs, reset_every_launch, every_launch)
        counts = fit.pop("launches")
        want = {k: 0 for k in counts}
        want[fwd_key] = per_step * (steps + val_batches) * n_epochs
        want[bwd_key] = want[seg_key] = per_step * steps * n_epochs
        host_batches = [to_device(b, dev) for b in loaders_["train"]]
        order = ["fold", "pregathered", "pregathered", "fold"]
        secs = []
        for o in order:
            resumed.model.impl = ("kernel" if o == "fold"
                                  else "kernel_pregathered")
            secs.append(timed(lambda: [resumed.train_step(b)
                                       for b in host_batches]) / steps)
        del resumed
        ok = (counts == want and fit["losses_finite"] and step["ok"]
              and fit["checkpoint_ok"] and fit["resume_ok"])
        return {"launches": counts, "expected_launches": want,
                "launches_per_train_step": per_step,
                "train_all_graph": {"n_node": g0.all.n_node,
                                    "n_edge": g0.all.n_edge},
                **fit, "loss_falls": falls(fit["epoch_train_losses"]),
                "step_vs_plain": step,
                "seconds_per_step_in_turns": {"order": order,
                                              "seconds": secs},
                "ok": ok}

    # gnn_pre_train: Trainer.fit (2 steps, then 1 resumed) of MAgNet[GNN]
    # 1D on 32 KS trajectories through the GNN datamodule and of 2D at the
    # published 512-node irregular configuration, each in f32 and bf16
    t_phase = time.perf_counter()
    trains = {f"{dtype}_{pos_dim}d": train_pre(dtype, pos_dim, loaders_)
              for pos_dim, loaders_ in ((1, loaders),
                                        (2, data["gnn2d_loaders"]))
              for dtype in ("f32", "bf16")}
    train_ok = all(t["ok"] for t in trains.values())
    emit({"phase": "gnn_pre_train", "model": "magnet_gnn",
          "impl": "kernel_pregathered",
          "batch_size": loaders["train"].batch_size, **trains,
          "seconds": time.perf_counter() - t_phase, "ok": train_ok})
    if not train_ok:
        return 44, [], {}

    # gnn_pre_c6: one MAgNet[CNN] 2D training step on impl="kernel_pe" at
    # the cnn2d group's training graph (batch 8), f32 and bf16, against the
    # plain path: no sender-tile layout there, so the pe lane rule runs the
    # pre-gathered (64, 32) builds (#2, #3, #1) and no pe kernel
    t_phase = time.perf_counter()
    loaders2d = data["cnn2d_loaders"]
    loaders2d["train"].set_epoch(0)
    cb0 = to_device(next(iter(loaders2d["train"])), dev)
    hp_c = dict(MAGNET_CNN_2D)
    nt_c = DATAMODULE_IMPLICIT_2D["nt_train"]
    per_step_c = ((nt_c - hp_c["time_slice"]) // hp_c["time_slice"]) * (
        hp_c["num_message_passing_steps"])
    c6 = {}
    for dtype, keys in (("f32", ("fused_edge_pregathered_fwd",
                                 "fused_edge_pregathered_bwd", "segment_sum")),
                        ("bf16", ("fused_edge_pregathered_bf16_fwd",
                                  "fused_edge_pregathered_bf16_bwd",
                                  "segment_sum_bf16"))):
        cm = create_model("magnet_cnn_2d",
                          {**hp_c, **({"graph_dtype": "bf16"}
                                      if dtype == "bf16" else {})},
                          device=dev, seed=0)
        cg = cm.build_graph(cb0)
        plain = gnn_loss_and_grads(cm, "plain", cb0, cg)
        reset_every_launch()
        rec = gnn_vs_plain(cm, "kernel_pe", plain, cb0, cg)
        rec["launches"] = every_launch()
        rec["expected_launches"] = {k: per_step_c if k in keys else 0
                                    for k in rec["launches"]}
        if dtype == "bf16":
            bf16_step(rec)
        rec.update(n_node=cg.n_node, n_edge=cg.n_edge, lane=cg.lane,
                   snd2=cg.layout.snd2, snd_transpose=cg.layout.snd_transpose)
        rec["ok"] = (rec["ok"] and not cg.layout.snd2
                     and rec["launches"] == rec["expected_launches"])
        c6[dtype] = rec
        del cm, plain
    c6_ok = all(r["ok"] for r in c6.values())
    emit({"phase": "gnn_pre_c6", "model": "magnet_cnn_2d",
          "impl": "kernel_pe", "batch_size": CNN2D_BATCH, **c6,
          "seconds": time.perf_counter() - t_phase, "ok": c6_ok})
    if not c6_ok:
        return 45, [], {}

    def launches(key):
        return (sum(s["launches"][key] for s in slices.values())
                + sum(t["launches"][key] + t["step_vs_plain"]["launches"][key]
                      for t in trains.values()))

    fw, bw = fwd["eval_all"]["timing"], bwd["train_all"]["timing"]

    def row(name, source, replaces, key, found, t, dtype):
        if dtype == "bf16":
            ms, plain_ms, b = t["mean_ms"]["bf16"], t["plain_ms"], t
            other = {"ms_f32_build_in_turns": t["mean_ms"]["f32"],
                     "share_of_bound": t["bound_ms"] / ms,
                     "share_against": "bound_ms (bf16, 989 TFLOP/s)"}
        else:
            ms, plain_ms, b = t["mean_ms"]["f32"], t["f32_plain_ms"], \
                t["f32_bound"]
            other = {"tc_bound_ms": b["tc_bound_ms"],
                     "tc_bound_by": b["tc_bound_by"],
                     "ms_bf16_build_in_turns": t["mean_ms"]["bf16"]}
        return {"name": name, "route": "cuda",
                "source": f"magnet_tpu_torch/csrc/{source}",
                "entry": "pregathered", "widths": [h, h],
                "replaces": f"magnet_tpu/ops/pallas_kernels.py:{replaces}",
                "launches": launches(key), "max_abs_err": found,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None, **other,
                "shape": ("eval LR ∪ HR graph" if replaces == 278
                          else "training LR ∪ HR graph"), "ok": True}

    def worst_grad(f32):
        """The largest max_abs_err of the bf16 (or f32) #3 against its plain
        version over every gradient and graph."""
        return max(float((v["f32_vs_plain"] if f32 else v)["max_abs_err"])
                   for r in bwd.values() for v in r.values()
                   if isinstance(v, dict) and "f32_vs_plain" in v)

    kernels = [
        row("fused_edge_tail_agg_pregathered_bf16_w128",
            "fused_edge_tail_agg_bf16_w128.cu", 278,
            "fused_edge_pregathered128_bf16_fwd",
            max(float(r["max_abs_err"]) for r in fwd.values()), fw, "bf16"),
        row("fused_edge_tail_agg_pregathered_bf16_w128_bwd",
            "fused_edge_tail_agg_bf16_w128.cu", 376,
            "fused_edge_pregathered128_bf16_bwd", worst_grad(False), bw,
            "bf16"),
        row("fused_edge_tail_agg_pregathered_w128", "fused_edge_tail_agg.cu",
            278, "fused_edge_pregathered128_fwd",
            max(float(r["f32_vs_plain"]["max_abs_err"]) for r in fwd.values()),
            fw, "f32"),
        row("fused_edge_tail_agg_pregathered_bwd_w128",
            "fused_edge_tail_agg_bwd.cu", 376,
            "fused_edge_pregathered128_bwd", worst_grad(True), bw, "f32")]
    c6_counts = {k: sum(r["launches"][k] for r in c6.values())
                 for k in c6["f32"]["launches"]}
    return 0, kernels, {
        "segment_sum": {"launches_gnn_pre": launches("segment_sum")
                        + c6_counts["segment_sum"]},
        "segment_sum_bf16": {"launches_gnn_pre": launches("segment_sum_bf16")
                             + c6_counts["segment_sum_bf16"]},
        "fused_edge_tail_agg_pregathered": {
            "launches_gnn_pre_c6": c6_counts["fused_edge_pregathered_fwd"]},
        "fused_edge_tail_agg_pregathered_bwd": {
            "launches_gnn_pre_c6": c6_counts["fused_edge_pregathered_bwd"]},
        "fused_edge_tail_agg_pregathered_bf16": {
            "launches_gnn_pre_c6":
                c6_counts["fused_edge_pregathered_bf16_fwd"]},
        "fused_edge_tail_agg_pregathered_bf16_bwd": {
            "launches_gnn_pre_c6":
                c6_counts["fused_edge_pregathered_bf16_bwd"]}}


def cnn_pe_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``pe64_kernel``, ``pe64_kernel_bwd``, ``pe64_slice`` and
    ``pe64_train``: MAgNet[CNN]'s pe lane (``impl="kernel_pe"``, the JAX
    package's lane under ``MAGNET_TPU_NO_FUSED2R``) at its published
    widths, its four kernels (#6 and #7 at (H, C) = (64, 32), f32 in
    ``csrc/fused_edge_tail_agg.cu`` / ``fused_edge_tail_agg_bwd.cu`` and
    bf16 in ``csrc/fused_edge_tail_agg_bf16.cu``) against their plain
    versions, then MAgNet[CNN] 1D through ``evaluate`` and ``Trainer.fit``
    and 2D through ``evaluate``, in f32 and in bf16, each on the pe kernels
    alone (with the f32 #1 for d_pxj).  Returns the exit code, the four
    kernels' entries and the segment sum's launches."""
    from magnet_tpu_torch.config import (
        DATAMODULE_IMPLICIT,
        DATAMODULE_IMPLICIT_2D,
        HEAT_TEST,
        MAGNET_CNN,
        MAGNET_CNN_2D,
    )
    from magnet_tpu_torch.data.loader import DataLoader
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.time_bwd import runner as bwd_runner
    from magnet_tpu_torch.time_bwd import runner_pe64_bf16 as bwd_runner_bf16
    from magnet_tpu_torch.time_fwd import bind, in_turns
    from magnet_tpu_torch.time_fwd import operands as c_operands
    from magnet_tpu_torch.time_fwd import runner, runner_pe64_bf16, to_bf16
    from magnet_tpu_torch.train.trainer import Trainer
    from magnet_tpu_torch.utils import to_device

    hp, hp2d = dict(MAGNET_CNN), dict(MAGNET_CNN_2D)
    h, c, l1 = hp["mlp_hidden"], hp["latent_dim"], hp["mlp_layers"] - 1
    mp, ts = hp["num_message_passing_steps"], hp["time_slice"]
    batches, loaders = data["heat"], data["ks_loaders"]
    loaders2d = data["cnn2d_loaders"]
    batches2d = list(DataLoader(loaders2d["test"].dataset, 4, shuffle=False,
                                drop_last=False))

    def new(name, params, dtype, impl="kernel_pe"):
        m = create_model(name, {**params, "graph_dtype": dtype}, device=dev,
                         seed=0)
        m.impl = impl
        return m

    model = new("magnet_cnn", hp, "float32")
    egraph = model.build_graph(
        {k: torch.as_tensor(v) for k, v in batches[0].items()})
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    tgraph = model.build_graph(batch0)
    model2d = new("magnet_cnn_2d", hp2d, "float32")
    egraph2d = model2d.build_graph(
        {k: torch.as_tensor(v) for k, v in batches2d[0].items()})
    fn32, fn32_bwd = (bind(cuda_build.build(name), name)
                      for name in (fe.FWD, fe.BWD))
    small = small_line_graph()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bwd_tiles, tiles_info = bwd_tile_edges(sms, seed=61)
    graphs = {"eval_1d": (egraph, l1), "train_1d": (tgraph, l1),
              "eval_2d": (egraph2d, l1), "small_case": (small, 1),
              "tile_edges": (tile_edges_graph(fe.FWD_TILE, seed=62), l1)}

    def pe_ops(graph, l1c, seed):
        """The C entry's f32 operands (src, None, None, pxj, pxi, senders,
        rowptr, tail...) and the wrapper's, f32 and bf16."""
        ops = c_operands("pe", graph, h, h, c, l1c, seed, dev)
        src, _, _, pxj, pxi, senders, rowptr, *tail = ops

        def wrapper(o):
            src_, _, _, pxj_, pxi_, _, _, *tail_ = o
            return (src_, pxj_, pxi_, senders, rowptr,
                    graph.snd_ptr.to(dev), graph.snd_perm.to(dev), *tail_)

        return ops, wrapper(ops), wrapper(to_bf16(ops))

    # pe64_kernel: #6 at (64, 32), f32 and bf16, vs its plain version (the
    # bf16 build also vs the f32 kernel, receiver means) at MAgNet[CNN]
    # 1D's eval and training graphs, 2D's eval graph, the small graph (a
    # degree-0 receiver, 64-edge receivers, L1 = 1) and the forward's tile
    # graph; bit-equal launches; times at the three main-path graphs, the
    # two builds in turns
    t_phase = time.perf_counter()
    fwd = {"f32": {}, "bf16": {}}
    for label, (graph, l1c) in graphs.items():
        ops, wops, wops_bf = pe_ops(graph, l1c, seed=63)
        zero = graph.degree.to(dev) == 0
        info = dict(n_node=graph.n_node, n_edge=graph.n_edge, l1=l1c,
                    max_degree=int(graph.degree.max()),
                    n_degree0=int(zero.sum()))
        got32 = fe.fused_edge_tail_agg_pe(*wops)
        torch.cuda.synchronize()
        r32 = compare(got32, fe.fused_edge_tail_agg_pe_plain(*wops),
                      KERNEL_RTOL, KERNEL_ATOL)
        r32.update(info, degree0_rows_zero=bool((got32[zero] == 0).all()))
        got = fe.fused_edge_tail_agg_pe_bf16(*wops_bf)
        torch.cuda.synchronize()
        rbf = compare_bf16(got, fe.fused_edge_tail_agg_pe_bf16_plain(*wops_bf))
        deg = graph.degree.to(dev).clamp_min(1.0)[:, None]
        rbf["vs_f32_kernel"] = compare(got / deg, got32 / deg,
                                       BF16_VS_F32_RTOL, BF16_VS_F32_ATOL)
        rbf["vs_f32_kernel"]["sums_max_abs_err"] = float(
            (got - got32).abs().max())
        rbf.update(info, degree0_rows_zero=bool((got[zero] == 0).all()))
        if label == "eval_1d":
            r32["bits_equal_run_to_run"] = torch.equal(
                fe.fused_edge_tail_agg_pe(*wops), fe.fused_edge_tail_agg_pe(*wops))
            rbf["bits_equal_run_to_run"] = torch.equal(
                fe.fused_edge_tail_agg_pe_bf16(*wops_bf),
                fe.fused_edge_tail_agg_pe_bf16(*wops_bf))
        if label in ("eval_1d", "train_1d", "eval_2d"):
            order, times, mean = in_turns(
                {"f32": runner(fn32, "pe", ops, (h, h, c)),
                 "bf16": runner_pe64_bf16(to_bf16(ops))},
                first="f32", then="bf16")
            b32 = pregathered_bound("fwd", graph, h, c, l1c, pe=True)
            b32.update(tc_bound(b32))
            r32["timing"] = {
                "order": order, "ms": times, "mean_ms": mean["f32"],
                "plain_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pe_plain(*wops), reps=10),
                **b32}
            rbf["timing"] = {
                "order": order, "ms": times, "mean_ms": mean["bf16"],
                "plain_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pe_bf16_plain(*wops_bf),
                    reps=10),
                **pe_bf16_bound("fwd", graph, h, c, l1c)}
        fwd["f32"][label], fwd["bf16"][label] = r32, rbf
        del ops, wops, wops_bf, got, got32
    # the wgmma kernel at L1 = 0..3 on the small, E = 1 and tile graphs and
    # at the 1D eval and training and the 2D eval graphs
    wgmma_fwd = fwd_bf16_checks("pe", 64, dev, seed=480, paths=(
        ("eval_1d", egraph), ("train_1d", tgraph), ("eval_2d", egraph2d)))
    fwd_ok = wgmma_fwd["ok"] and all(
        r["ok"] and r["degree0_rows_zero"]
        and r.get("bits_equal_run_to_run", True)
        and r.get("vs_f32_kernel", {"ok": True})["ok"]
        for rows in fwd.values() for r in rows.values())
    emit({"phase": "pe64_kernel", "h": h, "c": c, "l1": l1,
          "tolerance": {"f32_vs_plain": {"rtol": KERNEL_RTOL,
                                         "atol": KERNEL_ATOL},
                        "bf16_vs_plain": {"rtol": BF16_RTOL,
                                          "atol": BF16_ATOL,
                                          "max_rel_l2": BF16_L2},
                        "bf16_vs_f32_kernel": {"rtol": BF16_VS_F32_RTOL,
                                               "atol": BF16_VS_F32_ATOL,
                                               "of": "receiver means"}},
          "pe64": fwd["f32"], "pe64_bf16": fwd["bf16"], "library_ms": None,
          "wgmma_fwd_checks": wgmma_fwd, "wgmma_fwd_ptxas": fwd_bf16_ptxas(64),
          "seconds": time.perf_counter() - t_phase, "ok": fwd_ok})
    if not fwd_ok:
        return 40, [], {}

    # pe64_kernel_bwd: #7 at (64, 32) with #1 for d_pxj, f32 and bf16, every
    # gradient vs the plain versions (the bf16 build also vs the f32 kernel)
    # at the 1D training graph (g zero on the receivers of relu ties,
    # counted; by relative L2), the small graph and the backward's tile
    # graph (elementwise in f32); bit-equal launches; times of #7 alone in
    # turns, and with #1
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(64)
    cases = {"train_shape": (tgraph, l1, 65), "small_case": (small, 1, 66),
             "tile_edges": (bwd_tiles, l1, 67)}
    bwd32, train32 = check_bwd_w64(
        "pe", [(label, gr, pe_ops(gr, l1c, seed)[1])
               for label, (gr, l1c, seed) in cases.items()], gen, c)
    bwd32["tile_edges"]["graph"] = tiles_info
    bwd_bf = {}
    for label, (graph, l1c, seed) in cases.items():
        ops, wops, wops_bf = pe_ops(graph, l1c, seed)
        g = (train32[0] if label == "train_shape"
             else torch.randn(graph.n_node, c, generator=gen).to(dev))
        res = {}
        if label == "train_shape":
            ties = tie_receivers_bf16(wops_bf, l1c, "pe")
            g = g.clone()
            g[ties] = 0.0
            res["tie_receivers_zeroed"] = int(ties.numel())
        got = fe.fused_edge_tail_agg_pe_bf16_bwd(*wops_bf, g)
        torch.cuda.synchronize()
        want = fe.fused_edge_tail_agg_pe_bf16_bwd_plain(*wops_bf, g)
        want32 = fe.fused_edge_tail_agg_pe_bwd(*wops, g)
        plain32 = fe.fused_edge_tail_agg_pe_bwd_plain(*wops, g)
        deep = l1c > BF16_VS_F32_DEPTH
        for name, a, b, b32, p32 in zip(fe.GRAD_NAMES_PE, got, want, want32,
                                        plain32):
            res[name] = compare_grad(a, b, elementwise=False, rtol=BF16_RTOL,
                                     atol_rel=BF16_BWD_ATOL_REL,
                                     max_l2=BF16_BWD_L2)
            if b32.numel():
                l2, l2_plain = rel_l2(a, b32), rel_l2(b, p32)
                res[name].update(
                    vs_f32_kernel_rel_l2=l2,
                    plain_bf16_vs_plain_f32_rel_l2=l2_plain,
                    vs_f32_ok=l2 < BF16_VS_F32_GRAD_L2 or (
                        deep and l2 <= BF16_VS_F32_DEEP * l2_plain))
        res["dtypes_ok"] = [a.dtype for a in got] == [b.dtype for b in want]
        res["vs_f32_kernel_ok"] = all(v.get("vs_f32_ok", True)
                                      for v in res.values()
                                      if isinstance(v, dict))
        zero = graph.degree.to(dev) == 0
        res["degree0_rows_zero"] = bool(
            (got[fe.GRAD_NAMES_PE.index("pxi")][zero] == 0).all())
        res.update(n_node=graph.n_node, n_edge=graph.n_edge, l1=l1c)
        if label == "train_shape":
            res["bits_equal_run_to_run"] = bits_equal_bwd(
                fe.fused_edge_tail_agg_pe_bf16_bwd, wops_bf, g,
                fe.GRAD_NAMES_PE)
            # #7 alone: the C entries as their wrappers launch them
            order, times, mean = in_turns(
                {"f32": bwd_runner(fn32_bwd, "pe", ops, g, (h, h, c)),
                 "bf16": bwd_runner_bf16(to_bf16(ops), g)},
                first="f32", then="bf16")
            b32 = pregathered_bound("bwd", graph, h, c, l1c, pe=True)
            b32.update(tc_bound(b32))
            bwd32["timing"] = {
                "order": order, "ms": times, "mean_ms": mean["f32"],
                "of": "#7 alone (d_pxj's #1 not included)",
                "with_segment_sum_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pe_bwd(*wops, g), reps=20),
                "plain_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pe_bwd_plain(*wops, g),
                    reps=5), **b32}
            res["timing"] = {
                "order": order, "ms": times, "mean_ms": mean["bf16"],
                "of": "#7 alone (d_pxj's #1 not included)",
                "with_segment_sum_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pe_bf16_bwd(*wops_bf, g),
                    reps=20),
                "plain_ms": cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pe_bf16_bwd_plain(
                        *wops_bf, g), reps=5),
                **pe_bf16_bound("bwd", graph, h, c, l1c)}
        bwd_bf[label] = res
        del ops, wops, wops_bf, got, want, want32, plain32
    bwd_ok = all(
        v["ok"] for case in bwd32.values() if isinstance(case, dict)
        for v in case.values() if isinstance(v, dict) and "ok" in v) and all(
        all(v["ok"] for v in r.values() if isinstance(v, dict) and "ok" in v)
        and r["dtypes_ok"] and r["vs_f32_kernel_ok"] and r["degree0_rows_zero"]
        for r in bwd_bf.values())
    # the bf16 build's wgmma kernel at L1 = 0..3 on the small, E = 1 and
    # tile graphs
    wgmma = bwd64_bf16_checks("pe", dev, sms, seed=340)
    bwd_ok = (bwd_ok and bwd_bf["train_shape"]["bits_equal_run_to_run"]["ok"]
              and wgmma["ok"])
    emit({"phase": "pe64_kernel_bwd", "l1": l1,
          "tolerance": {"f32_vs_plain": {
                            "rtol": BWD_RTOL, "atol_rel_to_max": BWD_ATOL_REL,
                            "max_rel_l2": BWD_L2,
                            "elementwise": "small_case and tile_edges"},
                        "bf16_vs_plain": {
                            "max_rel_l2": BF16_BWD_L2,
                            "counted_outside": {
                                "rtol": BF16_RTOL,
                                "atol_rel_to_max": BF16_BWD_ATOL_REL}},
                        "bf16_vs_f32_kernel_max_rel_l2": BF16_VS_F32_GRAD_L2,
                        "bf16_vs_f32_kernel_deeper_than_l1": BF16_VS_F32_DEPTH,
                        "bf16_vs_f32_kernel_deep_times_plain":
                            BF16_VS_F32_DEEP},
          "pe64_bwd": bwd32, "pe64_bf16_bwd": bwd_bf, "library_ms": None,
          "build": bwd_w64_build(), "bf16_build": bf16_ptxas(),
          "wgmma_checks": wgmma,
          "seconds": time.perf_counter() - t_phase, "ok": bwd_ok})
    if not bwd_ok:
        return 41, [], {}

    def eval_pe(m, bs, expect):
        """``evaluate`` of ``m`` (its lane set) on ``bs``: metrics,
        predictions, launches (every counter 0 but ``expect``'s) and the
        first call's seconds a batch."""
        reset_every_launch()
        t0 = time.perf_counter()
        metrics, preds = evaluate(m, bs, dev, return_predictions=True)
        torch.cuda.synchronize()
        first_s = (time.perf_counter() - t0) / len(bs)
        counts = every_launch()
        want = {k: expect.get(k, 0) for k in counts}
        finite = (all(bool(torch.isfinite(p).all()) for p in preds)
                  and all(np.isfinite(v) for v in metrics.values()))
        return metrics, preds, {"launches": counts, "expected_launches": want,
                                "launches_ok": counts == want,
                                "finite": finite,
                                "seconds_per_batch_first": first_s}

    def in_turns_s(runs, order):
        """Host seconds of each run in ``order`` (each warmed up first)."""
        for fn in runs.values():
            fn()
        secs = [timed(runs[o]) for o in order]
        return {"order": order, "seconds": secs,
                "mean": {k: float(np.mean([s for o, s in zip(order, secs)
                                           if o == k])) for k in runs}}

    # pe64_slice: evaluate() on MAgNet[CNN] 1D's 16 Heat trajectories (150
    # launches of #6 a batch) and 2D's 4 test trajectories at 64² (20 a
    # batch), f32 and bf16, on the pe kernels alone; f32 against the plain
    # path's rollout, bf16 against the f32 pe lane's loss; seconds a batch of
    # each beside the f32 fold lane's, in turns
    t_phase = time.perf_counter()
    slices = {}
    for name, params, bs, nt, points in (
            ("magnet_cnn", hp, batches, HEAT_TEST["nt"], HEAT_TEST["nx"]),
            ("magnet_cnn_2d", hp2d, batches2d,
             DATAMODULE_IMPLICIT_2D["nt_test"], 64 * 64)):
        ts_m = params["time_slice"]
        n_win = (nt - ts_m) // ts_m
        per_batch = n_win * params["num_message_passing_steps"]
        m32 = model if name == "magnet_cnn" else model2d
        m_bf = new(name, params, "bf16")
        met32, preds32, rec32 = eval_pe(
            m32, bs, {"fused_edge_pe64_fwd": per_batch * len(bs)})
        met_bf, preds_bf, rec_bf = eval_pe(
            m_bf, bs, {"fused_edge_pe64_bf16_fwd": per_batch * len(bs)})
        m32.impl = "plain"
        met_p, preds_p = evaluate(m32, bs, dev, return_predictions=True)
        m32.impl = "kernel"
        met_fold = evaluate(m32, bs, dev)
        cmp = compare(torch.cat(preds32), torch.cat(preds_p), SLICE_RTOL,
                      SLICE_ATOL)
        loss_rel = (abs(met_bf["test_loss"] - met32["test_loss"])
                    / abs(met32["test_loss"]))
        shape_ok = all(
            tuple(p.shape) == (b["hr_points"].shape[0], n_win * ts_m, points,
                               1)
            for preds in (preds32, preds_bf) for p, b in zip(preds, bs))
        del preds32, preds_bf, preds_p

        def run(m, impl):
            def go():
                m.impl = impl
                evaluate(m, bs, dev)
            return go

        turns = in_turns_s({"f32_fold": run(m32, "kernel"),
                            "f32_pe": run(m32, "kernel_pe"),
                            "bf16_pe": run(m_bf, "kernel_pe")},
                           ["f32_fold", "f32_pe", "bf16_pe", "bf16_pe",
                            "f32_pe", "f32_fold"])
        m32.impl = "kernel_pe"
        del m_bf
        ok = (rec32["launches_ok"] and rec_bf["launches_ok"]
              and rec32["finite"] and rec_bf["finite"] and cmp["ok"]
              and shape_ok and loss_rel <= BF16_LOSS_RTOL)
        slices[name] = {
            "batches": len(bs), "batch_size": bs[0]["hr_points"].shape[0],
            "windows": n_win, "launches_per_batch": per_batch,
            "graph": {"n_node": (egraph if name == "magnet_cnn"
                                 else egraph2d).n_node,
                      "n_edge": (egraph if name == "magnet_cnn"
                                 else egraph2d).n_edge},
            "f32": {**rec32, "metrics": met32, "vs_plain": cmp,
                    "plain_metrics": met_p, "fold_lane_metrics": met_fold},
            "bf16": {**rec_bf, "metrics": met_bf,
                     "loss_rel_err_vs_f32_pe": loss_rel,
                     "loss_rtol_vs_f32": BF16_LOSS_RTOL},
            "shape_ok": shape_ok,
            "seconds_per_batch_in_turns": {
                "order": turns["order"],
                "seconds": [s / len(bs) for s in turns["seconds"]],
                "mean": {k: v / len(bs) for k, v in turns["mean"].items()}},
            "ok": ok}
    slice_ok = all(v["ok"] for v in slices.values())
    emit({"phase": "pe64_slice", **slices,
          "seconds": time.perf_counter() - t_phase, "ok": slice_ok})
    if not slice_ok:
        return 42, [], {}
    del model2d

    # pe64_train: Trainer.fit on MAgNet[CNN] 1D on the pe lane, f32 and
    # bf16 (70 launches each of #6, #7 and the f32 #1 a step), checkpoint
    # read back, resume; the first step's loss and gradients against the
    # plain path; seconds a step beside the f32 fold lane's, in turns
    t_phase = time.perf_counter()
    nt = DATAMODULE_IMPLICIT["nt_train"]
    per_step = (nt - ts) // ts * mp
    n_epochs, steps = 2, len(loaders["train"])
    val_batches = len(loaders["val"])
    trains, resumed = {}, {}
    for dtype, suffix in (("float32", ""), ("bf16", "_bf16")):
        tmodel = new("magnet_cnn", hp, dtype)
        plain = gnn_loss_and_grads(tmodel, "plain", batch0, tgraph)
        step = gnn_vs_plain(tmodel, "kernel_pe", plain, batch0, tgraph)
        del tmodel, plain
        if dtype == "bf16":
            # the plain path is the fold lane's bf16 plain versions, which
            # round elsewhere: the loss within 1e-3, gradients finite
            step.pop("grad_rel_l2_tol")
            step["loss_rtol"] = 1e-3
            step["ok"] = step["grads_finite"] and step["loss_rel_err"] <= 1e-3
        fit, resumed[dtype] = fit_checkpoint_resume(
            lambda: new("magnet_cnn", hp, dtype), hp, loaders, dev, n_epochs,
            reset_every_launch, every_launch)
        counts = fit.pop("launches")
        want = {k: 0 for k in counts}
        want[f"fused_edge_pe64{suffix}_fwd"] = per_step * (
            steps + val_batches) * n_epochs
        want[f"fused_edge_pe64{suffix}_bwd"] = per_step * steps * n_epochs
        want["segment_sum"] = per_step * steps * n_epochs
        trains[dtype] = {
            "launches": counts, "expected_launches": want, **fit,
            "loss_falls": falls(fit["epoch_train_losses"]),
            "step_vs_plain": step,
            "ok": (counts == want and fit["losses_finite"] and step["ok"]
                   and falls(fit["epoch_train_losses"])
                   and fit["checkpoint_ok"] and fit["resume_ok"])}
    host_batches = [to_device(b, dev) for b in loaders["train"]]

    def steps_of(trainer):
        return lambda: [trainer.train_step(b) for b in host_batches]

    with tempfile.TemporaryDirectory() as workdir:
        fold32 = Trainer(new("magnet_cnn", hp, "float32", impl="kernel"),
                         max_epochs=1, lr=hp["lr"],
                         weight_decay=hp["weight_decay"], factor=hp["factor"],
                         step_size=hp["step_size"], device=dev,
                         workdir=workdir)
        fold32.setup(steps)
        turns = in_turns_s({"f32_fold": steps_of(fold32),
                            "f32_pe": steps_of(resumed["float32"]),
                            "bf16_pe": steps_of(resumed["bf16"])},
                           ["f32_fold", "f32_pe", "bf16_pe", "bf16_pe",
                            "f32_pe", "f32_fold"])
    del fold32, resumed
    train_ok = all(v["ok"] for v in trains.values())
    emit({"phase": "pe64_train", "model": "magnet_cnn",
          "batch_size": loaders["train"].batch_size,
          "train_graph": {"n_node": tgraph.n_node, "n_edge": tgraph.n_edge},
          "launches_per_train_step": per_step, **trains,
          "seconds_per_step_in_turns": {
              "order": turns["order"],
              "seconds": [s / steps for s in turns["seconds"]],
              "mean": {k: v / steps for k, v in turns["mean"].items()}},
          "seconds": time.perf_counter() - t_phase, "ok": train_ok})
    if not train_ok:
        return 43, [], {}

    def fwd_err(rows):
        return max(r["max_abs_err"] for r in rows.values())

    def bwd_err(rows):
        return max(v["max_abs_err"] for r in rows.values()
                   if isinstance(r, dict) for v in r.values()
                   if isinstance(v, dict) and "max_abs_err" in v)

    def row(name, source, replaces, launches, err, timing, shape, tc):
        entry = {
            "name": name, "route": "cuda",
            "source": f"magnet_tpu_torch/csrc/{source}", "entry": "pe",
            "widths": [h, c],
            "replaces": f"magnet_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": launches, "max_abs_err": err,
            "ms": timing["mean_ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None, "shape": shape, "ok": True}
        if tc:
            entry.update(tc_bound_ms=timing["tc_bound_ms"],
                         tc_bound_by=timing["tc_bound_by"])
        else:
            entry.update(share_of_bound=timing["bound_ms"] / timing["mean_ms"],
                         share_against="bound_ms (bf16, 989 TFLOP/s)")
        return entry

    def launches_of(key):
        return (sum(s[dt]["launches"][key] for s in slices.values()
                    for dt in ("f32", "bf16"))
                + sum(t["launches"][key] for t in trains.values()))

    shapes = ("MAgNet[CNN] 1D eval graph", "MAgNet[CNN] 1D training graph")
    kernels = [
        row("fused_edge_tail_agg_pe64", "fused_edge_tail_agg.cu", 929,
            launches_of("fused_edge_pe64_fwd"), fwd_err(fwd["f32"]),
            fwd["f32"]["eval_1d"]["timing"], shapes[0], True),
        row("fused_edge_tail_agg_pe64_bwd", "fused_edge_tail_agg_bwd.cu",
            1046, launches_of("fused_edge_pe64_bwd"), bwd_err(bwd32),
            bwd32["timing"], shapes[1], True),
        row("fused_edge_tail_agg_pe64_bf16", "fused_edge_tail_agg_bf16.cu",
            929, launches_of("fused_edge_pe64_bf16_fwd"), fwd_err(fwd["bf16"]),
            fwd["bf16"]["eval_1d"]["timing"], shapes[0], False),
        row("fused_edge_tail_agg_pe64_bf16_bwd", "fused_edge_tail_agg_bf16.cu",
            1046, launches_of("fused_edge_pe64_bf16_bwd"), bwd_err(bwd_bf),
            bwd_bf["train_shape"]["timing"], shapes[1], False)]
    kernels[0].update(ms_train_1d=fwd["f32"]["train_1d"]["timing"]["mean_ms"],
                      ms_eval_2d=fwd["f32"]["eval_2d"]["timing"]["mean_ms"],
                      bound_ms_eval_2d=fwd["f32"]["eval_2d"]["timing"]
                      ["bound_ms"])
    kernels[2].update(ms_train_1d=fwd["bf16"]["train_1d"]["timing"]["mean_ms"],
                      ms_eval_2d=fwd["bf16"]["eval_2d"]["timing"]["mean_ms"],
                      bound_ms_eval_2d=fwd["bf16"]["eval_2d"]["timing"]
                      ["bound_ms"])
    return 0, kernels, {"segment_sum": {
        "launches_cnn_pe": sum(t["launches"]["segment_sum"]
                               for t in trains.values())}}


def mpnn_operands(graph, h, seed, dev):
    """(pxj, pr, w, b) for a graph: node tables of order 0.5, a weight of
    order 1/sqrt(H), so that both pre-activations are of order 1."""
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    n = graph.n_node
    return (f(n, h, scale=0.5), f(n, h, scale=0.5), f(h, h, scale=0.15),
            f(h, scale=0.1))


def mpnn_bound(kernel: str, gather: bool, graph, h) -> dict:
    """Least time on the card for one call of an MPNN message kernel: the
    H x H product's 2·E·H² operations (three times that in the backward:
    recompute, data gradient, weight gradient) over the f32 peak, and each
    input read once plus each output written once over the HBM rate."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * h * h
    src = n * h + e if gather else e * h      # the sender side (+ senders)
    inputs = src + n * h + h * h + h + (n + 1)
    if kernel == "fwd":
        nbytes = 4.0 * (inputs + n * h)
    elif kernel == "bwd":
        flops *= 3.0
        d_src = n * h if gather else e * h
        nbytes = 4.0 * (inputs + n * h + d_src + n * h + h * h + h)
    else:
        raise ValueError(kernel)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def tile_edges_graph(te: int, seed: int, n_edge_min: int = 0):
    """A graph whose edges meet the tiled kernels' tiles of ``te``
    consecutive edges in every way their receiver sums must handle:
    receiver 3 takes 3 te + 7 edges from mid-tile (it spans four tiles);
    receiver 5 ends exactly on a tile boundary, with receivers of degree 0
    on both sides of it (6, 7 and 9); receiver 8 fills a tile; and the edge
    count is one past a multiple of te.  With ``n_edge_min``, receivers of
    0 to 2 te - 1 edges are added until there are at least that many edges.
    Built from an explicit edge list, since radius_graph caps the degree;
    senders drawn from a seed."""
    from magnet_tpu_torch.ops.graph import csr_from_edges

    rng = np.random.default_rng(seed)
    deg = [0, 5, 0, 3 * te + 7, 0]
    deg.append(-sum(deg) % te or te)
    deg += [0, 0, te, 0]
    deg += list(rng.integers(1, 2 * te, 12))
    while sum(deg) < n_edge_min:
        deg += list(rng.integers(0, 2 * te, 64))
    deg.append((1 - sum(deg)) % te or te)
    deg += [0, 0]
    n = len(deg)
    receivers = np.repeat(np.arange(n), deg)
    senders = rng.integers(0, n, receivers.size)
    return csr_from_edges(torch.from_numpy(senders).int(),
                          torch.from_numpy(receivers).int(), n)


def grid_coords(batch_size: int, width: int) -> np.ndarray:
    """(B, W*W, 2) coordinates of the datamodule's regular 2D mesh."""
    x = (np.arange(width) * (1.0 / width)).astype(np.float32)
    grid = np.stack(np.meshgrid(x, x, indexing="ij"), -1).reshape(-1, 2)
    return np.broadcast_to(grid, (batch_size, *grid.shape)).copy()


def mpnn_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``mpnn_kernel`` and ``mpnn_kernel_bwd`` (group
    ``mpnn_kernels``), ``mpnn_slice`` and ``mpnn_train`` (group
    ``mpnn_paths``): the four MPNN message kernels and the MPNN paths.
    Returns the exit code (0: all passed), the four kernels' entries and
    the segment sum's launches on the MPNN-1D step."""
    from magnet_tpu_torch.config import (
        DATAMODULE_GRAPH,
        DATAMODULE_GRAPH_2D,
        MPNN,
        MPNN_2D,
    )
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import mpnn_edge as me
    from magnet_tpu_torch.ops import segment as seg
    from magnet_tpu_torch.train.checkpoint import load_checkpoint
    from magnet_tpu_torch.train.trainer import Trainer
    from magnet_tpu_torch.utils import to_device

    hp2 = dict(MPNN_2D)
    h = hp2["hidden_features"]
    bs2, res = DATAMODULE_GRAPH_2D["batch_size"], DATAMODULE_GRAPH_2D["res_train"]
    model2 = create_model("mpnn_2d", hp2, device=dev, seed=0)
    coords = grid_coords(bs2, res)
    graph = model2.build_graph({"x": torch.from_numpy(coords)})
    shape = {"n_node": graph.n_node, "n_edge": graph.n_edge, "h": h,
             "radius": model2._radius(coords),
             "mean_degree": float(graph.degree.mean()),
             "max_degree": int(graph.degree.max()),
             "max_out_degree": int(torch.bincount(
                 graph.senders.long(), minlength=graph.n_node).max())}
    # a small graph with a node of degree 0 (isolated, no self loop) and
    # uneven degrees up to 64 (two 32-edge rounds of a warp in the forward)
    small_graph = small_line_graph().to(dev)
    cases = (("path_shape", graph, mpnn_operands(graph, h, 11, dev)),
             ("small_case", small_graph,
              mpnn_operands(small_graph, h, 12, dev)))
    # the forward's tiles of FWD_TILE edges, crossed in every way
    tile_graph = tile_edges_graph(me.FWD_TILE, seed=15).to(dev)

    def gathered(gr, ops):
        """The pre-gathered entry's operands from the gather entry's."""
        return (ops[0].index_select(0, gr.senders.long()), *ops[1:],
                gr.rowptr)

    entries, extra = {}, {}
    rc = 0
    if "mpnn_kernels" in groups:
        # 7. the two forward entries vs plain
        fwd = {"gather": {}, "pregathered": {}}
        for label, gr, ops in cases + (
                ("tile_edges", tile_graph,
                 mpnn_operands(tile_graph, h, 14, dev)),):
            got = me.fused_mpnn_edge_agg2r(*ops, gr.senders, gr.rowptr)
            torch.cuda.synchronize()
            want = me.fused_mpnn_edge_agg2r_plain(*ops, gr.senders, gr.rowptr)
            fwd["gather"][label] = compare(got, want, MPNN_RTOL, MPNN_ATOL)
            pre = gathered(gr, ops)
            got = me.fused_mpnn_edge_agg(*pre)
            torch.cuda.synchronize()
            want = me.fused_mpnn_edge_agg_plain(*pre)
            fwd["pregathered"][label] = compare(got, want, MPNN_RTOL,
                                                MPNN_ATOL)
            if label == "small_case":
                fwd["gather"]["degree0_row_zero"] = {
                    "ok": bool((me.fused_mpnn_edge_agg2r(
                        *ops, gr.senders, gr.rowptr)[17] == 0).all())}
                fwd["pregathered"]["degree0_row_zero"] = {
                    "ok": bool((got[17] == 0).all())}
            if label == "tile_edges":
                zero = gr.degree == 0
                fwd["gather"]["tile_edges"]["degree0_rows_zero"] = bool(
                    (me.fused_mpnn_edge_agg2r(*ops, gr.senders, gr.rowptr)
                     [zero] == 0).all())
                fwd["pregathered"]["tile_edges"]["degree0_rows_zero"] = bool(
                    (got[zero] == 0).all())
                for entry in fwd.values():
                    entry["tile_edges"].update(
                        n_edge=gr.n_edge, tile=me.FWD_TILE,
                        max_degree=int(gr.degree.max()),
                        n_degree0=int(zero.sum()))
                    entry["tile_edges"]["ok"] &= entry["tile_edges"][
                        "degree0_rows_zero"]
        ops = cases[0][2]
        pre = gathered(graph, ops)
        # no atomics: two launches give the same bits
        fwd["gather"]["bits_equal_run_to_run"] = {"ok": torch.equal(
            me.fused_mpnn_edge_agg2r(*ops, graph.senders, graph.rowptr),
            me.fused_mpnn_edge_agg2r(*ops, graph.senders, graph.rowptr))}
        fwd["pregathered"]["bits_equal_run_to_run"] = {"ok": torch.equal(
            me.fused_mpnn_edge_agg(*pre), me.fused_mpnn_edge_agg(*pre))}
        times = {
            "gather": {
                "ms": cuda_ms(lambda: me.fused_mpnn_edge_agg2r(
                    *ops, graph.senders, graph.rowptr), reps=20),
                "plain_ms": cuda_ms(lambda: me.fused_mpnn_edge_agg2r_plain(
                    *ops, graph.senders, graph.rowptr), reps=5),
                **mpnn_bound("fwd", True, graph, h),
                **tc_bound(mpnn_bound("fwd", True, graph, h))},
            "pregathered": {
                "ms": cuda_ms(lambda: me.fused_mpnn_edge_agg(*pre), reps=20),
                "plain_ms": cuda_ms(
                    lambda: me.fused_mpnn_edge_agg_plain(*pre), reps=5),
                **mpnn_bound("fwd", False, graph, h),
                **tc_bound(mpnn_bound("fwd", False, graph, h))}}
        for t in times.values():
            t["share_of_tc_bound"] = t["tc_bound_ms"] / t["ms"]
        fwd_ok = all(v["ok"] for e in fwd.values() for v in e.values())
        emit({"phase": "mpnn_kernel", **shape,
              "small_case_max_degree": int(small_graph.degree.max()),
              "tolerance": {"rtol": MPNN_RTOL, "atol": MPNN_ATOL},
              "vs_plain": fwd, "times": times,
              "ptxas": ptxas_lines(cuda_build.build("fused_mpnn_edge_agg")),
              "library_ms": None,
              "library_ms_reason": "no single PyTorch call computes the "
                                   "fused function", "ok": fwd_ok})
        if not fwd_ok:
            return 6, [], {}

        # 8. the two backward entries vs plain, every gradient elementwise
        # at both shapes (swish is smooth: no tie can flip a gradient)
        g_gen = torch.Generator().manual_seed(13)
        bwd = {"gather": {}, "pregathered": {}}
        for label, gr, ops_ in cases:
            g = torch.randn(gr.n_node, h, generator=g_gen).to(dev)
            got_g = me.fused_mpnn_edge_agg2r_bwd(*ops_, gr.senders,
                                                 gr.rowptr, g)
            torch.cuda.synchronize()
            want_g = me.fused_mpnn_edge_agg2r_bwd_plain(*ops_, gr.senders,
                                                        gr.rowptr, g)
            bwd["gather"][label] = {
                name: compare_grad(a, b, elementwise=True)
                for name, a, b in zip(me.GRAD_NAMES_2R, got_g, want_g)}
            pre_ = gathered(gr, ops_)
            got_p = me.fused_mpnn_edge_agg_bwd(*pre_, g)
            torch.cuda.synchronize()
            want_p = me.fused_mpnn_edge_agg_bwd_plain(*pre_, g)
            bwd["pregathered"][label] = {
                name: compare_grad(a, b, elementwise=True)
                for name, a, b in zip(me.GRAD_NAMES, got_p, want_p)}
            if label == "path_shape":
                g_t = g
                # the d_pxj atomics from one launch to the next
                again = me.fused_mpnn_edge_agg2r_bwd(*ops_, gr.senders,
                                                     gr.rowptr, g)
                atomics = {"d_pxj_max_abs_run_to_run": float(
                    (again[0] - got_g[0]).abs().max()),
                    "d_pr_max_abs_run_to_run": float(
                    (again[1] - got_g[1]).abs().max()),
                    "dw_equal_run_to_run": bool(
                        torch.equal(again[2], got_g[2]))}
            else:
                for entry, grads in (("gather", got_g), ("pregathered", got_p)):
                    bwd[entry]["degree0_row_zero"] = {"pr": {
                        "ok": bool((grads[1][17] == 0).all())}}
        times_b = {
            "gather": {
                "ms": cuda_ms(lambda: me.fused_mpnn_edge_agg2r_bwd(
                    *ops, graph.senders, graph.rowptr, g_t), reps=10),
                "plain_ms": cuda_ms(
                    lambda: me.fused_mpnn_edge_agg2r_bwd_plain(
                        *ops, graph.senders, graph.rowptr, g_t), reps=3),
                **mpnn_bound("bwd", True, graph, h),
                **tc_bound(mpnn_bound("bwd", True, graph, h))},
            "pregathered": {
                "ms": cuda_ms(lambda: me.fused_mpnn_edge_agg_bwd(*pre, g_t),
                              reps=10),
                "plain_ms": cuda_ms(
                    lambda: me.fused_mpnn_edge_agg_bwd_plain(*pre, g_t),
                    reps=3),
                **mpnn_bound("bwd", False, graph, h),
                **tc_bound(mpnn_bound("bwd", False, graph, h))}}
        bwd_ok = all(v["ok"] for e in bwd.values() for case in e.values()
                     for v in case.values())
        emit({"phase": "mpnn_kernel_bwd", **shape,
              "tolerance": {"rtol": BWD_RTOL, "atol_rel_to_max": BWD_ATOL_REL,
                            "max_rel_l2": BWD_L2,
                            "elementwise": "both shapes"},
              "vs_plain": bwd, "atomics": atomics, "times": times_b,
              "ptxas": ptxas_lines(cuda_build.build("fused_mpnn_edge_agg_bwd")),
              "library_ms": None,
              "library_ms_reason": "no single PyTorch call computes the "
                                   "fused function", "ok": bwd_ok})
        if not bwd_ok:
            return 7, [], {}

        for name, entry, kern, line, tt, errs in (
                ("fused_mpnn_edge_agg2r", "gather", "fwd", 2364, times, fwd),
                ("fused_mpnn_edge_agg2r_bwd", "gather", "bwd", 2453, times_b,
                 bwd),
                ("fused_mpnn_edge_agg", "pregathered", "fwd", 664, times, fwd),
                ("fused_mpnn_edge_agg_bwd", "pregathered", "bwd", 733,
                 times_b, bwd)):
            suffix = "_bwd" if kern == "bwd" else ""
            entries[f"{kern}_{entry}"] = {
                "name": name, "route": "cuda",
                "source": f"magnet_tpu_torch/csrc/fused_mpnn_edge_agg{suffix}.cu",
                "entry": entry,
                "replaces": f"magnet_tpu/ops/pallas_kernels.py:{line}",
                "launches": 0, "max_abs_err": worst(errs[entry]),
                "ms": tt[entry]["ms"], "plain_ms": tt[entry]["plain_ms"],
                "bound_ms": tt[entry]["bound_ms"],
                "bound_by": tt[entry]["bound_by"], "library_ms": None,
                "tc_bound_ms": tt[entry]["tc_bound_ms"],
                "tc_bound_by": tt[entry]["tc_bound_by"], "ok": True}

    if "mpnn_paths" in groups:
        # 9. the MPNN-2D slice: evaluate() at full width on seeded
        # Burgers-2D batches (the val and the test split's)
        loaders = data["b2d_loaders"]
        batches = list(loaders["val"]) + list(loaders["test"])
        same_mesh = all(np.array_equal(b["x"], coords) for b in batches)
        n_win = (DATAMODULE_GRAPH_2D["nt_test"] - hp2["time_window"]) \
            // hp2["time_window"]
        per_batch = n_win * hp2["hidden_layer"]
        me.reset_launches()
        t0 = time.perf_counter()
        metrics, preds = evaluate(model2, batches, dev,
                                  return_predictions=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = dict(me.launches)
        want_counts = {"fwd_gather": per_batch * len(batches), "bwd_gather": 0,
                       "fwd_pregathered": 0, "bwd_pregathered": 0}
        torch.cuda.reset_peak_memory_stats()
        steady_s = timed(lambda: evaluate(model2, batches, dev))
        peak = torch.cuda.max_memory_allocated()
        model2.impl = "plain"
        t0 = time.perf_counter()
        metrics_plain, preds_plain = evaluate(model2, batches, dev,
                                              return_predictions=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        model2.impl = "kernel"
        cmp = compare(torch.cat(preds), torch.cat(preds_plain),
                      MPNN_SLICE_RTOL, MPNN_SLICE_ATOL)
        finite = all(bool(torch.isfinite(p).all()) for p in preds) and all(
            np.isfinite(v) for v in metrics.values())
        horizon = n_win * hp2["time_window"]
        shape_ok = all(tuple(p.shape) == (b["u"].shape[0], horizon, res * res)
                       for p, b in zip(preds, batches))
        slice_ok = (counts == want_counts and finite and shape_ok
                    and same_mesh and cmp["ok"])
        emit({"phase": "mpnn_slice", "model": "mpnn_2d",
              "batches": len(batches), "batch_size": bs2,
              "nt": DATAMODULE_GRAPH_2D["nt_test"], "res": res,
              "windows": n_win, "layers": hp2["hidden_layer"], **shape,
              "kernel_launches": counts, "expected_launches": want_counts,
              "launches_per_batch": per_batch,
              "graph_cache_hits": model2.graphs.hits,
              "mesh_is_the_kernel_phases": same_mesh,
              "finite": finite, "shape_ok": shape_ok, **metrics,
              "plain_metrics": metrics_plain, "vs_plain": cmp,
              "seconds_per_batch_first": first_s / len(batches),
              "seconds_per_batch": steady_s / len(batches),
              "seconds_per_batch_plain": plain_s / len(batches),
              "seconds_to_make_data": data["b2d_seconds"],
              "peak_mem_bytes": peak, "ok": slice_ok})
        if not slice_ok:
            return 8, list(entries.values()), {}
        del preds, preds_plain
        slice_counts = counts

        # 10. MPNN-2D training: Trainer.fit at full width, then one MPNN-1D
        # step on the pre-gathered kernels
        def loss_and_grads(m, batch, gr, impl, kernel_impl):
            m.impl = impl
            m.zero_grad(set_to_none=True)
            loss, _ = m.loss(batch, gr, train=True)
            loss.backward()
            m.impl = kernel_impl
            return loss.detach(), {k: p.grad.clone()
                                   for k, p in m.named_parameters()}

        def vs_plain(m, batch, gr, kernel_impl):
            loss_k, grads_k = loss_and_grads(m, batch, gr, kernel_impl,
                                             kernel_impl)
            loss_p, grads_p = loss_and_grads(m, batch, gr, "plain",
                                             kernel_impl)
            l2 = {k: float((grads_k[k].double() - grads_p[k].double()).norm()
                           / grads_p[k].double().norm().clamp_min(1e-30))
                  for k in grads_p}
            worst_k = max(l2, key=l2.get)
            fin = all(bool(torch.isfinite(v).all()) for v in grads_k.values())
            rel = float((loss_k - loss_p).abs() / loss_p.abs())
            return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
                    "loss_rel_err": rel, "loss_rtol": TRAIN_LOSS_RTOL,
                    "worst_grad_rel_l2": l2[worst_k], "worst_grad": worst_k,
                    "grad_rel_l2_tol": TRAIN_GRAD_L2, "grads_finite": fin,
                    "ok": (fin and l2[worst_k] <= TRAIN_GRAD_L2
                           and rel <= TRAIN_LOSS_RTOL)}

        loaders["train"].set_epoch(0)
        batch0 = to_device(next(iter(loaders["train"])), dev)
        tmodel = create_model("mpnn_2d", hp2, device=dev, seed=0)
        tgraph = tmodel.build_graph(batch0)
        first_step_s = timed(lambda: loss_and_grads(tmodel, batch0, tgraph,
                                                    "kernel", "kernel"))
        cmp2 = vs_plain(tmodel, batch0, tgraph, "kernel")

        n_epochs, steps = 2, len(loaders["train"])
        val_batches = len(loaders["val"])
        with tempfile.TemporaryDirectory() as workdir:
            trainer = Trainer(
                create_model("mpnn_2d", hp2, device=dev, seed=0),
                max_epochs=n_epochs, lr=hp2["lr"],
                weight_decay=hp2["weight_decay"], factor=hp2["factor"],
                step_size=hp2["step_size"], workdir=workdir, device=dev)
            step_losses = []
            inner_step = trainer.device_step

            def recording_step(batch, graph):
                m = inner_step(batch, graph)
                step_losses.append(m["loss"])
                return m

            trainer.device_step = recording_step
            me.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            fit_s = timed(lambda: trainer.fit(loaders["train"],
                                              loaders["val"]))
            fit_counts = dict(me.launches)
            peak_train = torch.cuda.max_memory_allocated()
            want_bwd = per_batch * steps * n_epochs
            want_fit = {"fwd_gather": want_bwd
                        + per_batch * val_batches * n_epochs,
                        "bwd_gather": want_bwd, "fwd_pregathered": 0,
                        "bwd_pregathered": 0}
            with open(os.path.join(workdir, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            step_losses = [float(v) for v in step_losses]
            losses_finite = (all(np.isfinite(v) for v in step_losses)
                             and all(np.isfinite(v) for r_ in rows
                                     for v in r_.values()))
            last = os.path.join(workdir, "checkpoints", "last.pt")
            state, meta = load_checkpoint(last, require=("model", "optimizer"))
            ckpt_ok = (state["step"] == steps * n_epochs
                       and meta.get("epoch") == n_epochs - 1
                       and all(torch.equal(v.cpu(), state["model"][k])
                               for k, v in trainer.model.state_dict().items()))
            host_batches = list(loaders["train"])
            trainer.device_step = inner_step
            step_s = timed(lambda: [trainer.train_step(b)
                                    for b in host_batches]) / steps
            trainer.model.impl = "plain"
            step_plain_s = timed(lambda: [trainer.train_step(b)
                                          for b in host_batches]) / steps
            trainer.model.impl = "kernel"

            # one MPNN-1D step with the sender rows gathered outside
            hp1 = dict(MPNN)
            ce = data["ce_loaders"]["train"]
            ce.set_epoch(0)
            batch1 = next(iter(ce))
            model1 = create_model("mpnn", hp1, device=dev, seed=0)
            model1.impl = "kernel_pregathered"
            dbatch1 = to_device(batch1, dev)
            graph1 = model1.build_graph(dbatch1)
            cmp1 = vs_plain(model1, dbatch1, graph1, "kernel_pregathered")
            trainer1 = Trainer(model1, lr=hp1["lr"],
                               weight_decay=hp1["weight_decay"],
                               factor=hp1["factor"],
                               step_size=hp1["step_size"],
                               workdir=os.path.join(workdir, "mpnn_1d"),
                               device=dev)
            trainer1.setup(1)
            me.reset_launches()
            seg.launches = 0
            m1 = trainer1.train_step(batch1)
            torch.cuda.synchronize()
            counts1 = dict(me.launches)
            seg1 = seg.launches
            step1_s = timed(lambda: trainer1.train_step(batch1))
        n_win1 = (DATAMODULE_GRAPH["nt_train"] - hp1["time_window"]) \
            // hp1["time_window"]
        per_step1 = n_win1 * hp1["hidden_layer"]
        want1 = {"fwd_gather": 0, "bwd_gather": 0,
                 "fwd_pregathered": per_step1, "bwd_pregathered": per_step1}
        # the sender gather's backward is the segment sum, once per layer
        step1_ok = (counts1 == want1 and seg1 == per_step1 and cmp1["ok"]
                    and bool(torch.isfinite(m1["loss"])))
        train_ok = (fit_counts == want_fit and losses_finite
                    and step_losses[-1] < step_losses[0] and cmp2["ok"]
                    and ckpt_ok and step1_ok)
        emit({"phase": "mpnn_train", "model": "mpnn_2d", "batch_size": bs2,
              "steps_per_epoch": steps, "epochs": n_epochs,
              "val_batches_per_epoch": val_batches, "windows_per_step": n_win,
              "data": {**MPNN_2D_DATA,
                       "seconds_to_make": data["b2d_seconds"]},
              "launches": fit_counts, "expected_launches": want_fit,
              "launches_per_train_step": {"fwd": per_batch, "bwd": per_batch},
              "step_losses": step_losses, "rows": rows,
              "losses_finite": losses_finite, "vs_plain": cmp2,
              "checkpoint_ok": ckpt_ok,
              "seconds_first_loss_and_backward": first_step_s,
              "seconds_per_step": step_s,
              "seconds_per_step_plain": step_plain_s, "seconds_fit": fit_s,
              "peak_mem_bytes": peak_train,
              "mpnn_1d_step": {
                  "impl": "kernel_pregathered",
                  "data": {**MPNN_1D_DATA,
                           "seconds_to_make": data["ce_seconds"]},
                  "n_node": graph1.n_node, "n_edge": graph1.n_edge,
                  "windows_per_step": n_win1, "launches": counts1,
                  "expected_launches": want1,
                  "segment_sum_launches": seg1,
                  "expected_segment_sum_launches": per_step1,
                  "loss": float(m1["loss"]),
                  "vs_plain": cmp1, "seconds_per_step": step1_s,
                  "ok": step1_ok},
              "ok": train_ok})
        for key in entries:
            entries[key]["launches"] = (slice_counts[key] + fit_counts[key]
                                        + counts1[key])
            entries[key]["launches_eval"] = slice_counts[key]
            entries[key]["launches_train"] = fit_counts[key] + counts1[key]
            entries[key]["ok"] = train_ok
        extra = {"segment_sum": {"launches_mpnn_1d_step": seg1}}
        if not train_ok:
            rc = 9
    return rc, list(entries.values()), extra


def cnn2d_graph(model, batch_size, seed):
    """The MAgNet[CNN] 2D training graph of ``batch_size`` samples, each the
    32 x 32 LR grid ∪ 32 queries drawn from the 64 x 64 mesh, as the
    datamodule draws them."""
    from magnet_tpu_torch.utils import make_coord_np

    rng = np.random.default_rng(seed)
    full = make_coord_np([64, 64])
    coords = np.stack([full[np.sort(rng.choice(64 * 64, 32, replace=False))]
                       for _ in range(batch_size)])
    return model.build_graph({"coords": torch.from_numpy(coords),
                              "lr_frames": torch.zeros(1, 1, 1, 32, 32)})


def pregathered_operands(graph, h, c, l1, seed, dev):
    """(h0, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b) for a
    graph, of the fold operands' scales."""
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    n, e = graph.n_node, graph.n_edge
    return (f(e, h), f(n, h), graph.rowptr.to(dev), f(l1, h, h), f(l1, h),
            f(h, c), f(c), 1 + f(c, scale=0.1), f(c, scale=0.1))


def pregathered_bound(kernel: str, graph, h, c, l1, pe=False) -> dict:
    """Least time on the card for one call of the pre-gathered forward
    (``"fwd"``) or backward (``"bwd"``) kernel: 2·E·(L1·H² + H·C) operations
    (three times that backward), h0 and the node table read and the output
    written once (backward: g read, d_h0, d_pxi and the weight gradients
    written).  ``pe``: the pe entry (#6, #7), which also reads the senders
    and the sender table pxj."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * (l1 * h * h + h * c)
    weights = l1 * (h * h + h) + h * c + 3 * c
    inputs = e * h + (n + 1) + n * h + weights + (e + n * h if pe else 0)
    if kernel == "fwd":
        nbytes = 4.0 * (inputs + n * c)
    else:
        flops *= 3.0
        nbytes = 4.0 * (inputs + n * c + e * h + n * h + weights)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def segment_bound(graph, h, size=4.0) -> dict:
    """Least time for one segment sum over the sender CSR: the (E, H) rows,
    perm and ptr read once and the (N, H) sums written once (rows and sums
    of ``size`` bytes an element: 4 f32, 2 bf16), against one add per
    element."""
    n, e = graph.n_node, graph.n_edge
    flops = 1.0 * e * h
    nbytes = size * (e * h + n * h) + 4.0 * (e + (n + 1))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def cnn2d_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``cnn2d_kernel``, ``cnn2d_kernel_bwd``, ``cnn2d_slice`` and
    ``cnn2d_train``: the pre-gathered GraphNet edge kernels (#2, #3), the
    segment sum (#1) and the two MAgNet[CNN] 2D paths.  Returns the exit
    code (0: all passed), the three kernels' entries and the launches of
    the fold forward (#8) on the two paths."""
    from magnet_tpu_torch.config import DATAMODULE_IMPLICIT_2D, MAGNET_CNN_2D
    from magnet_tpu_torch.data.loader import DataLoader
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import segment as seg
    from magnet_tpu_torch.ops.graph import csr_from_edges, radius_graph
    from magnet_tpu_torch.utils import to_device

    hp = dict(MAGNET_CNN_2D)
    h, c = hp["mlp_hidden"], hp["latent_dim"]
    l1 = hp["mlp_layers"] - 1
    mp = hp["num_message_passing_steps"]
    ts = hp["time_slice"]
    model = create_model("magnet_cnn_2d", hp, device=dev, seed=0)

    # 11. #2 vs plain on the datamodule's full training graph (32 samples
    # of 1,056 nodes), on a small graph with a degree-0 node, and on a graph
    # that crosses the forward's tiles in every way
    graph = cnn2d_graph(model, CNN2D_KERNEL_BATCH, seed=7)
    out_deg = torch.bincount(graph.senders.long(), minlength=graph.n_node)
    shape = {"n_node": graph.n_node, "n_edge": graph.n_edge, "lane": graph.lane,
             "h": h, "c": c, "l1": l1,
             "mean_degree": float(graph.degree.mean()),
             "max_degree": int(graph.degree.max()),
             "max_out_degree": int(out_deg.max())}
    pos = np.linspace(-1, 1, 200, dtype=np.float32)[:, None]
    pos[17, 0] = 9.0
    s_, r_ = radius_graph(torch.from_numpy(pos), 0.4, loop=False,
                          max_num_neighbors=64)
    small = csr_from_edges(s_, r_, 200).to(dev)
    ops = pregathered_operands(graph, h, c, l1, seed=21, dev=dev)
    ops_s = pregathered_operands(small, h, c, 1, seed=22, dev=dev)
    tiles = tile_edges_graph(fe.FWD_TILE, seed=25).to(dev)
    ops_t = pregathered_operands(tiles, h, c, l1, seed=24, dev=dev)
    fwd = {}
    for label, o in (("train_shape", ops), ("small_case", ops_s),
                     ("tile_edges", ops_t)):
        got = fe.fused_edge_tail_agg_pregathered(*o)
        torch.cuda.synchronize()
        fwd[label] = compare(got, fe.fused_edge_tail_agg_pregathered_plain(*o),
                             KERNEL_RTOL, KERNEL_ATOL)
        if label == "small_case":
            fwd[label]["degree0_row_zero"] = bool((got[17] == 0).all())
            fwd[label]["l1"] = 1
    zero = tiles.degree == 0
    fwd["tile_edges"].update(
        n_edge=tiles.n_edge, tile=fe.FWD_TILE,
        max_degree=int(tiles.degree.max()), n_degree0=int(zero.sum()),
        degree0_rows_zero=bool((got[zero] == 0).all()))
    # no atomics: two launches give the same bits
    fwd["bits_equal_run_to_run"] = torch.equal(
        fe.fused_edge_tail_agg_pregathered(*ops),
        fe.fused_edge_tail_agg_pregathered(*ops))
    fwd_ms = cuda_ms(lambda: fe.fused_edge_tail_agg_pregathered(*ops), reps=50)
    fwd_plain_ms = cuda_ms(
        lambda: fe.fused_edge_tail_agg_pregathered_plain(*ops), reps=20)
    bnd_fwd = {**pregathered_bound("fwd", graph, h, c, l1),
               **tc_bound(pregathered_bound("fwd", graph, h, c, l1))}
    kernel_ok = (shape["lane"] == "pregathered" and fwd["train_shape"]["ok"]
                 and fwd["small_case"]["ok"]
                 and fwd["small_case"]["degree0_row_zero"]
                 and fwd["tile_edges"]["ok"]
                 and fwd["tile_edges"]["degree0_rows_zero"]
                 and fwd["bits_equal_run_to_run"])
    emit({"phase": "cnn2d_kernel", **shape,
          "small_case_max_degree": int(small.degree.max()),
          "tolerance": {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
          "vs_plain": fwd, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
          "library_ms": None, **bnd_fwd,
          "share_of_tc_bound": bnd_fwd["tc_bound_ms"] / fwd_ms,
          "ptxas": ptxas_lines(cuda_build.build("fused_edge_tail_agg")),
          "ok": kernel_ok})
    if not kernel_ok:
        return 10, [], {}

    # 12. #3 vs plain (every gradient, as phase 5: check_bwd_w64), and #1
    # over the sender CSR vs plain and index_add_
    bwd_tiles, tiles_info = bwd_tile_edges(
        torch.cuda.get_device_properties(dev).multi_processor_count, seed=38)
    bwd_tiles = bwd_tiles.to(dev)
    bwd, (g_t, (d_h0, *_)) = check_bwd_w64(
        "pregathered", (("train_shape", graph, ops),
                        ("small_case", small, ops_s),
                        ("tile_edges", bwd_tiles,
                         pregathered_operands(bwd_tiles, h, c, l1, seed=39,
                                              dev=dev))),
        torch.Generator().manual_seed(23), c)
    bwd["tile_edges"]["graph"] = tiles_info
    bwd_ms = cuda_ms(lambda: fe.fused_edge_tail_agg_pregathered_bwd(*ops, g_t),
                     reps=20)
    bwd_plain_ms = cuda_ms(
        lambda: fe.fused_edge_tail_agg_pregathered_bwd_plain(*ops, g_t), reps=5)
    bnd_bwd = pregathered_bound("bwd", graph, h, c, l1)
    bnd_bwd.update(tc_bound(bnd_bwd))
    bwd_ok = all(v["ok"] for case in bwd.values() for v in case.values()
                 if isinstance(v, dict) and "ok" in v)

    ptr, perm = graph.snd_ptr, graph.snd_perm
    senders = graph.senders.long()
    got_s = seg.segment_sum(d_h0, ptr, perm)
    again = seg.segment_sum(d_h0, ptr, perm)
    torch.cuda.synchronize()
    want_s = seg.segment_sum_plain(d_h0, ptr, perm)

    def library():
        return torch.zeros(graph.n_node, h, device=dev).index_add_(
            0, senders, d_h0)

    lib_s = library()
    err = (got_s.double() - want_s.double()).abs()
    tol = SEG_RTOL * want_s.double().abs() + SEG_ATOL_REL * float(
        want_s.abs().max())
    seg_cmp = {"vs_plain": {"max_abs_err": float(err.max()),
                            "ok": bool((err <= tol).all())},
               "vs_index_add": {"max_abs_err": float(
                   (got_s - lib_s).abs().max()),
                   "ok": bool(((got_s.double() - lib_s.double()).abs()
                               <= tol).all())},
               "equal_bits_run_to_run": bool(torch.equal(got_s, again)),
               "degree0_row_zero": bool((got_s[out_deg == 0] == 0).all()),
               "tolerance": {"rtol": SEG_RTOL,
                             "atol_rel_to_max": SEG_ATOL_REL}}
    seg_ms = cuda_ms(lambda: seg.segment_sum(d_h0, ptr, perm), reps=50)
    seg_plain_ms = cuda_ms(lambda: seg.segment_sum_plain(d_h0, ptr, perm),
                           reps=20)
    seg_lib_ms = cuda_ms(library, reps=50)
    bnd_seg = segment_bound(graph, h)
    seg_ok = (seg_cmp["vs_plain"]["ok"] and seg_cmp["vs_index_add"]["ok"]
              and seg_cmp["equal_bits_run_to_run"])
    emit({"phase": "cnn2d_kernel_bwd", **shape,
          "tolerance": {"rtol": BWD_RTOL, "atol_rel_to_max": BWD_ATOL_REL,
                        "max_rel_l2": BWD_L2,
                        "elementwise": "small_case and tile_edges"},
          "vs_plain": bwd, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
          "library_ms": None, **bnd_bwd,
          "share_of_tc_bound": bnd_bwd["tc_bound_ms"] / bwd_ms,
          "build": bwd_w64_build(),
          "segment_sum": {**seg_cmp, "ms": seg_ms, "plain_ms": seg_plain_ms,
                          "library_ms": seg_lib_ms,
                          "library": "torch.Tensor.index_add_", **bnd_seg,
                          "ok": seg_ok},
          "ok": bwd_ok and seg_ok})
    if not (bwd_ok and seg_ok):
        return 11, [], {}
    del ops, d_h0, got_s, again, want_s, lib_s

    # 13. the eval slice: evaluate() on 4 test trajectories at 64 x 64
    loaders = data["cnn2d_loaders"]
    batches = list(DataLoader(loaders["test"].dataset, 4, shuffle=False,
                              drop_last=False))
    nt = DATAMODULE_IMPLICIT_2D["nt_test"]
    n_win = (nt - ts) // ts
    per_batch = n_win * mp
    egraph = model.build_graph({k: torch.as_tensor(v)
                                for k, v in batches[0].items()})
    # #8 vs plain at the eval graph's shape, timed (the fold lane's launches)
    ce = hp["latent_dim"]
    ops_e = kernel_operands(egraph, ce, h, c, l1, seed=28, dev=dev)
    fold_2d = compare(fe.fused_edge_tail_agg(*ops_e),
                      fe.fused_edge_tail_agg_plain(*ops_e), KERNEL_RTOL,
                      KERNEL_ATOL)
    bnd_2d = bound("fwd", egraph, ce, h, c, l1)
    fold_2d.update(n_edge=egraph.n_edge, ce=ce, h=h, c=c, l1=l1,
                   ms=cuda_ms(lambda: fe.fused_edge_tail_agg(*ops_e), reps=30),
                   plain_ms=cuda_ms(
                       lambda: fe.fused_edge_tail_agg_plain(*ops_e), reps=5),
                   **bnd_2d, **tc_bound(bnd_2d))
    fold_2d["share_of_tc_bound"] = fold_2d["tc_bound_ms"] / fold_2d["ms"]
    del ops_e
    fe.reset_launches()
    seg.launches = 0
    t0 = time.perf_counter()
    metrics, preds = evaluate(model, batches, dev, return_predictions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {"fold": fe.launches, "fold_bwd": fe.launches_bwd,
              "pregathered": fe.launches_pregathered,
              "pregathered_bwd": fe.launches_pregathered_bwd,
              "segment_sum": seg.launches}
    want_counts = {"fold": per_batch * len(batches), "fold_bwd": 0,
                   "pregathered": 0, "pregathered_bwd": 0, "segment_sum": 0}
    torch.cuda.reset_peak_memory_stats()
    steady_s = timed(lambda: evaluate(model, batches, dev))
    peak = torch.cuda.max_memory_allocated()
    model.impl = "plain"
    t0 = time.perf_counter()
    metrics_plain, preds_plain = evaluate(model, batches, dev,
                                          return_predictions=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    model.impl = "kernel"
    cmp = compare(torch.cat(preds), torch.cat(preds_plain), SLICE_RTOL,
                  SLICE_ATOL)
    finite = all(bool(torch.isfinite(p).all()) for p in preds) and all(
        np.isfinite(v) for v in metrics.values())
    shape_ok = all(tuple(p.shape) == (b["hr_points"].shape[0], n_win * ts,
                                      64 * 64, 1)
                   for p, b in zip(preds, batches))
    slice_ok = (counts == want_counts and egraph.lane == "fold" and finite
                and shape_ok and cmp["ok"] and fold_2d["ok"])
    emit({"phase": "cnn2d_slice", "model": "magnet_cnn_2d",
          "batches": len(batches), "batch_size": 4, "nt": nt, "res": 64,
          "support": 32, "windows": n_win, "n_node": egraph.n_node,
          "n_edge": egraph.n_edge, "lane": egraph.lane,
          "kernel_launches": counts, "expected_launches": want_counts,
          "launches_per_batch": per_batch, "finite": finite,
          "shape_ok": shape_ok, **metrics, "plain_metrics": metrics_plain,
          "vs_plain": cmp, "seconds_per_batch_first": first_s / len(batches),
          "seconds_per_batch": steady_s / len(batches),
          "seconds_per_batch_plain": plain_s / len(batches),
          "peak_mem_bytes": peak, "fold_kernel_at_eval_shape": fold_2d,
          "ok": slice_ok})
    if not slice_ok:
        return 12, [], {}
    del preds, preds_plain
    slice_fold = counts["fold"]

    # 14. training: Trainer.fit at full width on the pre-gathered lane,
    # kernel path vs plain path on one batch on both lanes
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)

    def loss_and_grads(m, gr, impl):
        m.impl = impl
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(batch0, gr, train=True)
        loss.backward()
        m.impl = "kernel"
        return loss.detach(), {k: p.grad.clone()
                               for k, p in m.named_parameters()}

    def vs_plain(m, gr, impl, want):
        loss_k, grads_k = loss_and_grads(m, gr, impl)
        loss_p, grads_p = want
        l2 = {k: float((grads_k[k].double() - grads_p[k].double()).norm()
                       / grads_p[k].double().norm().clamp_min(1e-30))
              for k in grads_p}
        worst_k = max(l2, key=l2.get)
        fin = all(bool(torch.isfinite(v).all()) for v in grads_k.values())
        rel = float((loss_k - loss_p).abs() / loss_p.abs())
        return {"impl": impl, "loss_kernel": float(loss_k),
                "loss_plain": float(loss_p), "loss_rel_err": rel,
                "loss_rtol": TRAIN_LOSS_RTOL,
                "worst_grad_rel_l2": l2[worst_k], "worst_grad": worst_k,
                "grad_rel_l2_tol": TRAIN_GRAD_L2, "grads_finite": fin,
                "ok": (fin and l2[worst_k] <= TRAIN_GRAD_L2
                       and rel <= TRAIN_LOSS_RTOL)}

    tmodel = create_model("magnet_cnn_2d", hp, device=dev, seed=0)
    tgraph = tmodel.build_graph(batch0)
    first_step_s = timed(lambda: loss_and_grads(tmodel, tgraph, "kernel"))
    plain = loss_and_grads(tmodel, tgraph, "plain")
    cmp_pre = vs_plain(tmodel, tgraph, "kernel", plain)
    cmp_fold = vs_plain(tmodel, tgraph, "kernel_fold", plain)
    del plain

    n_epochs, steps = 2, len(loaders["train"])
    val_batches = len(loaders["val"])
    nt_train = DATAMODULE_IMPLICIT_2D["nt_train"]
    per_step = ((nt_train - ts) // ts) * mp
    step_losses, lanes = [], []

    def record_steps_and_lanes(trainer):
        inner_step = trainer.device_step
        inner_build = trainer.model.build_graph

        def recording_step(batch, graph):
            m = inner_step(batch, graph)
            step_losses.append(m["loss"])
            return m

        def recording_build(batch):
            gr = inner_build(batch)
            lanes.append(gr.lane)
            return gr

        trainer.device_step = recording_step
        trainer.model.build_graph = recording_build

    def reset():
        fe.reset_launches()
        seg.launches = 0

    def counts():
        return {"fold": fe.launches, "fold_bwd": fe.launches_bwd,
                "pregathered": fe.launches_pregathered,
                "pregathered_bwd": fe.launches_pregathered_bwd,
                "segment_sum": seg.launches}

    fit, resumed = fit_checkpoint_resume(
        lambda: create_model("magnet_cnn_2d", hp, device=dev, seed=0), hp,
        loaders, dev, n_epochs, reset, counts,
        prepare=record_steps_and_lanes)
    fit_counts = fit["launches"]
    n_steps = steps * n_epochs
    want_fit = {"fold": per_batch * val_batches * n_epochs, "fold_bwd": 0,
                "pregathered": per_step * n_steps,
                "pregathered_bwd": per_step * n_steps,
                "segment_sum": per_step * n_steps}
    want_lanes = (["pregathered"] * steps + ["fold"] * val_batches) * n_epochs
    step_losses = [float(v) for v in step_losses]
    losses_finite = (all(np.isfinite(v) for v in step_losses)
                     and fit["losses_finite"])
    # seconds per step, steady, on graphs the model has cached (a new
    # batch's host graph is timed apart): kernel path, then plain path
    host_batches = list(loaders["train"])
    graph_s = timed(lambda: [resumed.model.build_graph(to_device(b, dev))
                             for b in host_batches]) / steps
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    resumed.model.impl = "plain"
    step_plain_s = timed(lambda: [resumed.train_step(b)
                                  for b in host_batches]) / steps
    resumed.model.impl = "kernel"
    # the first fit's epochs' mean training loss falls (single steps see
    # other trajectories and queries)
    epoch_losses = fit["epoch_train_losses"][:n_epochs]
    train_ok = (tgraph.lane == "pregathered" and fit_counts == want_fit
                and lanes == want_lanes and losses_finite
                and epoch_losses[-1] < epoch_losses[0] and cmp_pre["ok"]
                and cmp_fold["ok"] and fit["checkpoint_ok"]
                and fit["resume_ok"])
    emit({"phase": "cnn2d_train", "model": "magnet_cnn_2d",
          "batch_size": CNN2D_BATCH, "val_batches_per_epoch": val_batches,
          "windows_per_step": per_step // mp,
          "data": {"train_trajectories": len(loaders["train"].dataset),
                   "seconds_to_make": data["cnn2d_seconds"]},
          "train_graph": {"n_node": tgraph.n_node, "n_edge": tgraph.n_edge,
                          "lane": tgraph.lane},
          "lanes": lanes, "expected_lanes": want_lanes,
          **fit, "expected_launches": want_fit,
          "launches_per_train_step": {"pregathered": per_step,
                                      "pregathered_bwd": per_step,
                                      "segment_sum": per_step},
          "step_losses": step_losses, "losses_finite": losses_finite,
          "vs_plain": cmp_pre, "vs_plain_fold_forced": cmp_fold,
          "seconds_first_loss_and_backward": first_step_s,
          "seconds_host_graph_per_step": graph_s,
          "seconds_per_step": step_s, "seconds_per_step_plain": step_plain_s,
          "ok": train_ok})

    kernels = [{
        "name": "fused_edge_tail_agg_pregathered", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg.cu",
        "entry": "pregathered",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:278",
        "launches": fit_counts["pregathered"], "max_abs_err": worst(fwd),
        "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "bound_ms": bnd_fwd["bound_ms"], "bound_by": bnd_fwd["bound_by"],
        "tc_bound_ms": bnd_fwd["tc_bound_ms"],
        "tc_bound_by": bnd_fwd["tc_bound_by"],
        "library_ms": None, "ok": train_ok}, {
        "name": "fused_edge_tail_agg_pregathered_bwd", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bwd.cu",
        "entry": "pregathered",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:376",
        "launches": fit_counts["pregathered_bwd"], "max_abs_err": worst(bwd),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bnd_bwd["bound_ms"], "bound_by": bnd_bwd["bound_by"],
        "tc_bound_ms": bnd_bwd["tc_bound_ms"],
        "tc_bound_by": bnd_bwd["tc_bound_by"],
        "library_ms": None, "ok": train_ok}, {
        "name": "segment_sum", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/segment_sum.cu",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:79",
        "launches": fit_counts["segment_sum"],
        "max_abs_err": seg_cmp["vs_plain"]["max_abs_err"],
        "ms": seg_ms, "plain_ms": seg_plain_ms,
        "bound_ms": bnd_seg["bound_ms"], "bound_by": bnd_seg["bound_by"],
        "library_ms": seg_lib_ms, "ok": train_ok}]
    return ((0 if train_ok else 13), kernels,
            {"fused_edge_tail_agg": {
                "launches_cnn2d": slice_fold + fit_counts["fold"],
                "max_abs_err_2d_eval_shape": fold_2d["max_abs_err"],
                "ms_2d_eval_shape": fold_2d["ms"],
                "plain_ms_2d_eval_shape": fold_2d["plain_ms"],
                "bound_ms_2d_eval_shape": fold_2d["bound_ms"],
                "tc_bound_ms_2d_eval_shape": fold_2d["tc_bound_ms"]}})


def gnn_small_graph():
    """A small graph for the width-128 kernels: 40 nodes on a line with
    radius-0.12 neighbours, node 5 isolated (a receiver of degree 0), and
    node 0 receiving four edges from each other node (156 edges: a receiver
    that starts in one 64-edge tile of the forward, fills the next and ends
    in a third)."""
    from magnet_tpu_torch.ops.graph import csr_from_edges, radius_graph

    n = 40
    pos = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    s, r = radius_graph(torch.from_numpy(pos), 0.12, loop=False)
    keep = (r != 0) & (s != 5) & (r != 5)
    hub = torch.tensor([j for j in range(n) if j != 5] * 4,
                       dtype=torch.int32).sort().values
    return csr_from_edges(torch.cat([hub, s[keep]]),
                          torch.cat([torch.zeros_like(hub), r[keep]]), n)


def gnn_operands(entry, graph, l1, seed, dev):
    """The width-128 operands of the fold (``fused_edge_tail_agg``) or pe
    (``fused_edge_tail_agg_pe``) entry on a graph, of the fold operands'
    scales."""
    h = 128
    if entry == "fold":
        return kernel_operands(graph, h, h, h, l1, seed, dev)
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    gr = graph.to(dev)
    n, e = graph.n_node, graph.n_edge
    return (f(e, h), f(n, h), f(n, h), gr.senders, gr.rowptr, gr.snd_ptr,
            gr.snd_perm, f(l1, h, h), f(l1, h), f(h, h), f(h),
            1 + f(h, scale=0.1), f(h, scale=0.1))


def tie_receivers(entry, ops, l1):
    """The receivers of the edges whose recomputed pre-activations (any
    layer, in float64) lie within 1e-5 of zero relative to that layer's
    RMS: relu ties, where the kernel and the plain version may take the
    other side of 0 and differ by O(1) in that edge's gradient.  ``ops``
    are the fold, pre-gathered or pe entry's operands."""
    d = [t.double() if t.is_floating_point() else t for t in ops]
    if entry == "fold":
        e0, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest = d[:9]
        z = e0 @ we + be + pxj[senders.long()]
    elif entry == "pregathered":
        z, pxi, rowptr, w_rest, b_rest = d[:5]
    else:
        pe, pxj, pxi, senders, rowptr = d[:5]
        w_rest, b_rest = d[7], d[8]
        z = pe + pxj[senders.long()]
    n = rowptr.numel() - 1
    deg = (rowptr[1:] - rowptr[:-1]).long()
    receivers = torch.repeat_interleave(torch.arange(n, device=z.device), deg)
    z = z + pxi[receivers]
    near = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    for k in range(l1 + 1):
        near |= (z.abs() < 1e-5 * z.pow(2).mean().sqrt()).any(1)
        if k < l1:
            z = torch.relu(z) @ w_rest[k] + b_rest[k]
    return torch.unique(receivers[near])


def gnn_loss_and_grads(m, impl, batch, graphs):
    """A MAgNet[GNN] model's training loss on ``batch`` and every
    parameter's gradient, on lane ``impl``."""
    m.impl = impl
    m.zero_grad(set_to_none=True)
    loss, _ = m.loss(batch, graphs, train=True)
    loss.backward()
    m.impl = "kernel"
    return loss.detach(), {k: p.grad.clone()
                           for k, p in m.named_parameters()}


def gnn_vs_plain(m, impl, want, batch, graphs) -> dict:
    """``gnn_loss_and_grads`` on lane ``impl`` against ``want``, the plain
    path's, with the kernels' launches in that step."""
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import segment as seg

    fe.reset_launches()
    seg.launches = 0
    loss_k, grads_k = gnn_loss_and_grads(m, impl, batch, graphs)
    counts = {**fe.launch_counts(), "segment_sum": seg.launches}
    loss_p, grads_p = want
    l2 = {k: float((grads_k[k].double() - grads_p[k].double()).norm()
                   / grads_p[k].double().norm().clamp_min(1e-30))
          for k in grads_p}
    worst_k = max(l2, key=l2.get)
    fin = all(bool(torch.isfinite(v).all()) for v in grads_k.values())
    rel = float((loss_k - loss_p).abs() / loss_p.abs())
    return {"impl": impl, "launches": counts,
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_err": rel, "loss_rtol": TRAIN_LOSS_RTOL,
            "worst_grad_rel_l2": l2[worst_k], "worst_grad": worst_k,
            "grad_rel_l2_tol": TRAIN_GRAD_L2, "grads_finite": fin,
            "ok": (fin and l2[worst_k] <= TRAIN_GRAD_L2
                   and rel <= TRAIN_LOSS_RTOL)}


def bf16_step(cmp) -> bool:
    """``gnn_vs_plain``'s record of a bf16 step, held as the cnn_bf16 group
    holds its step: finite gradients and the loss within 1e-3 of the plain
    path's (the kernels and the plain versions round at the same points,
    their f32 sums in another order; the worst gradient's relative L2 is
    reported)."""
    cmp.pop("grad_rel_l2_tol")
    cmp["loss_rtol"] = 1e-3
    cmp["ok"] = cmp["grads_finite"] and cmp["loss_rel_err"] <= 1e-3
    return cmp["ok"]


def gnn_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``gnn_kernel``, ``gnn_kernel_bwd``, ``gnn_slice`` and
    ``gnn_train``: the width-128 fold kernels (#8, #9), the pe kernels (#6,
    #7, with #1 for d_pxj) and the two MAgNet[GNN] 1D paths.  Returns the
    exit code (0: all passed), the four kernels' entries and the launches
    of the segment sum (#1) on these paths."""
    from magnet_tpu_torch.config import MAGNET_GNN
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import cuda_build
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import segment as seg
    from magnet_tpu_torch.utils import to_device

    hp = dict(MAGNET_GNN)
    h = hp["mlp_hidden"]
    l1 = hp["mlp_layers"] - 1
    mp = hp["num_message_passing_steps"]
    ts = hp["time_slice"]
    model = create_model("magnet_gnn", hp, device=dev, seed=0)
    eval_batches = data["gnn_eval"]
    loaders = data["gnn_loaders"]
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    eg = model.build_graph(to_device(eval_batches[0], dev))
    tg = model.build_graph(batch0)
    graphs = {"eval_lr": eg.lr, "eval_all": eg.all, "train_lr": tg.lr,
              "train_all": tg.all}
    small = gnn_small_graph()
    fns = {"fold": (fe.fused_edge_tail_agg, fe.fused_edge_tail_agg_plain,
                    fe.fused_edge_tail_agg_bwd,
                    fe.fused_edge_tail_agg_bwd_plain, fe.GRAD_NAMES),
           "pe": (fe.fused_edge_tail_agg_pe, fe.fused_edge_tail_agg_pe_plain,
                  fe.fused_edge_tail_agg_pe_bwd,
                  fe.fused_edge_tail_agg_pe_bwd_plain, fe.GRAD_NAMES_PE)}

    # 15. #8 at width 128 and #6 vs plain on the eval batch's and the
    # training batch's LR and LR ∪ HR graphs, on a graph that crosses the
    # forward's tiles in every way, and on the small graph (a degree-0
    # receiver, a receiver over three tiles, and the last 7 edge rows cut
    # off, so that the kernel clamps the last receiver's range); both
    # entries give the same bits run to run
    tiles = tile_edges_graph(fe.FWD_TILE, seed=35)
    tile_zero = tiles.degree.to(dev) == 0
    fwd = {}
    for entry, (fn, plain, *_) in fns.items():
        rows = {}
        for label, gr in graphs.items():
            ops = gnn_operands(entry, gr, l1, seed=31, dev=dev)
            got = fn(*ops)
            torch.cuda.synchronize()
            b = (bound("fwd", gr, h, h, h, l1) if entry == "fold"
                 else pregathered_bound("fwd", gr, h, h, l1, pe=True))
            rows[label] = {
                "n_node": gr.n_node, "n_edge": gr.n_edge, "lane": gr.lane,
                "mean_degree": float(gr.degree.mean()),
                "max_degree": int(gr.degree.max()),
                **compare(got, plain(*ops), KERNEL_RTOL, KERNEL_ATOL),
                "ms": cuda_ms(lambda: fn(*ops), reps=30),
                "plain_ms": cuda_ms(lambda: plain(*ops), reps=10),
                **b, **tc_bound(b)}
            rows[label]["share_of_tc_bound"] = (rows[label]["tc_bound_ms"]
                                                / rows[label]["ms"])
            if label == "eval_all":
                rows["bits_equal_run_to_run"] = {
                    "ok": torch.equal(fn(*ops), fn(*ops))}
            del ops, got
        ops = gnn_operands(entry, tiles, l1, seed=36, dev=dev)
        got = fn(*ops)
        rows["tile_edges"] = compare(got, plain(*ops), KERNEL_RTOL,
                                     KERNEL_ATOL)
        rows["tile_edges"].update(
            n_edge=tiles.n_edge, tile=fe.FWD_TILE,
            max_degree=int(tiles.degree.max()),
            n_degree0=int(tile_zero.sum()),
            degree0_row_zero=bool((got[tile_zero] == 0).all()))
        ops = gnn_operands(entry, small, GNN_SMALL_L1, seed=32, dev=dev)
        got = fn(*ops)
        torch.cuda.synchronize()
        rows["small_case"] = compare(got, plain(*ops), KERNEL_RTOL,
                                     KERNEL_ATOL)
        rows["small_case"]["degree0_row_zero"] = bool((got[5] == 0).all())
        rows["small_case"]["max_degree"] = int(small.degree.max())
        cut = small.n_edge - 7
        rowptr = ops[6 if entry == "fold" else 4]
        clamped = rowptr.clamp(max=cut)
        if entry == "fold":
            short = (ops[0][:cut], *ops[1:5], ops[5][:cut], rowptr, *ops[7:])
            want = plain(*short[:6], clamped, *short[7:])
            got = fn(*short)
        else:
            short = (ops[0][:cut], None, None, ops[1], ops[2], ops[3][:cut],
                     rowptr, *ops[7:])
            want = plain(ops[0][:cut], ops[1], ops[2], ops[3][:cut], clamped,
                         None, None, *ops[7:])
            got = fe._launch_fwd("pe", *short)
        torch.cuda.synchronize()
        rows["clamped_range"] = compare(got, want, KERNEL_RTOL, KERNEL_ATOL)
        fwd[entry] = rows
    # the width-128 pre-gathered entry rides on the same body; no path
    # launches it, so it is held against plain here alone, and timed with
    # its plain version at the eval LR ∪ HR graph
    pre = {}
    for label, gr, l1_ in (("small_case", small, GNN_SMALL_L1),
                           ("tile_edges", tiles, l1),
                           ("eval_all", graphs["eval_all"], l1)):
        o = pregathered_operands(gr, h, h, l1_, seed=37, dev=dev)
        got = fe.fused_edge_tail_agg_pregathered(*o)
        pre[label] = compare(got, fe.fused_edge_tail_agg_pregathered_plain(*o),
                             KERNEL_RTOL, KERNEL_ATOL)
        zero = gr.degree.to(dev) == 0
        pre[label]["degree0_row_zero"] = bool((got[zero] == 0).all())
        if label == "eval_all":
            b = pregathered_bound("fwd", gr, h, h, l1_)
            pre[label].update(
                n_edge=gr.n_edge,
                ms=cuda_ms(lambda: fe.fused_edge_tail_agg_pregathered(*o),
                           reps=30),
                plain_ms=cuda_ms(
                    lambda: fe.fused_edge_tail_agg_pregathered_plain(*o),
                    reps=10), **b, **tc_bound(b))
        del o, got
    fwd["pregathered_w128"] = pre
    kernel_ok = all(r["ok"] and r.get("degree0_row_zero", True)
                    for rows in fwd.values() for r in rows.values()) and all(
        gr.lane == "fold" for gr in graphs.values())
    emit({"phase": "gnn_kernel", "h": h, "c": h, "ce": h, "l1": l1,
          "small_case_l1": GNN_SMALL_L1,
          "tolerance": {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
          "fold_w128": fwd["fold"], "pe": fwd["pe"],
          "pregathered_w128": pre, "library_ms": None,
          "ptxas": ptxas_lines(cuda_build.build("fused_edge_tail_agg")),
          "ok": kernel_ok})
    if not kernel_ok:
        return 14, [], {}

    # 16. #9 at width 128 and #7 (+ #1 for d_pxj) vs plain, every
    # gradient: elementwise on the small graph, by relative L2 at the
    # training batch's LR ∪ HR graph with the elements outside the bound
    # counted; g is zero on the receivers of relu ties (tie_receivers)
    g_gen = torch.Generator().manual_seed(33)
    bwd = {}
    for entry, (_, _, fn_bwd, plain_bwd, names) in fns.items():
        rows = {}
        for label, gr, l1_ in (("train_shape", tg.all, l1),
                               ("small_case", small, GNN_SMALL_L1)):
            ops = gnn_operands(entry, gr, l1_, seed=34, dev=dev)
            g = torch.randn(gr.n_node, h, generator=g_gen).to(dev)
            ties = tie_receivers(entry, ops, l1_)
            g[ties] = 0.0
            got_g = fn_bwd(*ops, g)
            torch.cuda.synchronize()
            want_g = plain_bwd(*ops, g)
            rows[label] = {
                name: compare_grad(a, b, elementwise=label == "small_case")
                for name, a, b in zip(names, got_g, want_g)}
            rows[label]["tie_receivers_zeroed"] = {"n": int(ties.numel()),
                                                   "ok": True}
            if label == "small_case":
                rows[label]["degree0_row_zero"] = {
                    "ok": bool((got_g[names.index("pxi")][5] == 0).all())}
            else:
                timing_ops, timing_g = ops, g
        if entry == "fold":
            ms = cuda_ms(lambda: fn_bwd(*timing_ops, timing_g), reps=20)
            bnd = bound("bwd", tg.all, h, h, h, l1)
        else:
            o = timing_ops
            kernel_only = (o[0], None, None, o[1], o[2], o[3], o[4], *o[7:],
                           timing_g)
            ms = cuda_ms(lambda: fe._launch_bwd("pe", *kernel_only), reps=20)
            rows["with_segment_sum_ms"] = cuda_ms(
                lambda: fn_bwd(*timing_ops, timing_g), reps=20)
            bnd = pregathered_bound("bwd", tg.all, h, h, l1, pe=True)
        rows.update(ms=ms, plain_ms=cuda_ms(
            lambda: plain_bwd(*timing_ops, timing_g), reps=5), **bnd,
            **tc_bound(bnd))
        bwd[entry] = rows
        del timing_ops, timing_g
    bwd_ok = all(v["ok"] for rows in bwd.values() for case in rows.values()
                 if isinstance(case, dict) for v in case.values())
    emit({"phase": "gnn_kernel_bwd", "n_node": tg.all.n_node,
          "n_edge": tg.all.n_edge, "l1": l1,
          "tolerance": {"rtol": BWD_RTOL, "atol_rel_to_max": BWD_ATOL_REL,
                        "max_rel_l2": BWD_L2,
                        "elementwise": "small_case only"},
          "fold_w128": bwd["fold"], "pe": bwd["pe"],
          "ptxas": ptxas_lines(cuda_build.build("fused_edge_tail_agg_bwd")),
          "library_ms": None, "ok": bwd_ok})
    if not bwd_ok:
        return 15, [], {}

    # 17. the eval slice: evaluate() on 16 Heat trajectories in one batch,
    # on the fold lane (the graph's), then on the pe lane; each vs plain
    nt_test = data["gnn_eval"][0]["t"].shape[1]
    n_win = (nt_test - ts) // ts
    per_batch = n_win * 2 * mp
    lanes = {}
    for impl, counter in (("kernel", "fused_edge_fold128_fwd"),
                          ("kernel_pe", "fused_edge_pe_fwd")):
        model.impl = impl
        fe.reset_launches()
        seg.launches = 0
        t0 = time.perf_counter()
        metrics, preds = evaluate(model, eval_batches, dev,
                                  return_predictions=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {**fe.launch_counts(), "segment_sum": seg.launches}
        want_counts = {k: (per_batch * len(eval_batches) if k == counter
                           else 0) for k in counts}
        torch.cuda.reset_peak_memory_stats()
        steady_s = timed(lambda: evaluate(model, eval_batches, dev))
        lanes[impl] = {"metrics": metrics, "preds": preds,
                       "launches": counts, "expected_launches": want_counts,
                       "seconds_per_batch_first": first_s / len(eval_batches),
                       "seconds_per_batch": steady_s / len(eval_batches),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    model.impl = "plain"
    t0 = time.perf_counter()
    metrics_plain, preds_plain = evaluate(model, eval_batches, dev,
                                          return_predictions=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    model.impl = "kernel"
    slice_ok = True
    for impl, lane in lanes.items():
        preds = lane.pop("preds")
        lane["vs_plain"] = compare(torch.cat(preds), torch.cat(preds_plain),
                                   SLICE_RTOL, SLICE_ATOL)
        if impl == "kernel_pe":
            lane["vs_fold_lane"] = compare(torch.cat(preds), fold_preds,
                                           SLICE_RTOL, SLICE_ATOL)
        fold_preds = torch.cat(preds)
        lane["finite"] = all(bool(torch.isfinite(p).all()) for p in preds) \
            and all(np.isfinite(v) for v in lane["metrics"].values())
        lane["shape_ok"] = all(
            tuple(p.shape) == (b["hr_points"].shape[0], n_win * ts, 128, 1)
            for p, b in zip(preds, eval_batches))
        lane["ok"] = (lane["launches"] == lane["expected_launches"]
                      and lane["finite"] and lane["shape_ok"]
                      and lane["vs_plain"]["ok"]
                      and lane.get("vs_fold_lane", {"ok": True})["ok"])
        slice_ok = slice_ok and lane["ok"]
    del preds, preds_plain, fold_preds
    emit({"phase": "gnn_slice", "model": "magnet_gnn",
          "batches": len(eval_batches), "batch_size": GNN_EVAL_TRAJ,
          "nt": nt_test, "nx": 256, "L": 128, "N": 128,
          "windows": n_win, "launches_per_batch": per_batch,
          "eval_lr_graph": {"n_node": eg.lr.n_node, "n_edge": eg.lr.n_edge},
          "eval_all_graph": {"n_node": eg.all.n_node,
                             "n_edge": eg.all.n_edge},
          "lanes": lanes, "plain_metrics": metrics_plain,
          "seconds_per_batch_plain": plain_s / len(eval_batches),
          "ok": slice_ok})
    if not slice_ok:
        return 16, [], {}
    slice_counts = {impl: lane["launches"] for impl, lane in lanes.items()}

    # 18. training: Trainer.fit at full width on the fold lane (the
    # graphs'); one step on the pe lane; both vs plain; one noisy step
    nt_train = loaders["train"].dataset.data["t"].shape[1]
    per_step = ((nt_train - ts) // ts) * 2 * mp
    tmodel = create_model("magnet_gnn", hp, device=dev, seed=0)
    first_step_s = timed(lambda: gnn_loss_and_grads(tmodel, "kernel",
                                                      batch0, tg))
    plain = gnn_loss_and_grads(tmodel, "plain", batch0, tg)
    cmp_fold = gnn_vs_plain(tmodel, "kernel", plain, batch0, tg)
    cmp_pe = gnn_vs_plain(tmodel, "kernel_pe", plain, batch0, tg)
    del plain
    cmp_fold["expected_launches"] = {
        k: per_step if k in ("fused_edge_fold128_fwd",
                             "fused_edge_fold128_bwd") else 0
        for k in cmp_fold["launches"]}
    cmp_pe["expected_launches"] = {
        k: per_step if k in ("fused_edge_pe_fwd", "fused_edge_pe_bwd",
                             "segment_sum") else 0
        for k in cmp_pe["launches"]}
    for c in (cmp_fold, cmp_pe):
        c["ok"] = c["ok"] and c["launches"] == c["expected_launches"]
    noisy = create_model("magnet_gnn", {**hp, "noise": 0.01}, device=dev,
                         seed=0)
    with torch.no_grad():
        noisy_loss = float(noisy.loss(batch0, tg, train=True)[0])
        clean_loss = float(tmodel.loss(batch0, tg, train=True)[0])
    noise_ok = bool(np.isfinite(noisy_loss)) and noisy_loss != clean_loss
    del tmodel, noisy

    n_epochs, steps = 2, len(loaders["train"])
    val_batches = len(loaders["val"])

    def reset():
        fe.reset_launches()
        seg.launches = 0

    fit, resumed = fit_checkpoint_resume(
        lambda: create_model("magnet_gnn", hp, device=dev, seed=0), hp,
        loaders, dev, n_epochs, reset,
        lambda: {**fe.launch_counts(), "segment_sum": seg.launches})
    fit_counts = fit["launches"]
    n_steps = steps * n_epochs
    want_fit = {k: 0 for k in fit_counts}
    want_fit["fused_edge_fold128_fwd"] = per_step * (
        n_steps + val_batches * n_epochs)
    want_fit["fused_edge_fold128_bwd"] = per_step * n_steps
    host_batches = list(loaders["train"])
    graph_s = timed(lambda: [resumed.model.build_graph(to_device(b, dev))
                             for b in host_batches]) / steps
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    resumed.model.impl = "plain"
    step_plain_s = timed(lambda: [resumed.train_step(b)
                                  for b in host_batches]) / steps
    resumed.model.impl = "kernel"
    train_ok = (fit_counts == want_fit and fit["losses_finite"]
                and cmp_fold["ok"] and cmp_pe["ok"] and noise_ok
                and fit["checkpoint_ok"] and fit["resume_ok"])
    emit({"phase": "gnn_train", "model": "magnet_gnn",
          "batch_size": loaders["train"].batch_size, "nt": nt_train,
          "val_batches_per_epoch": val_batches,
          "windows_per_step": per_step // (2 * mp),
          "data": {"train_trajectories": len(loaders["train"].dataset),
                   "seconds_to_make": data["gnn_seconds"]},
          "train_lr_graph": {"n_node": tg.lr.n_node, "n_edge": tg.lr.n_edge},
          "train_all_graph": {"n_node": tg.all.n_node,
                              "n_edge": tg.all.n_edge},
          **fit, "expected_launches": want_fit,
          "launches_per_train_step": per_step,
          "vs_plain": cmp_fold, "vs_plain_pe_lane": cmp_pe,
          "noise": {"scale": 0.01, "loss": noisy_loss,
                    "loss_without": clean_loss, "ok": noise_ok},
          "seconds_first_loss_and_backward": first_step_s,
          "seconds_host_graph_per_step": graph_s,
          "seconds_per_step": step_s, "seconds_per_step_plain": step_plain_s,
          "ok": train_ok})

    ev, ev_pe = fwd["fold"]["eval_all"], fwd["pe"]["eval_all"]
    fold_launches = (slice_counts["kernel"]["fused_edge_fold128_fwd"]
                     + fit_counts["fused_edge_fold128_fwd"])
    pe_launches = (slice_counts["kernel_pe"]["fused_edge_pe_fwd"]
                   + cmp_pe["launches"]["fused_edge_pe_fwd"])
    kernels = [{
        "name": "fused_edge_tail_agg_w128", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg.cu",
        "entry": "fold", "widths": [h, h, h],
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1356",
        "launches": fold_launches, "max_abs_err": worst(fwd["fold"]),
        "ms": ev["ms"], "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "tc_bound_ms": ev["tc_bound_ms"],
        "tc_bound_by": ev["tc_bound_by"], "library_ms": None,
        "shape": "eval LR ∪ HR graph", "ok": train_ok}, {
        "name": "fused_edge_tail_agg_bwd_w128", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bwd.cu",
        "entry": "fold", "widths": [h, h, h],
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1665",
        "launches": fit_counts["fused_edge_fold128_bwd"],
        "max_abs_err": worst(bwd["fold"]), "ms": bwd["fold"]["ms"],
        "plain_ms": bwd["fold"]["plain_ms"],
        "bound_ms": bwd["fold"]["bound_ms"],
        "bound_by": bwd["fold"]["bound_by"], "library_ms": None,
        "tc_bound_ms": bwd["fold"]["tc_bound_ms"],
        "tc_bound_by": bwd["fold"]["tc_bound_by"],
        "shape": "training LR ∪ HR graph", "ok": train_ok}, {
        "name": "fused_edge_tail_agg_pe", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg.cu",
        "entry": "pe", "widths": [h, h],
        "replaces": "magnet_tpu/ops/pallas_kernels.py:929",
        "launches": pe_launches, "max_abs_err": worst(fwd["pe"]),
        "ms": ev_pe["ms"], "plain_ms": ev_pe["plain_ms"],
        "bound_ms": ev_pe["bound_ms"], "bound_by": ev_pe["bound_by"],
        "tc_bound_ms": ev_pe["tc_bound_ms"],
        "tc_bound_by": ev_pe["tc_bound_by"], "library_ms": None,
        "rides_on": "fused_edge_tail_agg_w128 (the width-128 body of #8)",
        "shape": "eval LR ∪ HR graph", "ok": train_ok}, {
        "name": "fused_edge_tail_agg_pe_bwd", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg_bwd.cu",
        "entry": "pe", "widths": [h, h],
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1046",
        "launches": cmp_pe["launches"]["fused_edge_pe_bwd"],
        "max_abs_err": worst(bwd["pe"]), "ms": bwd["pe"]["ms"],
        "plain_ms": bwd["pe"]["plain_ms"], "bound_ms": bwd["pe"]["bound_ms"],
        "bound_by": bwd["pe"]["bound_by"], "library_ms": None,
        "tc_bound_ms": bwd["pe"]["tc_bound_ms"],
        "tc_bound_by": bwd["pe"]["tc_bound_by"],
        "shape": "training LR ∪ HR graph", "ok": train_ok}]
    return ((0 if train_ok else 17), kernels,
            {"segment_sum": {"launches_gnn": cmp_pe["launches"]["segment_sum"]}})



def falls(epoch_losses) -> bool:
    """Whether a fit's training loss fell below its first epoch's.  With
    one step an epoch the loss need not fall every step: MAgNet[GNN] 2D's
    INR term overshoots on Adam's second step at lr 1e-3 and comes back
    (``gnn2d_train``'s ``epoch_train_losses``)."""
    return min(epoch_losses[1:]) < epoch_losses[0]


def gnn2d_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``gnn2d_kernel``, ``gnn2d_slice`` and ``gnn2d_train``:
    MAgNet[GNN] 2D (P = 2) at the published 512-node irregular
    configuration, on the width-128 fold kernels (#8, #9) and the pe lane
    (#6, #7 with #1).  The kernels' rows are the ``gnn`` group's; this group
    returns its launches and its times at its own graphs for them."""
    from magnet_tpu_torch.config import MAGNET_GNN
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import segment as seg
    from magnet_tpu_torch.utils import to_device

    hp = {**MAGNET_GNN, **GNN2D_HP}
    h, l1 = hp["mlp_hidden"], hp["mlp_layers"] - 1
    mp, ts = hp["num_message_passing_steps"], hp["time_slice"]
    kind = "h5_implicit_gnn_2d"

    def new_model(**extra):
        return create_model("magnet_gnn", {**hp, **extra}, device=dev, seed=0,
                            kind=kind)

    model = new_model()
    eval_batches = data["gnn2d_eval"]
    loaders = data["gnn2d_loaders"]
    loaders["train"].set_epoch(0)
    batch0 = to_device(next(iter(loaders["train"])), dev)
    eg = model.build_graph(to_device(eval_batches[0], dev))
    tg = model.build_graph(batch0)
    graphs = {"eval_all": eg.all, "eval_lr": eg.lr, "train_all": tg.all,
              "train_lr": tg.lr}

    t_phase = time.perf_counter()
    # 19. #8 at width 128 vs plain on the four graphs of this path (the eval
    # batch's regular LR and LR ∪ HR graphs, every receiver of degree 3 or
    # 5; the training batch's irregular ones, receivers of degree 1 to 11),
    # timed, bit-equal run to run at the largest; #9 vs plain at both
    # training graphs by relative L2 with g zero on the receivers of relu
    # ties, timed at LR ∪ HR
    fwd = {}
    for label, gr in graphs.items():
        ops = gnn_operands("fold", gr, l1, seed=41, dev=dev)
        got = fe.fused_edge_tail_agg(*ops)
        torch.cuda.synchronize()
        b = bound("fwd", gr, h, h, h, l1)
        row = {"n_node": gr.n_node, "n_edge": gr.n_edge, "lane": gr.lane,
               "mean_degree": float(gr.degree.mean()),
               "max_degree": int(gr.degree.max()),
               "n_degree1": int((gr.degree == 1).sum()),
               **compare(got, fe.fused_edge_tail_agg_plain(*ops),
                         KERNEL_RTOL, KERNEL_ATOL),
               "ms": cuda_ms(lambda: fe.fused_edge_tail_agg(*ops), reps=30),
               "plain_ms": cuda_ms(
                   lambda: fe.fused_edge_tail_agg_plain(*ops), reps=10),
               **b, **tc_bound(b)}
        row["share_of_tc_bound"] = row["tc_bound_ms"] / row["ms"]
        if label == "eval_all":
            row["bits_equal_run_to_run"] = torch.equal(
                fe.fused_edge_tail_agg(*ops), fe.fused_edge_tail_agg(*ops))
            row["ok"] = row["ok"] and row["bits_equal_run_to_run"]
        fwd[label] = row
        del ops, got
    g_gen = torch.Generator().manual_seed(43)
    bwd = {}
    for label in ("train_all", "train_lr"):
        gr = graphs[label]
        ops = gnn_operands("fold", gr, l1, seed=44, dev=dev)
        g = torch.randn(gr.n_node, h, generator=g_gen).to(dev)
        ties = tie_receivers("fold", ops, l1)
        g[ties] = 0.0
        got_g = fe.fused_edge_tail_agg_bwd(*ops, g)
        torch.cuda.synchronize()
        want_g = fe.fused_edge_tail_agg_bwd_plain(*ops, g)
        row = {name: compare_grad(a, b, elementwise=False)
               for name, a, b in zip(fe.GRAD_NAMES, got_g, want_g)}
        row["ok"] = all(v["ok"] for v in row.values())
        row.update(n_node=gr.n_node, n_edge=gr.n_edge,
                   tie_receivers_zeroed=int(ties.numel()))
        if label == "train_all":
            b = bound("bwd", gr, h, h, h, l1)
            row.update(
                ms=cuda_ms(lambda: fe.fused_edge_tail_agg_bwd(*ops, g),
                           reps=20),
                plain_ms=cuda_ms(
                    lambda: fe.fused_edge_tail_agg_bwd_plain(*ops, g), reps=5),
                **b, **tc_bound(b))
            row["share_of_tc_bound"] = row["tc_bound_ms"] / row["ms"]
        bwd[label] = row
        del ops, g, got_g, want_g
    kernel_ok = (all(r["ok"] for r in fwd.values())
                 and all(r["ok"] for r in bwd.values())
                 and all(gr.lane == "fold" for gr in graphs.values()))
    emit({"phase": "gnn2d_kernel", "h": h, "c": h, "ce": h, "l1": l1,
          "tolerance": {"fwd": {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
                        "bwd": {"rtol": BWD_RTOL,
                                "atol_rel_to_max": BWD_ATOL_REL,
                                "max_rel_l2": BWD_L2,
                                "elementwise": "no (training shapes)"}},
          "fold_w128": fwd, "fold_w128_bwd": bwd, "library_ms": None,
          "seconds": time.perf_counter() - t_phase, "ok": kernel_ok})
    if not kernel_ok:
        return 18, [], {}

    # 20. the eval slice: evaluate() on the regular 32 x 32 test batch of
    # 32 on the fold lane (the graphs'), then on the pe lane; each vs plain
    t_phase = time.perf_counter()
    nt_test = eval_batches[0]["t"].shape[1]
    n_win = (nt_test - ts) // ts
    per_batch = n_win * 2 * mp
    n_query = eval_batches[0]["hr_points"].shape[2]
    lanes = {}
    for impl, counter in (("kernel", "fused_edge_fold128_fwd"),
                          ("kernel_pe", "fused_edge_pe_fwd")):
        model.impl = impl
        fe.reset_launches()
        seg.launches = 0
        t0 = time.perf_counter()
        metrics, preds = evaluate(model, eval_batches, dev,
                                  return_predictions=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {**fe.launch_counts(), "segment_sum": seg.launches}
        want_counts = {k: (per_batch * len(eval_batches) if k == counter
                           else 0) for k in counts}
        torch.cuda.reset_peak_memory_stats()
        steady_s = timed(lambda: evaluate(model, eval_batches, dev))
        lanes[impl] = {"metrics": metrics, "preds": preds,
                       "launches": counts, "expected_launches": want_counts,
                       "seconds_per_batch_first": first_s / len(eval_batches),
                       "seconds_per_batch": steady_s / len(eval_batches),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    model.impl = "plain"
    t0 = time.perf_counter()
    metrics_plain, preds_plain = evaluate(model, eval_batches, dev,
                                          return_predictions=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    model.impl = "kernel"
    slice_ok = True
    for impl, lane in lanes.items():
        preds = lane.pop("preds")
        lane["vs_plain"] = compare(torch.cat(preds), torch.cat(preds_plain),
                                   SLICE_RTOL, SLICE_ATOL)
        if impl == "kernel_pe":
            lane["vs_fold_lane"] = compare(torch.cat(preds), fold_preds,
                                           SLICE_RTOL, SLICE_ATOL)
        fold_preds = torch.cat(preds)
        lane["finite"] = all(bool(torch.isfinite(p).all()) for p in preds) \
            and all(np.isfinite(v) for v in lane["metrics"].values())
        lane["shape_ok"] = all(
            tuple(p.shape) == (b["hr_points"].shape[0], n_win * ts, n_query, 1)
            for p, b in zip(preds, eval_batches))
        lane["ok"] = (lane["launches"] == lane["expected_launches"]
                      and lane["finite"] and lane["shape_ok"]
                      and lane["vs_plain"]["ok"]
                      and lane.get("vs_fold_lane", {"ok": True})["ok"])
        slice_ok = slice_ok and lane["ok"]
    del preds, preds_plain, fold_preds
    emit({"phase": "gnn2d_slice", "model": "magnet_gnn", "pos_dim": 2,
          "datamodule": "h5_datamodule_implicit_gnn_2d", "grid": "32 x 32",
          "batches": len(eval_batches),
          "batch_size": eval_batches[0]["t"].shape[0], "nt": nt_test,
          "time_slice": ts, "L": eval_batches[0]["coords_lr"].shape[1],
          "N": n_query, "windows": n_win, "launches_per_batch": per_batch,
          "eval_lr_graph": {"n_node": eg.lr.n_node, "n_edge": eg.lr.n_edge},
          "eval_all_graph": {"n_node": eg.all.n_node,
                             "n_edge": eg.all.n_edge},
          "lanes": lanes, "plain_metrics": metrics_plain,
          "seconds_per_batch_plain": plain_s / len(eval_batches),
          "seconds": time.perf_counter() - t_phase, "ok": slice_ok})
    if not slice_ok:
        return 19, [], {}
    slice_counts = {impl: lane["launches"] for impl, lane in lanes.items()}

    # 21. training: Trainer.fit on the irregular split at batch 32 on the
    # fold lane (the graphs'); the first step's loss and gradients on the
    # kernel path and on the pe lane, each vs plain
    t_phase = time.perf_counter()
    nt_train = batch0["t"].shape[1]
    per_step = ((nt_train - ts) // ts) * 2 * mp
    tmodel = new_model()
    first_step_s = timed(lambda: gnn_loss_and_grads(tmodel, "kernel",
                                                      batch0, tg))
    plain = gnn_loss_and_grads(tmodel, "plain", batch0, tg)
    cmp_fold = gnn_vs_plain(tmodel, "kernel", plain, batch0, tg)
    cmp_pe = gnn_vs_plain(tmodel, "kernel_pe", plain, batch0, tg)
    del plain, tmodel
    cmp_fold["expected_launches"] = {
        k: per_step if k in ("fused_edge_fold128_fwd",
                             "fused_edge_fold128_bwd") else 0
        for k in cmp_fold["launches"]}
    cmp_pe["expected_launches"] = {
        k: per_step if k in ("fused_edge_pe_fwd", "fused_edge_pe_bwd",
                             "segment_sum") else 0
        for k in cmp_pe["launches"]}
    for c in (cmp_fold, cmp_pe):
        c["ok"] = c["ok"] and c["launches"] == c["expected_launches"]

    n_epochs, steps = 2, len(loaders["train"])
    val_batches = len(loaders["val"])

    def reset():
        fe.reset_launches()
        seg.launches = 0

    fit, resumed = fit_checkpoint_resume(
        new_model, hp, loaders, dev, n_epochs, reset,
        lambda: {**fe.launch_counts(), "segment_sum": seg.launches})
    fit_counts = fit["launches"]
    n_steps = steps * n_epochs
    want_fit = {k: 0 for k in fit_counts}
    want_fit["fused_edge_fold128_fwd"] = per_step * (
        n_steps + val_batches * n_epochs)
    want_fit["fused_edge_fold128_bwd"] = per_step * n_steps
    # every training batch misses the graph cache: each trajectory
    # has a mesh of its own, and the batch's order changes every epoch
    host_batches = [to_device(b, dev) for b in loaders["train"]]

    def new_graphs():
        for b in host_batches:
            resumed.model.graphs.clear()
            resumed.model.build_graph(b)

    graph_s = timed(new_graphs) / steps
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    resumed.model.impl = "plain"
    step_plain_s = timed(lambda: [resumed.train_step(b)
                                  for b in host_batches]) / steps
    resumed.model.impl = "kernel"
    loss_falls = falls(fit["epoch_train_losses"])
    train_ok = (fit_counts == want_fit and fit["losses_finite"] and loss_falls
                and cmp_fold["ok"] and cmp_pe["ok"] and fit["checkpoint_ok"]
                and fit["resume_ok"])
    emit({"phase": "gnn2d_train", "model": "magnet_gnn", "pos_dim": 2,
          "batch_size": loaders["train"].batch_size, "nt": nt_train,
          "time_slice": ts, "samples": batch0["coords_hr"].shape[1],
          "n_nodes": batch0["hr_frames"].shape[-1],
          "val_batches_per_epoch": val_batches,
          "windows_per_step": per_step // (2 * mp),
          "data": {"train_trajectories": len(loaders["train"].dataset),
                   "seconds_to_make": data["gnn2d_seconds"]},
          "train_lr_graph": {"n_node": tg.lr.n_node, "n_edge": tg.lr.n_edge},
          "train_all_graph": {"n_node": tg.all.n_node,
                              "n_edge": tg.all.n_edge},
          **fit, "expected_launches": want_fit,
          "launches_per_train_step": per_step, "loss_falls": loss_falls,
          "vs_plain": cmp_fold, "vs_plain_pe_lane": cmp_pe,
          "seconds_first_loss_and_backward": first_step_s,
          "seconds_host_graph_per_new_batch": graph_s,
          "seconds_per_step": step_s, "seconds_per_step_plain": step_plain_s,
          "seconds": time.perf_counter() - t_phase, "ok": train_ok})

    def shape_keys(row, label):
        return {f"{k}_gnn2d_{label}": row[k]
                for k in ("n_edge", "ms", "plain_ms", "bound_ms",
                          "tc_bound_ms", "max_abs_err")}

    extra = {
        "fused_edge_tail_agg_w128": {
            "launches_gnn2d": (slice_counts["kernel"]["fused_edge_fold128_fwd"]
                               + fit_counts["fused_edge_fold128_fwd"]),
            **shape_keys(fwd["eval_all"], "eval_all"),
            **shape_keys(fwd["eval_lr"], "eval_lr"),
            **shape_keys(fwd["train_all"], "train_all")},
        "fused_edge_tail_agg_bwd_w128": {
            "launches_gnn2d": fit_counts["fused_edge_fold128_bwd"],
            **{f"{k}_gnn2d_train_all": bwd["train_all"][k]
               for k in ("n_edge", "ms", "plain_ms", "bound_ms",
                         "tc_bound_ms")}},
        "fused_edge_tail_agg_pe": {
            "launches_gnn2d": (slice_counts["kernel_pe"]["fused_edge_pe_fwd"]
                               + cmp_pe["launches"]["fused_edge_pe_fwd"])},
        "fused_edge_tail_agg_pe_bwd": {
            "launches_gnn2d": cmp_pe["launches"]["fused_edge_pe_bwd"]},
        "segment_sum": {"launches_gnn2d": cmp_pe["launches"]["segment_sum"]}}
    return (0 if train_ok else 20), [], extra


def par_train_step(model, batch, graph):
    """One training step's loss and backward (no optimizer)."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch, graph, train=True)
    loss.backward()
    return loss.detach()


def par_loss_and_grads(model, batch, graph) -> dict:
    """One training step's loss and every parameter's gradient, and the
    validation loss."""
    out = {"loss": par_train_step(model, batch, graph)}
    out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.eval()
    out["val_loss"] = model.loss(batch, graph, train=False)[0]
    return out


def par_seconds(model, batch, other, part,
                other_key="seconds_step_whole") -> dict:
    """Host seconds of a training step (loss and backward, device drained)
    on another graph (the whole one, or the halo partition) and on the
    partitioned one, in turns (other, part, part, other), both having run
    once before."""
    times = {other_key: [], "seconds_step": []}
    for key, graph in ((other_key, other), ("seconds_step", part),
                       ("seconds_step", part), (other_key, other)):
        times[key].append(timed(lambda: par_train_step(model, batch, graph)))
    return times


def par_vs_whole(got: dict, want: dict) -> dict:
    """A partitioned step against the unpartitioned one on the card: the
    training loss within TRAIN_LOSS_RTOL and each gradient within
    TRAIN_GRAD_L2 relative L2 (the ``*train`` phases' bounds), the
    validation loss, a free rollout, within SLICE_RTOL (the eval phases')."""
    l2 = {k: float((got["grads"][k].double() - g.double()).norm()
                   / g.double().norm().clamp_min(1e-30))
          for k, g in want["grads"].items()}
    worst = max(l2, key=l2.get)
    rel = {k: float((got[k] - want[k]).abs() / want[k].abs())
           for k in ("loss", "val_loss")}
    fin = all(bool(torch.isfinite(g).all()) for g in got["grads"].values())
    return {"loss": float(got["loss"]), "loss_whole": float(want["loss"]),
            "loss_rel_err": rel["loss"], "loss_rtol": TRAIN_LOSS_RTOL,
            "val_loss": float(got["val_loss"]),
            "val_loss_whole": float(want["val_loss"]),
            "val_loss_rel_err": rel["val_loss"], "val_loss_rtol": SLICE_RTOL,
            "worst_grad_rel_l2": l2[worst], "worst_grad": worst,
            "grad_rel_l2_tol": TRAIN_GRAD_L2, "grads_finite": fin,
            "ok": (fin and l2[worst] <= TRAIN_GRAD_L2
                   and rel["loss"] <= TRAIN_LOSS_RTOL
                   and rel["val_loss"] <= SLICE_RTOL)}


def par_shards(graph) -> list:
    """Each shard graph's edge count and lane (both graphs of MAgNet[GNN];
    overlap and ring: each region's, interior then boundary)."""
    parts = (graph.lr, graph.all) if hasattr(graph, "nbr") else (graph,)
    return [{"edges": p.edge_counts(), "lanes": p.lanes()} for p in parts]


def par_bf16(dev, model, batch, want: dict) -> dict:
    """MAgNet[CNN] 1D with ``graph_dtype=bf16`` on ``model``'s weights,
    G = 2 with the halo exchange, against the whole graph's f32 step
    ``want`` at the bf16 lane's bounds against f32: the training and the
    validation loss within BF16_LOSS_RTOL, each gradient within
    BF16_VS_F32_GRAD_L2 relative L2 or, past it, within BF16_VS_F32_DEEP
    times the whole-graph bf16 step's distance from ``want``.  The
    partitioned processor computes in f32, as the JAX package's does: the
    f32 #8/#9 run on the shard graphs, and no bf16 kernel in the step."""
    from magnet_tpu_torch.config import MAGNET_CNN
    from magnet_tpu_torch.models.factory import create_model

    bf = create_model("magnet_cnn", {**MAGNET_CNN, "graph_dtype": "bf16"},
                      device=dev)
    bf.load_state_dict(model.state_dict())
    whole = par_loss_and_grads(bf, batch, bf.build_graph(batch))
    part = bf.build_graph_partitioned(batch, 2, halo=True)
    reset_every_launch()
    got = par_loss_and_grads(bf, batch, part)
    torch.cuda.synchronize()
    counts = {k: v for k, v in every_launch().items() if v}
    l2 = {k: rel_l2(got["grads"][k], g) for k, g in want["grads"].items()}
    l2_whole = {k: rel_l2(whole["grads"][k], g)
                for k, g in want["grads"].items()}
    worst = max(l2, key=l2.get)
    past = {k: [l2[k], l2_whole[k]] for k in l2
            if l2[k] >= BF16_VS_F32_GRAD_L2
            and l2[k] > BF16_VS_F32_DEEP * l2_whole[k]}
    rel = {k: float((got[k] - want[k]).abs() / want[k].abs())
           for k in ("loss", "val_loss")}
    fin = all(bool(torch.isfinite(g).all()) for g in got["grads"].values())
    bf16_launches = {k: v for k, v in counts.items() if "bf16" in k}
    return {"model": "magnet_cnn", "graph_dtype": "bf16", "graph_shards": 2,
            "halo": True, "shards": par_shards(part), "launches": counts,
            "loss": float(got["loss"]), "loss_whole_f32": float(want["loss"]),
            "loss_whole_bf16": float(whole["loss"]),
            "loss_rel_err": rel["loss"], "val_loss_rel_err": rel["val_loss"],
            "loss_rtol": BF16_LOSS_RTOL, "worst_grad_rel_l2": l2[worst],
            "worst_grad": worst,
            "worst_grad_rel_l2_whole_bf16": max(l2_whole.values()),
            "grad_rel_l2_tol": BF16_VS_F32_GRAD_L2,
            "grad_deep_factor": BF16_VS_F32_DEEP, "grads_past_tol": past,
            "grads_finite": fin,
            "ok": (fin and not past and max(rel.values()) <= BF16_LOSS_RTOL
                   and bool(counts.get("fused_edge_fwd"))
                   and bool(counts.get("fused_edge_bwd"))
                   and not bf16_launches)}


def par_empty_boundary(dev) -> dict:
    """MAgNet[CNN] 1D's processor (published widths, seed 0) on a graph
    whose shard 0 has no boundary edge (``PAR_EMPTY_*``), G = 3: the
    overlap processor against the halo one, forward and backward, on the
    card, beside the halo processor against itself run again (the backward
    kernels' atomics); the region graphs' edges and lanes, and the
    launches."""
    from magnet_tpu_torch.config import MAGNET_CNN
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.parallel import graph_partition as gp
    from magnet_tpu_torch.parallel.mesh import LocalGraphAxis

    model = create_model("magnet_cnn", MAGNET_CNN, device=dev, seed=0)
    n, dx = PAR_EMPTY_NODES, 1.0 / PAR_EMPTY_NODES
    x = np.arange(n) * dx + np.where(np.arange(n) < n // 3, 0.0, 0.5)
    pos = np.stack([x, np.zeros_like(x)], -1)[None].repeat(PAR_EMPTY_BATCH,
                                                           0)
    raw = gp.radius_edges(pos, 1.5 * dx, True)
    c = MAGNET_CNN["latent_dim"]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = PAR_EMPTY_BATCH * n
    nf = torch.randn(rows, c, device=dev, generator=gen)
    p_tab, q_tab = (torch.randn(rows, c, device=dev, generator=gen)
                    for _ in range(2))
    runs = {}
    for run, mode in (("halo", True), ("halo_again", True),
                      ("overlap", "overlap")):
        pg = gp.build_partition_buffers(raw, n, 3, halo=mode)
        part = gp.partitioned_graph(pg, LocalGraphAxis(3), dev,
                                    model.graphs.lane_rule)
        efs = []
        for sg in part.shards:
            s, r = sg.edge_endpoints()
            efs.append(p_tab[s] - q_tab[r])
        x0 = nf.clone().requires_grad_()
        model.zero_grad(set_to_none=True)
        reset_every_launch()
        y = gp.graphnet_processor(model._processor, x0, efs, part)
        (y * torch.cos(y)).sum().backward()
        torch.cuda.synchronize()
        runs[run] = {"y": y.detach(), "dx": x0.grad,
                     "grads": {k: p.grad.clone() for k, p in
                               model._processor.named_parameters()},
                     "edges": part.edge_counts(), "lanes": part.lanes(),
                     "launches": {k: v for k, v in every_launch().items()
                                  if v}}
    want, got = runs["halo"], runs["overlap"]

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-30))

    def worst_of(a, b):
        l2 = {"y": rel(a["y"], b["y"]), "dx": rel(a["dx"], b["dx"]),
              **{k: rel(a["grads"][k], g) for k, g in b["grads"].items()}}
        worst = max(l2, key=l2.get)
        return l2[worst], worst

    (l2, worst), (again, _) = (worst_of(got, want),
                               worst_of(runs["halo_again"], want))
    return {"batch": PAR_EMPTY_BATCH, "nodes": n, "graph_shards": 3,
            "edges": got["edges"], "lanes": got["lanes"],
            "edges_halo": want["edges"], "launches": got["launches"],
            "worst_rel_l2": l2, "worst": worst,
            "halo_again_worst_rel_l2": again,
            "rel_l2_tol": TRAIN_GRAD_L2,
            "ok": (got["edges"][0][1] == 0 and l2 <= TRAIN_GRAD_L2
                   and bool(got["launches"]))}


def par_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``par_local`` and ``par_dist``: graph and data parallelism.

    ``par_local``: the single-process graph axis on the card (every shard
    of a sample there, the all-gather and the all-to-all index copies),
    weights from seed 0: MAgNet[CNN] 1D at its published config on the KS
    batch, G = 2 and 4, all-gather and halo, and G = 4 overlap;
    MAgNet[GNN] 1D at width 128, G = 2, halo and overlap; MPNN-2D at
    PAR_MPNN_LAYERS layers, G = 2.  Each partitioned step (loss, every
    gradient, validation loss) against the unpartitioned one on the card;
    the kernels' launches on the shard graphs and region graphs (#8/#9 at
    widths 64 and 128, the MPNN edge kernels of the shards' lane), each
    shard's (each region's) edges and lane, the seconds to partition, the
    seconds of a step of each (the overlap split's in turns with the halo
    exchange's).  The ring is not run here: in one process it moves the
    same blocks as the all-to-all (``LocalGraphAxis``).  Then MAgNet[CNN]
    1D with graph_dtype=bf16, G = 2 halo, against the whole graph's f32
    step (``par_bf16``), and its processor on a graph with an empty
    boundary region (``par_empty_boundary``).

    ``par_dist`` (alone: group ``par_dist``): ``Trainer.fit`` of
    MAgNet[CNN] 1D over NCCL, one rank a card (``parallel.launch.
    run_ranks``), devices = every card, against this process's fit on the
    global batches (PAR_FIT_RTOL); rank 0's checkpoint read back and
    resumed by this process; with two cards or more also graph_shards = 2
    with the halo exchange, the overlap split and its ring, and with four
    or more graph_shards = 4 with the overlap split and its ring.  Then
    (alone: group ``par_spc``) the dp fit at one step a call and at SPC_K,
    its chunks captured with the NCCL all-reduce inside the CUDA graph, and
    with two cards or more the SPC_K fit with one rank's buckets grown
    mid-fit, against one process and the dp fit at one step a call, each
    rank's eager, captured and replayed steps.  No fallback: a rank that
    fails, or NCCL that does not start or capture, fails the phase."""
    extra = {}
    if "par" in groups:
        rc, extra = par_local(dev, data)
        if rc:
            return rc, [], {}
    spc_only = not {"par", "par_dist"} & set(groups)
    return par_dist(dev, data, spc_only), [], extra


def par_local(dev, data) -> tuple[int, dict]:
    """Phase ``par_local`` (``par_phases``); the exit code and the launches
    on the shard graphs by kernel row."""
    from magnet_tpu_torch.config import MAGNET_CNN, MAGNET_GNN, MPNN_2D
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.utils import to_device

    cases = [("magnet_cnn", MAGNET_CNN, data["ks_loaders"], g, halo)
             for g, halo in ((2, False), (2, True), (4, False), (4, True),
                             (4, "overlap"))]
    cases += [("magnet_gnn", MAGNET_GNN, data["gnn_loaders"], 2, True),
              ("magnet_gnn", MAGNET_GNN, data["gnn_loaders"], 2, "overlap"),
              ("mpnn_2d", {**MPNN_2D, "hidden_layer": PAR_MPNN_LAYERS},
               data["b2d_loaders"], 2, False)]
    records, launches, ok = [], {}, True
    whole, parts, models = {}, {}, {}
    for name, hp, loaders, shards, halo in cases:
        if name not in whole:
            # one batch a model (a loader draws new queries every batch)
            model = create_model(name, hp, device=dev, seed=0)
            batch = to_device(next(iter(loaders["train"])), dev)
            models[name] = model, batch
            whole[name] = par_loss_and_grads(model, batch,
                                             model.build_graph(batch))
        t0 = time.perf_counter()
        part = model.build_graph_partitioned(batch, shards, halo=halo)
        build_s = time.perf_counter() - t0
        parts[name, shards, halo] = part
        reset_every_launch()
        got = par_loss_and_grads(model, batch, part)
        torch.cuda.synchronize()
        counts = {k: v for k, v in every_launch().items() if v}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        # the overlap split timed in turns with the halo exchange
        other = (("seconds_step_halo", parts[name, shards, True])
                 if halo == "overlap"
                 else ("seconds_step_whole", model.build_graph(batch)))
        rec = {"model": name, "graph_shards": shards, "halo": halo,
               "batch": len(batch[next(iter(batch))]),
               "shards": par_shards(part), "launches": counts,
               "seconds_partition": build_s,
               **par_vs_whole(got, whole[name]),
               **par_seconds(model, batch, other[1], part, other[0])}
        ok = ok and rec["ok"] and bool(counts)
        records.append(rec)
    bf16 = par_bf16(dev, *models["magnet_cnn"], whole["magnet_cnn"])
    empty = par_empty_boundary(dev)
    for k, v in (*bf16["launches"].items(), *empty["launches"].items()):
        launches[k] = launches.get(k, 0) + v
    need = ("fused_edge_fwd", "fused_edge_bwd", "fused_edge_fold128_fwd",
            "fused_edge_fold128_bwd")
    mpnn = [k for k in launches if k.startswith(("fwd_", "bwd_"))]
    ok = (ok and bf16["ok"] and empty["ok"]
          and all(launches.get(k) for k in need) and len(mpnn) == 2)
    emit({"phase": "par_local", "cases": records, "bf16": bf16,
          "empty_boundary": empty, "launches": launches,
          "gpu": torch.cuda.get_device_name(0), "ok": ok})
    smi = card()
    for r in records:
        other = ("halo exchange" if "seconds_step_halo" in r
                 else "whole graph")
        print(f"par_local {r['model']} G={r['graph_shards']} "
              f"halo={r['halo']}: s a step {r['seconds_step']} ({other} "
              f"{r.get('seconds_step_halo', r.get('seconds_step_whole'))}); "
              f"s to partition {r['seconds_partition']} ({smi})", flush=True)
    print(f"par_local magnet_cnn bf16 G=2 halo=True: losses "
          f"{bf16['loss_rel_err']}, {bf16['val_loss_rel_err']} from the "
          f"whole graph's f32 step, worst gradient "
          f"{bf16['worst_grad_rel_l2']} ({bf16['worst_grad']}; whole-graph "
          f"bf16 {bf16['worst_grad_rel_l2_whole_bf16']}); launches "
          f"{bf16['launches']} ({smi})", flush=True)
    print(f"par_local empty boundary: edges {empty['edges']}, worst rel L2 "
          f"{empty['worst_rel_l2']} ({empty['worst']}; the halo processor "
          f"run again {empty['halo_again_worst_rel_l2']}; {smi})", flush=True)
    if not ok:
        return 21, {}
    extra = {}
    for row, key in (("fused_edge_tail_agg", "fused_edge_fwd"),
                     ("fused_edge_tail_agg_bwd", "fused_edge_bwd"),
                     ("fused_edge_tail_agg_w128", "fused_edge_fold128_fwd"),
                     ("fused_edge_tail_agg_bwd_w128",
                      "fused_edge_fold128_bwd"),
                     ("fused_mpnn_edge_agg2r", "fwd_gather"),
                     ("fused_mpnn_edge_agg2r_bwd", "bwd_gather"),
                     ("fused_mpnn_edge_agg", "fwd_pregathered"),
                     ("fused_mpnn_edge_agg_bwd", "bwd_pregathered")):
        if launches.get(key):
            extra[row] = {"launches_par": launches[key]}
    return 0, extra


def par_dist(dev, data, spc_only=False) -> int:
    """Phase ``par_dist`` (``par_phases``); its exit code.  ``spc_only``:
    its steps_per_call runs alone."""
    from magnet_tpu_torch.config import MAGNET_CNN
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.parallel.launch import run_ranks
    from magnet_tpu_torch.train.capture_checks import grown_bucket_fit_rank
    from magnet_tpu_torch.train.checkpoint import load_checkpoint
    from magnet_tpu_torch.train.trainer import Trainer

    n = torch.cuda.device_count()
    hp = dict(MAGNET_CNN)
    state = {k: v.cpu() for k, v in
             create_model("magnet_cnn", hp, device=dev, seed=0)
             .state_dict().items()}
    smi = card()

    def model():
        m = create_model("magnet_cnn", hp, device=dev)
        m.load_state_dict(state)
        return m

    def rows_of(workdir):
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def one_process(loaders):
        """This process's fit from the same weights on the same global
        batches: its rows and final weights."""
        with tempfile.TemporaryDirectory() as workdir:
            one = Trainer(model(), max_epochs=PAR_FIT_EPOCHS, lr=hp["lr"],
                          workdir=workdir, device=dev)
            one.fit(loaders["train"], loaders["val"])
            return rows_of(workdir), {k: v.cpu().numpy() for k, v in
                                      one.model.state_dict().items()}

    def run(loaders, one, dp, halo, k=1, grow_rank=None):
        """The fit over n ranks (dp x graph), k steps a call (``grow_rank``:
        that rank's buckets grown mid-fit), against ``one``; rank 0's
        checkpoint read back and resumed by this process."""
        one_rows, one_state = one
        steps = len(loaders["train"])
        with tempfile.TemporaryDirectory() as workdir:
            spec = {"model": "magnet_cnn", "hp": hp, "state": state,
                    "dp": dp, "halo": halo, "loaders": loaders,
                    "max_epochs": PAR_FIT_EPOCHS, "lr": hp["lr"],
                    "workdir": workdir, "device": dev.type,
                    "steps_per_call": k, "grow_rank": grow_rank}
            t0 = time.perf_counter()
            out = run_ranks(grown_bucket_fit_rank, n, (spec,),
                            device=dev.type, timeout_s=PAR_DIST_TIMEOUT)
            fit_s = time.perf_counter() - t0
            last = os.path.join(workdir, "checkpoints", "last.pt")
            saved, meta = load_checkpoint(last, require=("model",
                                                         "optimizer"))
            same = all(np.array_equal(v.numpy(), out[0]["state"][k])
                       for k, v in saved["model"].items())
            agree = all(np.array_equal(r["state"][k], out[0]["state"][k])
                        for r in out for k in out[0]["state"])
            rows = rows_of(workdir)
            resumed = Trainer(create_model("magnet_cnn", hp, device=dev),
                              max_epochs=PAR_FIT_EPOCHS + 1, lr=hp["lr"],
                              workdir=workdir, device=dev)
            resumed.fit(loaders["train"], loaders["val"], resume=last)
            epochs = [r["epoch"] for r in rows_of(workdir)]
        # the ranks' update of the whole model against this process's
        keys = sorted(one_state)
        flat = lambda d: np.concatenate([np.ravel(d[k]) for k in keys])  # noqa: E731
        init = flat({k: v.numpy() for k, v in state.items()})
        upd = float(np.linalg.norm(flat(out[0]["state"]) - flat(one_state))
                    / np.linalg.norm(flat(one_state) - init))
        loss_rel = {f"{key}_{e}": abs(rows[e][key] - one_rows[e][key])
                    / abs(one_rows[e][key])
                    for key in ("train_loss", "val_mae_loss")
                    for e in range(PAR_FIT_EPOCHS)}
        counts = [r["step_counts"] for r in out]
        n_steps = PAR_FIT_EPOCHS * steps
        if k == 1:
            counts_ok = all(c == {"eager": n_steps, "captured": 0,
                                  "replayed": 0} for c in counts)
        else:
            # every rank replays, each capture after one warm-up step; the
            # grown rank captures at least twice (a rank whose own graphs
            # outgrow its bucket captures anew too)
            counts_ok = all(
                c["eager"] + c["replayed"] == n_steps and c["replayed"] > 0
                and c["captured"] == c["eager"]
                and c["captured"] >= 1 + (r == grow_rank)
                for r, c in enumerate(counts))
        rec = {"ranks": n, "devices": dp, "graph_shards": n // dp,
               "halo": halo, "steps_per_call": k, "grow_rank": grow_rank,
               "steps_per_epoch": steps, "step_counts": counts,
               "seconds_launch_and_fit": fit_s,
               "seconds_step": rows[-1]["time"] / steps,
               "seconds_step_one_process": one_rows[-1]["time"] / steps,
               "rank0_rows": rows, "one_process_rows": one_rows,
               "loss_rel_err": loss_rel, "loss_rtol": PAR_FIT_RTOL,
               "update_rel_l2": upd, "update_rel_l2_tol": PAR_UPDATE_L2,
               "checkpoint_is_rank0": same, "ranks_agree": agree,
               "writers": [r["metrics_written"] for r in out],
               "checkpoint_epoch": meta.get("epoch"),
               "resumed_epochs": epochs,
               "resumed_steps": resumed.optimizer.step_count,
               "finite": all(np.isfinite(v) for r in rows
                             for v in r.values())}
        rec["ok"] = (same and agree and rec["finite"] and counts_ok
                     and rec["writers"] == [True] + [False] * (n - 1)
                     and meta.get("epoch") == PAR_FIT_EPOCHS - 1
                     and epochs == list(range(PAR_FIT_EPOCHS + 1))
                     and resumed.optimizer.step_count
                     == (PAR_FIT_EPOCHS + 1) * steps
                     and max(loss_rel.values()) <= PAR_FIT_RTOL
                     and upd <= PAR_UPDATE_L2)
        print(f"par_dist ranks={n} dp={dp} graph={n // dp} halo={halo} "
              f"k={k} grow_rank={grow_rank}: s a step of the last epoch "
              f"{rec['seconds_step']} (one process "
              f"{rec['seconds_step_one_process']}); step counts {counts}; "
              f"losses {max(loss_rel.values())}, update {upd} from one "
              f"process; ok {rec['ok']} ({smi})", flush=True)
        return rec

    records = []
    if not spc_only:
        one = one_process(data["ks_loaders"])
        # graph = 2 on two cards or more; graph = 4 on four or more, so
        # that the ring runs several rotations (and their reverse in the
        # backward)
        runs = ([(n, False)]
                + [(n // 2, halo) for halo in (True, "overlap", "ring")
                   if n >= 2]
                + [(n // 4, halo) for halo in ("overlap", "ring") if n >= 4])
        records += [run(data["ks_loaders"], one, dp, halo)
                    for dp, halo in runs]
    # steps_per_call over dp ranks (two cards or more): the gradients'
    # all-reduce captured with the step, every rank one a step whatever the
    # others decided
    spc = []
    if n >= 2:
        loaders = data["spc_graph_magnet_cnn_loaders"]
        one = one_process(loaders)
        spc = [run(loaders, one, n, False), run(loaders, one, n, False, SPC_K),
               run(loaders, one, n, False, SPC_K, grow_rank=n - 1)]
    else:
        print("par_dist: the steps_per_call runs over dp ranks need two "
              "cards or more", flush=True)
    for rec in spc[1:]:
        base = spc[0]["rank0_rows"]
        rec["loss_rel_err_vs_k1"] = {
            f"{key}_{e}": abs(rec["rank0_rows"][e][key] - base[e][key])
            / abs(base[e][key])
            for key in ("train_loss", "val_mae_loss")
            for e in range(PAR_FIT_EPOCHS)}
        rec["ok"] = rec["ok"] and max(
            rec["loss_rel_err_vs_k1"].values()) <= PAR_FIT_RTOL
    records += spc
    ok = all(r["ok"] for r in records)
    emit({"phase": "par_dist", "runs": records, "ok": ok})
    return 0 if ok else 22


def tune_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phase ``tune``: ``magnet_tpu_torch.tune.main``, TUNE_TRIALS trials of
    MAgNet[CNN] 1D at its published widths on the seeded KS source
    (``TUNE_DATA``), one epoch a trial, over model.params.lr=1e-4:1e-2:log,
    each trial in a work directory of its own under a temporary one.
    Checks: a finite line a trial, the best their minimum, a directory
    each, #8/#9 at width 64 launched (the counts set to 0 before the sweep
    and read after it)."""
    from magnet_tpu_torch import tune

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["model=magnet_cnn", "datamodule.source=synthetic_ks",
                *[f"datamodule.{k}={v}" for k, v in TUNE_DATA.items()],
                "trainer.max_epochs=1", f"sweep.n_trials={TUNE_TRIALS}",
                "name=tune", f"workdir={tmp}/${{name}}",
                "--space", "model.params.lr=1e-4:1e-2:log"]
        reset_every_launch()
        t0 = time.perf_counter()
        out = tune.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in every_launch().items() if v}
        dirs = out["workdirs"]
        own = (len(set(dirs)) == TUNE_TRIALS
               and all(os.path.exists(os.path.join(d, "metrics.jsonl"))
                       for d in dirs))
    vals = [t["val_mae_loss"] for t in out["trials"]]
    ok = (len(vals) == TUNE_TRIALS and all(np.isfinite(vals))
          and out["best"]["best_value"] == min(vals) and own
          and bool(counts.get("fused_edge_fwd"))
          and bool(counts.get("fused_edge_bwd")))
    smi = card()
    emit({"phase": "tune", "trials": out["trials"], "best": out["best"],
          "workdirs_own": own, "launches": counts, "seconds": seconds,
          "nvidia_smi": smi, "ok": ok})
    print(f"tune: {TUNE_TRIALS} trials in {seconds} s ({smi})", flush=True)
    if not ok:
        return 23, [], {}
    return 0, [], {"fused_edge_tail_agg": {
                       "launches_tune": counts["fused_edge_fwd"]},
                   "fused_edge_tail_agg_bwd": {
                       "launches_tune": counts["fused_edge_bwd"]}}


def reset_every_launch() -> None:
    """Set the launch count of every kernel of the port to 0."""
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import mpnn_edge as me
    from magnet_tpu_torch.ops import segment as seg

    fe.reset_launches()
    me.reset_launches()
    seg.launches = seg.launches_bf16 = 0


def every_launch() -> dict:
    """The launch count of every kernel of the port, by name."""
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops import mpnn_edge as me
    from magnet_tpu_torch.ops import segment as seg

    return {**fe.launch_counts(), **me.launches, "segment_sum": seg.launches,
            "segment_sum_bf16": seg.launches_bf16}


def fno_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``fno_1d`` and ``fno_2d``: each FNO at full width and batch 32
    through ``evaluate`` (its eval loss against the CPU path's on the same
    batch) and ``Trainer.fit`` (falling loss, checkpoint, resume).  FNO runs
    none of the port's kernels: every launch count stays 0."""
    from magnet_tpu_torch.config import FNO_1D, FNO_2D
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.utils import to_device

    for name, hp in (("fno_1d", FNO_1D),
                     ("fno_2d", {**FNO_2D, "num_layers": FNO_2D_SMOKE_LAYERS})):
        t_phase = time.perf_counter()
        loaders = data[f"{name}_loaders"]
        eval_batches = list(loaders["test"])
        model = create_model(name, hp, device=dev, seed=0)
        reset_every_launch()
        t0 = time.perf_counter()
        metrics, preds = evaluate(model, eval_batches, dev,
                                  return_predictions=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        eval_counts = every_launch()
        torch.cuda.reset_peak_memory_stats()
        steady_s = timed(lambda: evaluate(model, eval_batches, dev))
        peak_eval = torch.cuda.max_memory_allocated()
        cpu_metrics, cpu_preds = evaluate(
            create_model(name, hp, device="cpu", seed=0), eval_batches, "cpu",
            return_predictions=True)
        vs_cpu = {k: {"card": metrics[k], "cpu": cpu_metrics[k],
                      "rel_err": abs(metrics[k] - cpu_metrics[k])
                      / abs(cpu_metrics[k])}
                  for k in ("test_loss", "test_mae_loss")}
        pred, pred_cpu = torch.cat(preds).cpu().double(), \
            torch.cat(cpu_preds).double()
        vs_cpu["predictions_rel_l2"] = float((pred - pred_cpu).norm()
                                             / pred_cpu.norm())
        eval_ok = (all(v["rel_err"] <= FNO_LOSS_RTOL for k, v in
                       vs_cpu.items() if k.startswith("test_"))
                   and bool(torch.isfinite(pred).all())
                   and pred.shape == pred_cpu.shape)
        del preds, cpu_preds, pred, pred_cpu

        n_epochs, steps = 2, len(loaders["train"])
        fit, resumed = fit_checkpoint_resume(
            lambda: create_model(name, hp, device=dev, seed=0), hp, loaders,
            dev, n_epochs, reset_every_launch, every_launch)
        host_batches = [to_device(b, dev) for b in loaders["train"]]
        step_s = timed(lambda: [resumed.train_step(b)
                                for b in host_batches]) / steps
        # every launch since the first fit began: both fits and the steps
        fit["launches"] = every_launch()
        del resumed, host_batches
        loss_falls = falls(fit["epoch_train_losses"])
        no_launches = (not any(eval_counts.values())
                       and not any(fit["launches"].values()))
        ok = (eval_ok and fit["losses_finite"] and loss_falls
              and fit["checkpoint_ok"] and fit["resume_ok"] and no_launches)
        u = eval_batches[0]["u"]
        emit({"phase": name, "model": name, "width": hp["width"],
              "num_layers": hp["num_layers"],
              "time_history": hp["time_history"],
              "batch_size": u.shape[0], "u_shape": list(u.shape),
              "windows": (u.shape[1] - hp["time_history"])
              // hp["time_future"], "eval_batches": len(eval_batches),
              "metrics": metrics, "vs_cpu": vs_cpu,
              "loss_rtol_vs_cpu": FNO_LOSS_RTOL,
              "launches_eval": eval_counts,
              "no_kernel_launches": no_launches,
              "seconds_per_batch_first": first_s / len(eval_batches),
              "seconds_per_batch": steady_s / len(eval_batches),
              "peak_mem_bytes_eval": peak_eval, **fit,
              "loss_falls": loss_falls, "seconds_per_step": step_s,
              "seconds": time.perf_counter() - t_phase, "ok": ok})
        if not ok:
            return 21, [], {}
    return 0, [], {}


def host_latents(model, seed: int) -> None:
    """Make ``model`` draw its latents on the host from a generator seeded
    ``seed`` here, in order, whatever its device: two models so prepared
    and run alike take the same latents."""
    gen = torch.Generator().manual_seed(seed)
    model.draw_latent = lambda shape, generator: torch.randn(
        shape, generator=gen).to(generator.device)


def no_interaction_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phases ``ni_slice`` and ``ni_train``: MAgNet[CNN] no-interaction at
    its published width through ``evaluate`` (the 16 Heat trajectories;
    its eval loss against the CPU path's on a cut batch with the same
    latents) and ``Trainer.fit`` (the scatter branch, falling loss,
    checkpoint, resume; one teacher-forcing step).  It runs none of the
    port's kernels: every launch count stays 0."""
    from magnet_tpu_torch.config import MAGNET_CNN_NO_INTERACTION as hp
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.utils import to_device

    name = "magnet_cnn_no_interaction"

    def make(device, **over):
        return create_model(name, {**hp, **over}, device=device, seed=0)

    # ni_slice
    t_phase = time.perf_counter()
    eval_batches = data["heat"]
    model = make(dev)
    reset_every_launch()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, preds = evaluate(model, eval_batches, dev,
                              return_predictions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eval_counts = every_launch()
    steady_s = timed(lambda: evaluate(model, eval_batches, dev))
    peak_eval = torch.cuda.max_memory_allocated()
    pred = torch.cat(preds)
    ts = hp["time_slice"]
    b0 = eval_batches[0]
    n_traj, nt, _, nx = b0["hr_frames"].shape
    # one decoder step's attention alone (AttnSeq2Seq.attend: attn_1 over
    # (M, T, 3H), tanh, attn_2, softmax, context) at this batch's shape;
    # the batch runs it time_slice times a window
    g = torch.Generator(device=dev).manual_seed(2)
    m_seq, width = n_traj * nx, hp["lstm_hidden"]
    enc = torch.randn(m_seq, ts, width, generator=g, device=dev)
    state = tuple(torch.randn(hp["lstm_layers"], m_seq, width, generator=g,
                              device=dev) for _ in range(2))
    with torch.no_grad():
        attend_ms = cuda_ms(lambda: model.attend(state, enc), reps=20)
    attend_calls = (nt - ts) // ts * ts
    del enc, state
    pred_ok = (bool(torch.isfinite(pred).all())
               and tuple(pred.shape) == (n_traj, (nt - ts) // ts * ts, nx, 1))
    del preds, pred
    # card vs CPU: the first NI_CPU_TRAJ trajectories, first NI_CPU_NT times
    cut = [{k: (v[:NI_CPU_TRAJ, :NI_CPU_NT] if k in (
        "t", "lr_frames", "hr_frames", "hr_points") else v[:NI_CPU_TRAJ])
        for k, v in b0.items()}]
    on_card, on_cpu = make(dev), make("cpu")
    host_latents(on_card, seed=1)
    host_latents(on_cpu, seed=1)
    card_metrics, card_preds = evaluate(on_card, cut, dev,
                                        return_predictions=True)
    t0 = time.perf_counter()
    cpu_metrics, cpu_preds = evaluate(on_cpu, cut, "cpu",
                                      return_predictions=True)
    cpu_s = time.perf_counter() - t0
    vs_cpu = {k: {"card": card_metrics[k], "cpu": cpu_metrics[k],
                  "rel_err": abs(card_metrics[k] - cpu_metrics[k])
                  / abs(cpu_metrics[k])}
              for k in ("test_loss", "test_mae_loss")}
    got, want = card_preds[0].cpu().double(), cpu_preds[0].double()
    vs_cpu["predictions_rel_l2"] = float((got - want).norm() / want.norm())
    vs_cpu["predictions_max_abs_err"] = float((got - want).abs().max())
    eval_ok = (pred_ok and all(np.isfinite(v) for v in metrics.values())
               and all(v["rel_err"] <= NI_LOSS_RTOL for k, v in
                       vs_cpu.items() if k.startswith("test_")))
    no_launches = not any(eval_counts.values())
    ok = eval_ok and no_launches
    emit({"phase": "ni_slice", "model": name,
          "lstm_hidden": hp["lstm_hidden"], "lstm_layers": hp["lstm_layers"],
          "res_layers": hp["res_layers"], "n_chan": hp["n_chan"],
          "time_slice": ts, "batch_size": n_traj, "nt": nt, "nx": nx,
          "sequences_per_window": n_traj * nx,
          "windows": (nt - ts) // ts, "eval_batches": len(eval_batches),
          "metrics": metrics, "predictions_ok": pred_ok,
          "vs_cpu": vs_cpu, "vs_cpu_cut": {"trajectories": NI_CPU_TRAJ,
                                           "nt": NI_CPU_NT,
                                           "cpu_seconds": cpu_s},
          "loss_rtol_vs_cpu": NI_LOSS_RTOL, "launches_eval": eval_counts,
          "no_kernel_launches": no_launches,
          "seconds_per_batch_first": first_s / len(eval_batches),
          "seconds_per_batch": steady_s / len(eval_batches),
          "peak_mem_bytes_eval": peak_eval,
          "attend_ms": attend_ms, "attend_calls_per_batch": attend_calls,
          "attend_share_of_batch": attend_ms * attend_calls / 1e3
          / (steady_s / len(eval_batches)),
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    del model, on_card, on_cpu, card_preds, cpu_preds
    if not ok:
        return 22, [], {}

    # ni_train
    t_phase = time.perf_counter()
    loaders = data["ks_loaders"]
    n_epochs, steps = 2, len(loaders["train"])
    fit, resumed = fit_checkpoint_resume(
        lambda: make(dev), hp, loaders, dev, n_epochs, reset_every_launch,
        every_launch)
    host_batches = [to_device(b, dev) for b in loaders["train"]]
    torch.cuda.reset_peak_memory_stats()
    step_s = timed(lambda: [resumed.train_step(b)
                            for b in host_batches]) / steps
    peak_step = torch.cuda.max_memory_allocated()
    # both training branches on one batch: the scatter branch (the YAML's
    # teacher_forcing false, which the fit ran) and teacher forcing
    branches = {}
    for tf in (False, True):
        m = make(dev, teacher_forcing=tf).train()
        loss, _ = m.loss(host_batches[0], None, train=True)
        loss.backward()
        branches["teacher_forcing" if tf else "scatter"] = {
            "loss": loss.item(),
            "grads_finite": all(bool(torch.isfinite(p.grad).all())
                                for p in m.parameters())}
    # every launch since the first fit began: both fits, the steps and
    # the two branches
    fit["launches"] = every_launch()
    b, nt, n, _ = host_batches[0]["hr_points"].shape
    del resumed, host_batches, m
    branches_ok = all(np.isfinite(b["loss"]) and b["grads_finite"]
                      for b in branches.values())
    loss_falls = falls(fit["epoch_train_losses"])
    no_launches = not any(fit["launches"].values())
    ok = (fit["losses_finite"] and loss_falls and fit["checkpoint_ok"]
          and fit["resume_ok"] and branches_ok and no_launches)
    emit({"phase": "ni_train", "model": name, "batch_size": b,
          "queries": n, "nt": nt, "windows": (nt - ts) // ts, **fit,
          "loss_falls": loss_falls, "branches": branches,
          "no_kernel_launches": no_launches, "seconds_per_step": step_s,
          "peak_mem_bytes_step": peak_step,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        return 23, [], {}
    return 0, [], {}


def rel_l2_of(got: dict, want: dict) -> tuple[float, str]:
    """The worst relative L2 distance over a dict of tensors, and its key."""
    l2 = {k: float((got[k].double() - want[k].double()).norm()
                   / want[k].double().norm().clamp_min(1e-30)) for k in want}
    worst_k = max(l2, key=l2.get)
    return l2[worst_k], worst_k


def remat_step(model, batch, graphs, remat: bool) -> dict:
    """One training step's forward and backward (``loss(train=True)``, every
    parameter's gradient) with each GraphNet processor's ``remat`` set to
    ``remat``, from the launch counts at 0: the loss, the gradients, the
    launches, the step's host seconds and its peak device memory."""
    from magnet_tpu_torch.nn.graphnet import GraphProcessor

    for proc in model.modules():
        if isinstance(proc, GraphProcessor):
            proc.remat = remat
    model.zero_grad(set_to_none=True)
    reset_every_launch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, _ = model.loss(batch, graphs, train=True)
    loss.backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return {"loss": loss.detach(), "launches": every_launch(),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "seconds": secs, "peak": peak, "peak_over_start": peak - base}


def remat_case(label, model, batch, graphs, fwd_key, bwd_key,
               calls_per_step) -> dict:
    """``remat`` off against on for one model and batch: a warm-up step
    each way, then off, on, on, off (times in turns).  Holds the loss bit for bit,
    every gradient within REMAT_GRAD_L2 relative L2 of the first step
    without ``remat`` (reporting the second one's distance, the atomics'
    noise), the forward kernel's launches at twice the ``calls_per_step``
    processor-step calls a step, the backward kernel's and every other
    count unchanged."""
    for remat in (False, True):
        remat_step(model, batch, graphs, remat)
    runs = [remat_step(model, batch, graphs, r)
            for r in (False, True, True, False)]
    off, on = runs[0], runs[1]
    total = {}
    for r in runs:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    l2, worst = rel_l2_of(on["grads"], off["grads"])
    noise, noise_k = rel_l2_of(runs[3]["grads"], off["grads"])
    want_on = dict(off["launches"], **{fwd_key: 2 * calls_per_step})
    launches_ok = (off["launches"][fwd_key] == calls_per_step
                   and off["launches"][bwd_key] == calls_per_step
                   and all(r["launches"] == want_on for r in runs[1:3])
                   and runs[3]["launches"] == off["launches"])
    loss_equal = all(torch.equal(r["loss"], off["loss"]) for r in runs[1:])
    fin = all(bool(torch.isfinite(v).all()) for v in on["grads"].values())
    out = {
        "case": label, "loss": float(off["loss"]),
        "loss_bit_equal": loss_equal,
        "worst_grad_rel_l2": l2, "worst_grad": worst,
        "grad_rel_l2_tol": REMAT_GRAD_L2,
        "off_again_worst_grad_rel_l2": noise, "off_again_worst_grad": noise_k,
        "grads_finite": fin,
        "launches_off": {k: v for k, v in off["launches"].items() if v},
        "launches_on": {k: v for k, v in on["launches"].items() if v},
        "predicted": {fwd_key: {"off": calls_per_step,
                                "on": 2 * calls_per_step},
                      bwd_key: {"off": calls_per_step,
                                "on": calls_per_step}},
        "launches_as_predicted": launches_ok,
        "peak_mem_bytes": {"off": off["peak"], "on": on["peak"]},
        "peak_mem_bytes_over_start": {"off": off["peak_over_start"],
                                      "on": on["peak_over_start"]},
        "seconds_step": {"off": [runs[0]["seconds"], runs[3]["seconds"]],
                         "on": [runs[1]["seconds"], runs[2]["seconds"]]},
        "launches_total": total,
        "ok": (loss_equal and fin and launches_ok and l2 <= REMAT_GRAD_L2)}
    return out


def remat_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phase ``remat``: one training step's forward and backward with each
    GraphNet processor step recomputed in the backward (``remat``) against
    the same step without it, from the same weights and batch, at full
    width and depth: MAgNet[CNN] 2D at the datamodule's batch of 32 (the
    pre-gathered lane: #2, #3 and #1), MAgNet[GNN] 1D in f32 (#8 / #9 at
    width 128) and in bf16 (their bf16 builds).  Returns the launches of
    its steps as extra counts of those kernels' rows."""
    from magnet_tpu_torch.config import (
        DATAMODULE_IMPLICIT_2D,
        DATAMODULE_IMPLICIT_GNN,
        MAGNET_CNN_2D,
        MAGNET_GNN,
    )
    from magnet_tpu_torch.data.loader import collate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.utils import to_device

    t_phase = time.perf_counter()
    smi = card()
    records = []
    # MAgNet[CNN] 2D: 32 samples of the cnn2d group's training trajectories
    # (its 24, then 8 of them again with other queries)
    ds = data["cnn2d_loaders"]["train"].dataset
    ds.set_epoch(0)
    items = [ds[i] for i in range(len(ds))]
    ds.set_epoch(1)
    items += [ds[i] for i in range(REMAT_CNN2D_BATCH - len(items))]
    hp = dict(MAGNET_CNN_2D)
    model = create_model("magnet_cnn_2d", hp, device=dev, seed=0)
    batch = to_device(collate(items), dev)
    graph = model.build_graph(batch)
    ts, mp = hp["time_slice"], hp["num_message_passing_steps"]
    windows = (DATAMODULE_IMPLICIT_2D["nt_train"] - ts) // ts
    key = ("fused_edge_pregathered" if graph.lane == "pregathered"
           else "fused_edge")
    records.append(dict(remat_case(
        "magnet_cnn_2d", model, batch, graph, f"{key}_fwd", f"{key}_bwd",
        windows * mp),
        batch_size=REMAT_CNN2D_BATCH, lane=graph.lane, n_edge=graph.n_edge))
    del model, batch, graph
    # MAgNet[GNN] 1D: the gnn group's first training batch (32), f32 and bf16
    loader = data["gnn_loaders"]["train"]
    loader.set_epoch(0)
    host = next(iter(loader))
    ts, mp = MAGNET_GNN["time_slice"], MAGNET_GNN["num_message_passing_steps"]
    windows = (DATAMODULE_IMPLICIT_GNN["nt_train"] - ts) // ts
    for dtype, suffix in (("float32", ""), ("bf16", "_bf16")):
        hp = {**MAGNET_GNN, "graph_dtype": dtype}
        model = create_model("magnet_gnn", hp, device=dev, seed=0)
        batch = to_device(host, dev)
        graphs = model.build_graph(batch)
        records.append(dict(remat_case(
            f"magnet_gnn_{dtype}", model, batch, graphs,
            f"fused_edge_fold128{suffix}_fwd",
            f"fused_edge_fold128{suffix}_bwd", windows * 2 * mp),
            batch_size=loader.batch_size, lane=graphs.all.lane,
            n_edge=graphs.all.n_edge + graphs.lr.n_edge))
        del model, batch, graphs
    ok = all(r["ok"] for r in records)
    for r in records:
        print(f"remat {r['case']}: loss {r['loss']} bit-equal "
              f"{r['loss_bit_equal']}, worst gradient {r['worst_grad_rel_l2']}"
              f" ({r['worst_grad']}; off again "
              f"{r['off_again_worst_grad_rel_l2']}), launches off "
              f"{r['launches_off']} on {r['launches_on']}, peak "
              f"MB off {r['peak_mem_bytes']['off'] / 2**20:.1f} on "
              f"{r['peak_mem_bytes']['on'] / 2**20:.1f}, s a step off "
              f"{r['seconds_step']['off']} on {r['seconds_step']['on']} "
              f"({smi})", flush=True)
    emit({"phase": "remat", "nvidia_smi": smi, "cases": [
        {k: v for k, v in r.items() if k != "launches_total"}
        for r in records], "seconds": time.perf_counter() - t_phase,
        "ok": ok})
    if not ok:
        return 46, [], {}
    extra = {}
    for row, key in (
            ("fused_edge_tail_agg_pregathered", "fused_edge_pregathered_fwd"),
            ("fused_edge_tail_agg_pregathered_bwd",
             "fused_edge_pregathered_bwd"),
            ("fused_edge_tail_agg", "fused_edge_fwd"),
            ("fused_edge_tail_agg_bwd", "fused_edge_bwd"),
            ("segment_sum", "segment_sum"),
            ("fused_edge_tail_agg_w128", "fused_edge_fold128_fwd"),
            ("fused_edge_tail_agg_bwd_w128", "fused_edge_fold128_bwd"),
            ("fused_edge_tail_agg_bf16_w128", "fused_edge_fold128_bf16_fwd"),
            ("fused_edge_tail_agg_bf16_w128_bwd",
             "fused_edge_fold128_bf16_bwd")):
        n = sum(r["launches_total"].get(key, 0) for r in records)
        if n:
            extra[row] = {"launches_remat": n}
    return 0, [], extra


class PlainAdam:
    """The plain reference of ``train.optim.StepDecayAdam``: a
    non-capturable ``torch.optim.Adam`` whose rate is set as a Python float
    before each update and whose finite check is read back to the host, a
    dropped update not reaching Adam at all."""

    def __init__(self, params, lr, weight_decay, factor, step_size,
                 steps_per_epoch, skip_nonfinite):
        self.params, self.skip = list(params), skip_nonfinite
        self.rate = lambda s: lr * factor ** (s // steps_per_epoch
                                              // step_size)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.step_count = self.notfinite_count = 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        from magnet_tpu_torch.train.optim import MAX_CONSECUTIVE_NONFINITE

        if self.skip:
            finite = all(bool(torch.isfinite(p.grad).all())
                         for p in self.params if p.grad is not None)
            if not finite and self.notfinite_count < MAX_CONSECUTIVE_NONFINITE:
                self.notfinite_count += 1
                return False
            self.notfinite_count = 0
        for group in self.adam.param_groups:
            group["lr"] = self.rate(self.step_count)
        self.adam.step()
        self.step_count += 1
        return True

    def state_dict(self):
        return {"adam": self.adam.state_dict(), "step": self.step_count,
                "notfinite_count": self.notfinite_count}


#: the kernels of #10 and #11 in a profiler trace, by launch counter: the
#: parts every name of one of them holds
MPNN_SYMBOLS = {"fwd_gather": ("fused_mpnn_edge_agg_kernel",),
                "bwd_gather": ("fused_mpnn_edge_agg_bwd_kernel",)}


def traced_launches(events, symbols: dict) -> dict:
    """Launches of each kernel of ``symbols`` (counter -> parts of its
    name) among a profiler's device ``events``."""
    return {key: sum(e.count for e in events if all(p in e.key for p in parts))
            for key, parts in symbols.items()}


def spc_fit(name, hp, loaders, dev, k, workdir, skip_nonfinite=False,
            profiled=False, plain_adam=False, symbols=MPNN_SYMBOLS,
            kind=None, impl="kernel", eager=False) -> tuple[object, dict]:
    """``Trainer.fit`` of ``name`` (seed 0; ``kind`` the datamodule's,
    ``impl`` the GraphNet lane) for SPC_EPOCHS epochs with ``k`` steps a
    call (``plain_adam``: with ``PlainAdam`` in place of the trainer's
    optimizer; ``eager``: with ``EagerStep`` in place of the capture): the
    trainer and its record (each step's metrics in order,
    the launches its wrappers counted, eager / captured / replayed steps,
    the last epoch's seconds a step and, ``profiled``, the launches of the
    kernels of ``symbols`` in a ``torch.profiler`` trace of the fit)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.train.capture_checks import EagerStep
    from magnet_tpu_torch.train.trainer import Trainer

    # on standard error, so that the end of a failed run names its fit
    print(f"chip_smoke: fit {name} {hp.get('graph_dtype', 'float32')} "
          f"{kind or ''} impl={impl} k={k} profiled={profiled} "
          f"eager={eager}", file=sys.stderr, flush=True)
    model = create_model(name, hp, device=dev, seed=0, kind=kind)
    if impl != "kernel":
        model.impl = impl
    trainer = Trainer(model,
                      max_epochs=SPC_EPOCHS, lr=hp["lr"],
                      weight_decay=hp["weight_decay"], factor=hp["factor"],
                      step_size=hp["step_size"], workdir=workdir, device=dev,
                      steps_per_call=k, skip_nonfinite=skip_nonfinite)
    steps = []
    run_chunk, setup = trainer._run_chunk, trainer.setup

    def recorded(chunk):
        out = run_chunk(chunk)
        steps.extend(out)
        return out

    def plain_setup(steps_per_epoch):
        setup(steps_per_epoch)
        trainer.optimizer = PlainAdam(
            trainer.optimizer.params, hp["lr"], hp["weight_decay"],
            hp["factor"], hp["step_size"], steps_per_epoch, skip_nonfinite)

    trainer._run_chunk = recorded
    if plain_adam:
        trainer.setup = plain_setup
    fit = lambda: trainer.fit(loaders["train"], loaders["val"])  # noqa: E731
    traced = {}
    reset_every_launch()
    if eager:
        trainer.step_capture = EagerStep
    if profiled:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fit_s = timed(fit)
        traced = traced_launches(
            [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA], symbols)
    else:
        fit_s = timed(fit)
    counted = every_launch()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    per_epoch = len(loaders["train"])
    return trainer, {
        "k": k, "step_losses": [float(m["loss"]) for m in steps],
        "launches_counted": {n: v for n, v in counted.items() if v},
        "launches_traced": traced, "fit_profiled": profiled,
        "steps": dict(trainer.step_counts), "captures": len(trainer.captured),
        "seconds_fit": fit_s,
        "seconds_per_step_last_epoch": rows[-1]["time"] / per_epoch,
        "rows": rows}


def spc_nonfinite(hp, loaders, dev) -> dict:
    """FNO-1D fits with ``skip_nonfinite`` on training data with a NaN in
    one trajectory, one step a call and SPC_K, and one step a call with
    ``PlainAdam``: the update of the NaN's batch is dropped each epoch, on
    the device in the eager step as in the captured one, so the step
    counts, the per-step losses (NaN where the NaN's batch was) and the
    final weights of SPC_K are those of one step a call, bit for bit; and
    within SPC_PLAIN_FIT_LOSS_RTOL / SPC_PLAIN_FIT_WEIGHT_L2 of the plain
    Adam's, which drops the update on the host (``spc_plain_updates``
    compares the two on the same gradients)."""
    fits = {}
    with tempfile.TemporaryDirectory() as workdir:
        for label, k, plain in (("k1", 1, False), (f"k{SPC_K}", SPC_K, False),
                                ("plain", 1, True)):
            fits[label] = spc_fit("fno_1d", hp, loaders, dev, k,
                                  os.path.join(workdir, label),
                                  skip_nonfinite=True, plain_adam=plain)
    (one, f1), (kk, fk) = fits["k1"], fits[f"k{SPC_K}"]
    plain, fp = fits["plain"]
    steps = SPC_EPOCHS * len(loaders["train"])
    a, b = np.array(f1["step_losses"]), np.array(fk["step_losses"])
    c = np.array(fp["step_losses"])
    weights_equal = all(torch.equal(p, q) for p, q in
                        zip(one.model.parameters(), kk.model.parameters()))
    finite = all(bool(torch.isfinite(p).all())
                 for p in kk.model.parameters())
    counts = (one.optimizer.step_count, kk.optimizer.step_count,
              plain.optimizer.step_count)
    live = ~np.isnan(c)
    plain_loss_rel = float(np.max(np.abs(a[live] - c[live])
                                  / np.abs(c[live])))
    flat = [flat_weights(t.model.parameters()) for t in (one, plain)]
    diff = (flat[0] - flat[1]).abs()
    plain_l2 = float(diff.norm() / flat[1].norm())
    first = int(np.argmax(~np.isnan(c)))     # the first applied update
    first_equal = bool(np.array_equal(a[:first + 1], c[:first + 1],
                                      equal_nan=True))
    plain_ok = (bool(np.array_equal(np.isnan(a), np.isnan(c)))
                and first_equal
                and plain_loss_rel <= SPC_PLAIN_FIT_LOSS_RTOL
                and plain_l2 <= SPC_PLAIN_FIT_WEIGHT_L2)
    ok = (bool(np.array_equal(a, b, equal_nan=True)) and weights_equal
          and finite and counts == (steps - SPC_EPOCHS,) * 3
          and fk["steps"]["replayed"] == steps - 1
          and int(np.isnan(a).sum()) == SPC_EPOCHS and plain_ok)
    return {"applied_updates": counts, "steps": steps,
            "nan_steps": int(np.isnan(a).sum()),
            "losses_equal": bool(np.array_equal(a, b, equal_nan=True)),
            "weights_bit_equal": weights_equal, "weights_finite": finite,
            "k_steps": fk["steps"],
            "vs_plain_adam": {"step_losses_plain": fp["step_losses"],
                              "losses_to_first_update_bit_equal":
                                  first_equal,
                              "max_step_loss_rel_err": plain_loss_rel,
                              "weights_rel_l2": plain_l2,
                              "max_weight_diff_over_lr":
                                  float(diff.max()) / hp["lr"],
                              "weights_off_by_over_a_tenth_of_lr":
                                  int((diff > 0.1 * hp["lr"]).sum()),
                              "weights": diff.numel(),
                              "loss_rtol": SPC_PLAIN_FIT_LOSS_RTOL,
                              "weights_rel_l2_tol": SPC_PLAIN_FIT_WEIGHT_L2,
                              "ok": plain_ok},
            "ok": ok}


def flat_weights(params) -> torch.Tensor:
    """Every weight in one f64 vector (a complex one as its two parts)."""
    return torch.cat([(torch.view_as_real(p) if p.is_complex() else p)
                      .detach().reshape(-1).double() for p in params])


def spc_plain_updates(hp, dev) -> dict:
    """``train.optim.StepDecayAdam`` (capturable, deciding on the device)
    against ``PlainAdam`` on the same gradients: FNO-1D's parameters (seed
    0), SPC_UPDATES seeded gradients (a NaN in two, an inf in one) with
    ``skip_nonfinite``, the rate decayed every second update; after each
    update the weights' change from their start within
    SPC_PLAIN_UPDATE_RTOL relative L2 of the plain one's, and the same
    updates dropped."""
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.train.optim import make_optimizer

    model = create_model("fno_1d", hp, device=dev, seed=0)
    ours = [p.detach().clone().requires_grad_() for p in model.parameters()]
    theirs = [p.detach().clone().requires_grad_() for p in ours]
    args = (hp["lr"], hp["weight_decay"], hp["factor"], 1, 2)
    opt = make_optimizer(ours, *args, skip_nonfinite=True, max_epochs=8)
    plain = PlainAdam(theirs, *args, skip_nonfinite=True)
    start = flat_weights(ours)
    gen = torch.Generator().manual_seed(5)
    errs, dropped = [], []
    for i in range(SPC_UPDATES):
        grads = [torch.randn(p.shape, dtype=p.dtype, generator=gen) * 1e-2
                 for p in ours]
        if i in (2, 5):
            grads[0].view(-1)[0] = float("nan")
        if i == 6:
            grads[-1].view(-1)[-1] = float("inf")
        for p, q, g in zip(ours, theirs, grads):
            p.grad, q.grad = g.to(dev), g.to(dev)
        opt.step()
        dropped.append(not plain.step())
        a, b = flat_weights(ours), flat_weights(theirs)
        errs.append(float((a - b).norm() / (b - start).norm()))
    ok = (max(errs) <= SPC_PLAIN_UPDATE_RTOL and dropped.count(True) == 3
          and opt.step_count == plain.step_count == SPC_UPDATES - 3)
    return {"change_rel_l2_after_each_update": errs,
            "dropped": dropped, "applied": (opt.step_count,
                                            plain.step_count),
            "tol": SPC_PLAIN_UPDATE_RTOL, "ok": ok}


def spc_epoch(trainer, loader, epoch: int, profiled: bool,
              symbols=MPNN_SYMBOLS, with_graphs=False, host_ops=True) -> dict:
    """One more epoch of ``trainer``'s chunks on ``loader`` (its batches and
    graphs made first, or with ``with_graphs`` a chunk's as it comes, on
    the clock), timed on the host clock, under ``torch.profiler`` when
    ``profiled`` (tracing the host's operators too with ``host_ops``):
    seconds a step and, traced, the device's busy time and idle share (as
    ``trace_train.py`` sums device events), device events, CUDA runtime
    calls and the kernels of ``symbols`` a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loader.set_epoch(epoch)
    k = trainer.steps_per_call
    batches = list(loader)
    chunks = [batches[i:i + k] for i in range(0, len(batches), k)]
    if not with_graphs:
        chunks = [[trainer._host_pair(b) for b in c] for c in chunks]
    n = len(batches)

    def run():
        for c in chunks:
            trainer._run_chunk([trainer._host_pair(b) for b in c]
                               if with_graphs else c)

    torch.cuda.synchronize()
    if not profiled:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return {"seconds_per_step": (time.perf_counter() - t0) / n}
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    devs = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in devs)
    runtime = {e.key: e.count / n for e in events
               if e.key.startswith("cuda") and e.count}
    kernels = {key: c / n for key, c in traced_launches(
        [e for e in events if e.device_type == DeviceType.CUDA],
        symbols).items()}
    return {"seconds_per_step_traced": wall / n,
            "device_busy_ms_per_step": busy_ms / n,
            "device_idle_share_traced": 1.0 - busy_ms / 1e3 / wall,
            "device_events_per_step": sum(c for _, _, c in devs) / n,
            "cuda_runtime_calls_per_step": runtime,
            "kernels_per_step_in_trace": kernels}


def spc_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phase ``spc``: ``Trainer.fit`` of MPNN 1D (its gather lane, #10 and
    #11) and FNO-1D (cuFFT and cuDNN, no kernel of the port) at their
    published widths with ``steps_per_call`` = 1, again 1 (the noise), and
    SPC_K, from the same seed: with SPC_K every chunk shares one graph and
    runs as replays of a captured CUDA graph.  Per-step losses and final
    weights against the first k = 1 fit (FNO-1D bit for bit; MPNN 1D within
    #11's atomics); the MPNN kernels' launches in a profiler trace of each
    MPNN fit (held against the wrappers' counts of the k = 1 fits, and for
    SPC_K against the wrappers' eager launches plus a captured step's
    launches for each replay) and in a profiler trace of an epoch of
    replays; seconds a step (an epoch each way, in turns), the device's
    idle share and launches a step, each way.  Returns the MPNN kernels'
    launches in the fits' traces as extra counts of their rows."""
    from magnet_tpu_torch.config import FNO_1D, MPNN

    t_phase = time.perf_counter()
    smi = card()
    records, extra = [], {}
    for name in SPC_MODELS:
        hp = {**(MPNN if name == "mpnn" else FNO_1D), **SPC_DEPTH[name]}
        loaders = data[f"spc_{name}_loaders"]
        per_epoch = len(loaders["train"])
        fits, trainers = {}, {}
        t_model = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            for label, k in (("k1", 1), ("k1_again", 1), (f"k{SPC_K}", SPC_K)):
                d = os.path.join(workdir, label)
                trainers[label], fits[label] = spc_fit(
                    name, hp, loaders, dev, k, d,
                    profiled=name == "mpnn" and label != "k1_again")
        base, again = fits["k1"], fits["k1_again"]
        got = fits[f"k{SPC_K}"]
        w = {lbl: {n: p.detach() for n, p in t.model.named_parameters()}
             for lbl, t in trainers.items()}
        flat = {lbl: torch.cat([v.reshape(-1).double() if not v.is_complex()
                                else torch.view_as_real(v).reshape(-1)
                                .double() for v in ws.values()])
                for lbl, ws in w.items()}

        def weights_l2(lbl):
            return float((flat[lbl] - flat["k1"]).norm()
                         / flat["k1"].norm())

        worst_p, worst_n = rel_l2_of(
            {n: torch.view_as_real(v) if v.is_complex() else v
             for n, v in w[f"k{SPC_K}"].items()},
            {n: torch.view_as_real(v) if v.is_complex() else v
             for n, v in w["k1"].items()})
        bit_equal = all(torch.equal(w[f"k{SPC_K}"][n], w["k1"][n])
                        for n in w["k1"])
        losses = np.array(got["step_losses"])
        want_losses = np.array(base["step_losses"])
        loss_rel = float(np.max(np.abs(losses - want_losses)
                                / np.abs(want_losses)))
        n_steps = SPC_EPOCHS * per_epoch
        steps = got["steps"]
        captured = (steps["captured"] == 1 and got["captures"] == 1
                    and steps["replayed"] == n_steps - steps["eager"]
                    and steps["eager"] == 1)
        rec = {"model": name, "batch_size": loaders["train"].batch_size,
               "steps_per_epoch": per_epoch, "epochs": SPC_EPOCHS,
               "k": SPC_K, "steps": steps, "captured_as_expected": captured,
               "step_losses": {"k1": base["step_losses"],
                               "k1_again": again["step_losses"],
                               f"k{SPC_K}": got["step_losses"]},
               "max_step_loss_rel_err": loss_rel,
               "weights_rel_l2": weights_l2(f"k{SPC_K}"),
               "weights_rel_l2_k1_again": weights_l2("k1_again"),
               "worst_param_rel_l2": worst_p, "worst_param": worst_n,
               "weights_bit_equal": bit_equal,
               "seconds_per_step_last_epoch": {
                   "k1": base["seconds_per_step_last_epoch"],
                   f"k{SPC_K}": got["seconds_per_step_last_epoch"]}}
        if name == "mpnn":
            loader = loaders["train"]
            loader.set_epoch(0)
            lane = trainers["k1"]._host_pair(next(iter(loader)))[1].lane
            # #10 and #11 in each fit's profiler trace (training and
            # validation): the wrappers count every launch of a k = 1 fit,
            # but of the k = SPC_K fit only its eager steps' and its
            # validation's (no launch while a step is captured, and a
            # replay passes no wrapper); cross-check: the trace has a
            # captured step's launches for each replay besides
            per_step = base["launches_counted"].get("bwd_gather", 0) // n_steps
            counted, traced = got["launches_counted"], got["launches_traced"]
            cross = {key: counted.get(key, 0) + per_step * steps["replayed"]
                     for key in MPNN_SYMBOLS}
            k1_traced_as_counted = base["launches_traced"] == {
                key: base["launches_counted"].get(key, 0)
                for key in MPNN_SYMBOLS}
            launches_ok = (lane == "gather" and per_step > 0
                           and k1_traced_as_counted and traced == cross
                           and traced == base["launches_traced"]
                           and counted.get("bwd_gather")
                           == per_step * steps["eager"])
            ok = (captured and launches_ok
                  and loss_rel <= SPC_MPNN_LOSS_RTOL
                  and rec["weights_rel_l2"] <= SPC_MPNN_WEIGHT_L2)
            rec.update(lane=lane, launches_per_step=per_step,
                       launches_traced={lbl: f["launches_traced"]
                                        for lbl, f in fits.items()
                                        if f["fit_profiled"]},
                       launches_counted={lbl: f["launches_counted"]
                                         for lbl, f in fits.items()},
                       launches_counted_plus_replays=cross,
                       k1_traced_as_counted=k1_traced_as_counted,
                       launches_ok=launches_ok,
                       loss_rtol=SPC_MPNN_LOSS_RTOL,
                       weights_rel_l2_tol=SPC_MPNN_WEIGHT_L2)
            # the k = 1 fits' wrappers' counts (the first one's equal to
            # its trace) and the k = SPC_K fit's trace
            for row, key in (("fused_mpnn_edge_agg2r", "fwd_gather"),
                             ("fused_mpnn_edge_agg2r_bwd", "bwd_gather")):
                extra[row] = {"launches_spc": base["launches_counted"][key]
                              + again["launches_counted"][key]
                              + traced[key]}
            print(f"spc mpnn: #10 / #11 launches in the fits' traces "
                  f"{rec['launches_traced']}; k={SPC_K} fit's wrappers "
                  f"{counted} + {per_step} a replay x {steps['replayed']} "
                  f"replays = {cross}", flush=True)
        else:
            no_kernels = not any(f["launches_counted"] for f in fits.values())
            nan = spc_nonfinite(hp, data["spc_fno_1d_nan_loaders"], dev)
            updates = spc_plain_updates(hp, dev)
            ok = (captured and no_kernels and bit_equal and nan["ok"]
                  and updates["ok"] and np.array_equal(losses, want_losses))
            rec.update(no_kernel_launches=no_kernels,
                       losses_bit_equal=bool(np.array_equal(losses,
                                                            want_losses)),
                       skip_nonfinite=nan, vs_plain_adam_updates=updates)
            print(f"spc optimizer vs plain Adam: same gradients "
                  f"{updates['change_rel_l2_after_each_update']} (dropped "
                  f"{updates['dropped']}); fit with a NaN "
                  f"{nan['vs_plain_adam']}", flush=True)
        # an epoch each way on the host clock, in turns, then one traced
        rec["seconds_checks"] = time.perf_counter() - t_model
        one, kk = trainers["k1"], trainers[f"k{SPC_K}"]
        turns = {"k1": [], f"k{SPC_K}": []}
        for i, (lbl, t) in enumerate((("k1", one), (f"k{SPC_K}", kk),
                                      (f"k{SPC_K}", kk), ("k1", one))):
            turns[lbl].append(spc_epoch(t, loaders["train"], SPC_EPOCHS + i,
                                        False)["seconds_per_step"])
        rec["seconds_per_step_in_turns"] = turns
        rec["traced"] = {lbl: spc_epoch(t, loaders["train"], SPC_EPOCHS + 4,
                                        True)
                         for lbl, t in (("k1", one), (f"k{SPC_K}", kk))}
        if name == "mpnn":
            traced = rec["traced"][f"k{SPC_K}"]["kernels_per_step_in_trace"]
            in_replays = all(v == per_step for v in traced.values())
            rec["mpnn_kernels_in_replays"] = in_replays
            ok = ok and in_replays
        rec["ok"] = bool(ok)
        rec["seconds"] = time.perf_counter() - t_model
        records.append(rec)
        tr = rec["traced"]
        print(f"spc {name} (batch {rec['batch_size']}, {per_epoch} steps an "
              f"epoch): k=1 / k={SPC_K} s a step "
              f"{rec['seconds_per_step_in_turns']}, idle share traced "
              f"{tr['k1']['device_idle_share_traced']} / "
              f"{tr[f'k{SPC_K}']['device_idle_share_traced']}, device events "
              f"a step {tr['k1']['device_events_per_step']} / "
              f"{tr[f'k{SPC_K}']['device_events_per_step']}; losses "
              f"{rec['max_step_loss_rel_err']} from k=1, weights "
              f"{rec['weights_rel_l2']} (k=1 again "
              f"{rec['weights_rel_l2_k1_again']}) ({smi})", flush=True)
        del trainers, one, kk
        if not ok:
            break
    ok = (len(records) == len(SPC_MODELS)
          and all(r["ok"] for r in records))
    emit({"phase": "spc", "nvidia_smi": smi, "torch": torch.__version__,
          "records": records, "seconds": time.perf_counter() - t_phase,
          "ok": ok})
    if not ok:
        return 47, [], {}
    return 0, [], extra


#: the kernels of the spc_graph fits in a profiler trace, a group for each
#: kernel template the lanes share: the parts every name of the group's
#: kernels holds and the launch counters (``every_launch``) of the wrappers
#: that launch it (the width-128 f32 backward counted by its
#: weight-gradient kernel, once a launch).  The bf16 forwards of both
#: widths share one demangled name: no fit runs both widths
TRACE_GROUPS = {
    "f32_w64_fwd": (("w64", "edge_tail_kernel"),
                    ("fused_edge_fwd", "fused_edge_pregathered_fwd",
                     "fused_edge_pe64_fwd")),
    "f32_w64_bwd": (("edge_tail_bwd_kernel",),
                    ("fused_edge_bwd", "fused_edge_pregathered_bwd",
                     "fused_edge_pe64_bwd")),
    "f32_w128_fwd": (("w128", "edge_tail_kernel"),
                     ("fused_edge_fold128_fwd", "fused_edge_pregathered128_fwd",
                      "fused_edge_pe_fwd")),
    "f32_w128_bwd": (("wgrad_kernel",),
                     ("fused_edge_fold128_bwd", "fused_edge_pregathered128_bwd",
                      "fused_edge_pe_bwd")),
    "bf16_w64_fwd": (("wgmma_fwd_kernel",),
                     ("fused_edge_bf16_fwd", "fused_edge_pregathered_bf16_fwd",
                      "fused_edge_pe64_bf16_fwd")),
    "bf16_w64_bwd": (("wgmma_bwd_kernel",),
                     ("fused_edge_bf16_bwd", "fused_edge_pregathered_bf16_bwd",
                      "fused_edge_pe64_bf16_bwd")),
    "bf16_w128_fwd": (("wgmma_fwd_kernel",),
                      ("fused_edge_fold128_bf16_fwd",
                       "fused_edge_pregathered128_bf16_fwd",
                       "fused_edge_pe_bf16_fwd")),
    "bf16_w128_bwd": (("cluster_bwd_kernel",),
                      ("fused_edge_fold128_bf16_bwd",
                       "fused_edge_pregathered128_bf16_bwd",
                       "fused_edge_pe_bf16_bwd")),
    "segment_sum": (("segment_sum_kernel",), ("segment_sum",
                                              "segment_sum_bf16"))}
#: the kernels line's row of each counter
COUNTER_ROWS = {
    "fused_edge_fwd": "fused_edge_tail_agg",
    "fused_edge_bwd": "fused_edge_tail_agg_bwd",
    "fused_edge_fold128_fwd": "fused_edge_tail_agg_w128",
    "fused_edge_fold128_bwd": "fused_edge_tail_agg_bwd_w128",
    "fused_edge_pregathered_fwd": "fused_edge_tail_agg_pregathered",
    "fused_edge_pregathered_bwd": "fused_edge_tail_agg_pregathered_bwd",
    "fused_edge_pregathered128_fwd": "fused_edge_tail_agg_pregathered_w128",
    "fused_edge_pregathered128_bwd":
        "fused_edge_tail_agg_pregathered_bwd_w128",
    "fused_edge_pe64_fwd": "fused_edge_tail_agg_pe64",
    "fused_edge_pe64_bwd": "fused_edge_tail_agg_pe64_bwd",
    "fused_edge_pe_fwd": "fused_edge_tail_agg_pe",
    "fused_edge_pe_bwd": "fused_edge_tail_agg_pe_bwd",
    "fused_edge_bf16_fwd": "fused_edge_tail_agg_bf16",
    "fused_edge_bf16_bwd": "fused_edge_tail_agg_bf16_bwd",
    "fused_edge_pregathered_bf16_fwd": "fused_edge_tail_agg_pregathered_bf16",
    "fused_edge_pregathered_bf16_bwd":
        "fused_edge_tail_agg_pregathered_bf16_bwd",
    "fused_edge_pe64_bf16_fwd": "fused_edge_tail_agg_pe64_bf16",
    "fused_edge_pe64_bf16_bwd": "fused_edge_tail_agg_pe64_bf16_bwd",
    "fused_edge_fold128_bf16_fwd": "fused_edge_tail_agg_bf16_w128",
    "fused_edge_fold128_bf16_bwd": "fused_edge_tail_agg_bf16_w128_bwd",
    "fused_edge_pregathered128_bf16_fwd":
        "fused_edge_tail_agg_pregathered_bf16_w128",
    "fused_edge_pregathered128_bf16_bwd":
        "fused_edge_tail_agg_pregathered_bf16_w128_bwd",
    "fused_edge_pe_bf16_fwd": "fused_edge_tail_agg_pe_bf16",
    "fused_edge_pe_bf16_bwd": "fused_edge_tail_agg_pe_bf16_bwd",
    "segment_sum": "segment_sum", "segment_sum_bf16": "segment_sum_bf16"}


def spc_graph_fits() -> list[dict]:
    """The spc_graph fits: model, hyperparameters, data, lane, the
    counters of the lane's training kernels (forward, backward, the
    segment sum where the lane has one), the loss bound against the
    one-step fit, whether that fit runs twice and the bound of its repeat
    (the fit's bound unless given) and, for a bf16 MAgNet[GNN] fit, the
    f32 fit of its model (SPC_GRAPH_BF16_GNN_RTOL's)."""
    from magnet_tpu_torch.config import MAGNET_CNN, MAGNET_CNN_2D, MAGNET_GNN

    bf16 = {"graph_dtype": "bf16"}
    par, bf16_gnn = SPC_GRAPH_LOSS_RTOL["magnet_gnn"], SPC_GRAPH_BF16_GNN_RTOL

    def fit(label, name, hp, data, train, rtol, kind=None, impl="kernel",
            repeat=None, repeat_rtol=None, f32_of=None):
        return {"label": label, "name": name, "hp": hp, "data": data,
                "train": train, "rtol": rtol, "kind": kind, "impl": impl,
                "repeat": rtol > 1e-5 if repeat is None else repeat,
                "repeat_rtol": rtol if repeat_rtol is None else repeat_rtol,
                "f32_of": f32_of}

    return [
        fit("magnet_cnn", "magnet_cnn", MAGNET_CNN, "magnet_cnn",
            ("fused_edge_fwd", "fused_edge_bwd"), 1e-5, repeat=True),
        fit("magnet_gnn", "magnet_gnn", MAGNET_GNN, "magnet_gnn",
            ("fused_edge_fold128_fwd", "fused_edge_fold128_bwd"), par),
        fit("magnet_cnn_2d", "magnet_cnn_2d", MAGNET_CNN_2D, "magnet_cnn_2d",
            ("fused_edge_pregathered_fwd", "fused_edge_pregathered_bwd",
             "segment_sum"), par),
        fit("magnet_cnn_2d bf16", "magnet_cnn_2d", {**MAGNET_CNN_2D, **bf16},
            "magnet_cnn_2d",
            ("fused_edge_pregathered_bf16_fwd",
             "fused_edge_pregathered_bf16_bwd", "segment_sum_bf16"), par),
        fit("magnet_gnn_2d", "magnet_gnn", {**MAGNET_GNN, **GNN2D_HP},
            "magnet_gnn_2d",
            ("fused_edge_fold128_fwd", "fused_edge_fold128_bwd"),
            SPC_GRAPH_GNN2D_RTOL, kind="h5_implicit_gnn_2d"),
        fit("magnet_cnn bf16", "magnet_cnn", {**MAGNET_CNN, **bf16},
            "magnet_cnn", ("fused_edge_bf16_fwd", "fused_edge_bf16_bwd"),
            par),
        fit("magnet_cnn kernel_pe", "magnet_cnn", MAGNET_CNN, "magnet_cnn",
            ("fused_edge_pe64_fwd", "fused_edge_pe64_bwd", "segment_sum"),
            1e-5, impl="kernel_pe"),
        fit("magnet_gnn kernel_pregathered", "magnet_gnn", MAGNET_GNN,
            "magnet_gnn",
            ("fused_edge_pregathered128_fwd", "fused_edge_pregathered128_bwd",
             "segment_sum"), par, impl="kernel_pregathered"),
        fit("magnet_gnn bf16", "magnet_gnn", {**MAGNET_GNN, **bf16},
            "magnet_gnn",
            ("fused_edge_fold128_bf16_fwd", "fused_edge_fold128_bf16_bwd"),
            bf16_gnn, repeat=True, repeat_rtol=par, f32_of="magnet_gnn"),
        fit("magnet_gnn_2d bf16", "magnet_gnn",
            {**MAGNET_GNN, **GNN2D_HP, **bf16}, "magnet_gnn_2d",
            ("fused_edge_fold128_bf16_fwd", "fused_edge_fold128_bf16_bwd"),
            bf16_gnn, kind="h5_implicit_gnn_2d", repeat=False,
            f32_of="magnet_gnn_2d")]


def replay_ms(fn, reps: int) -> float:
    """Device ms of one ``fn()``: a CUDA graph of it (after one eager call)
    replayed ``reps`` times between two events, so that no host time of
    the wrapper stands between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def padded_turns(fns: dict, reps: int = 50) -> dict:
    """Each of ``fns`` ({direction: (unpadded call, padded call)}) timed as
    replays of a captured call (``replay_ms``) in turns: unpadded, padded,
    padded, unpadded."""
    turns = {"unpadded": {d: [] for d in fns}, "padded": {d: [] for d in fns}}
    for label, i in (("unpadded", 0), ("padded", 1), ("padded", 1),
                     ("unpadded", 0)):
        for d, pair in fns.items():
            turns[label][d].append(replay_ms(pair[i], reps))
    return turns


#: the edge source of each entry's operands and its integer operands'
#: places, by the graph field each one is
PAD_INTS = {"fold": {5: "senders", 6: "rowptr"},
            "pregathered": {2: "rowptr"},
            "pe": {3: "senders", 4: "rowptr", 5: "snd_ptr", 6: "snd_perm"}}


def pad_entry(entry, dtype):
    """(forward, backward, plain forward, plain backward, gradient names)
    of ``entry``'s wrappers in ``dtype``."""
    from magnet_tpu_torch.ops import fused_edge as fe

    stem = {"fold": "fused_edge_tail_agg",
            "pregathered": "fused_edge_tail_agg_pregathered",
            "pe": "fused_edge_tail_agg_pe"}[entry]
    stem += "_bf16" if dtype == "bf16" else ""
    names = {"fold": fe.GRAD_NAMES, "pregathered": fe.GRAD_NAMES_PREGATHERED,
             "pe": fe.GRAD_NAMES_PE}[entry]
    return (getattr(fe, stem), getattr(fe, f"{stem}_bwd"),
            getattr(fe, f"{stem}_plain"), getattr(fe, f"{stem}_bwd_plain"),
            names)


def pad_operands(entry, dtype, graph, widths, l1, seed, dev):
    """The wrapper's operands of ``entry`` on ``graph`` (fold: (Ce, H, C)
    widths; pe and pre-gathered: (H, H, C)) at the kernel phases' scales,
    rounded to bf16 in the bf16 lane."""
    from magnet_tpu_torch.time_fwd import operands as c_operands
    from magnet_tpu_torch.time_fwd import to_bf16

    ce, h, c = widths
    if entry == "fold":
        ops = kernel_operands(graph, ce, h, c, l1, seed, dev)
    elif entry == "pregathered":
        ops = pregathered_operands(graph, h, c, l1, seed, dev)
    else:
        src, _, _, pxj, pxi, senders, rowptr, *tail = c_operands(
            "pe", graph, h, h, c, l1, seed, dev)
        ops = (src, pxj, pxi, senders, rowptr, graph.snd_ptr.to(dev),
               graph.snd_perm.to(dev), *tail)
    return to_bf16(ops) if dtype == "bf16" else ops


def padded_graph(graph):
    """``graph`` padded to its edge bucket (``ops.graph.EdgeBuckets``), by
    one row where it fills its bucket."""
    from magnet_tpu_torch.ops.graph import EdgeBuckets, pad_edges

    e_pad = EdgeBuckets().grow("all", graph.n_edge)
    return pad_edges(graph, e_pad if e_pad > graph.n_edge else
                     graph.n_edge + 1)


def spc_graph_kernels(entry, dtype, graph, widths, l1, seed, dev) -> dict:
    """``entry``'s forward and backward in ``dtype`` (f32 or bf16, at either
    width) on ``graph`` padded to its edge bucket (a dead tail
    of 1-1,023 rows, NaN in the edge source's dead rows) against the same
    launch unpadded: output, weight gradients and d_src's live rows bit for
    bit, d_src's dead rows zero, the node gradients summed with atomics
    (fold: d_pxj and d_pxi; pe, pre-gathered: d_pxi) within
    SPC_GRAPH_ATOMICS_L2 relative L2 (bf16: SPC_GRAPH_ATOMICS_BF16_L2); the
    padded launch against the plain version at the kernel phases' bounds
    (the relu ties' receivers zeroed in g); each timed padded and unpadded
    in turns, as replays of a captured launch."""
    fwd, bwd, plain_fwd, plain_bwd, names = pad_entry(entry, dtype)
    bf16 = dtype == "bf16"
    c = widths[2]
    E = graph.n_edge
    padded = padded_graph(graph)
    ops = pad_operands(entry, dtype, graph, widths, l1, seed, dev)
    src = ops[0]
    dead = torch.full((padded.n_edge - E, src.shape[1]), float("nan"),
                      dtype=src.dtype, device=dev)
    ops_p = [torch.cat([src, dead]), *ops[1:]]
    for i, field in PAD_INTS[entry].items():
        ops_p[i] = getattr(padded, field).to(dev)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(graph.n_node, c, generator=gen).to(dev)
    ties = (tie_receivers_bf16(ops, l1, entry) if bf16
            else tie_receivers(entry, ops, l1))
    g[ties] = 0.0
    out_u, out_p = fwd(*ops), fwd(*ops_p)
    grads_u, grads_u2 = bwd(*ops, g), bwd(*ops, g)
    grads_p = bwd(*ops_p, g)
    torch.cuda.synchronize()
    plain_out = plain_fwd(*ops_p)
    plain = plain_bwd(*ops_p, g)
    atomic = {"pxi"} | ({"pxj"} if entry == "fold" else set())
    atomics_l2 = SPC_GRAPH_ATOMICS_BF16_L2 if bf16 else SPC_GRAPH_ATOMICS_L2
    bits, atomics, vs_plain = {}, {}, {}
    for name, a, u, u2, w in zip(names, grads_p, grads_u, grads_u2, plain):
        if name in atomic:
            atomics[name] = {"rel_l2_vs_unpadded": rel_l2(a, u),
                             "rel_l2_unpadded_run_to_run": rel_l2(u2, u)}
        elif name == names[0]:
            bits[name] = bool(torch.equal(a[:E], u))
            bits[f"{name}_dead_rows_zero"] = bool((a[E:] == 0).all())
        else:
            bits[name] = bool(torch.equal(a, u))
        if w.numel():
            vs_plain[name] = (compare_grad(a, w, elementwise=False,
                                           rtol=BF16_RTOL,
                                           atol_rel=BF16_BWD_ATOL_REL,
                                           max_l2=BF16_BWD_L2) if bf16
                              else compare_grad(a, w, elementwise=False))
    fwd_vs_plain = (compare_bf16(out_p, plain_out) if bf16
                    else compare(out_p, plain_out, KERNEL_RTOL, KERNEL_ATOL))
    turns = padded_turns({
        "fwd": (lambda: fwd(*ops), lambda: fwd(*ops_p)),
        "bwd": (lambda: bwd(*ops, g), lambda: bwd(*ops_p, g))})
    fwd_bits = bool(torch.equal(out_u, out_p))
    ok = (fwd_bits and all(bits.values())
          and all(v["rel_l2_vs_unpadded"] <= atomics_l2
                  for v in atomics.values())
          and fwd_vs_plain["ok"] and all(v["ok"] for v in vs_plain.values()))
    ce, h, _ = widths
    if entry == "fold":
        bounds = ((bf16_bound if bf16 else bound)(k, graph, ce, h, c, l1)
                  for k in ("fwd", "bwd"))
    elif bf16:
        fn = pe_bf16_bound if entry == "pe" else pregathered_bf16_bound
        bounds = (fn(k, graph, h, c, l1) for k in ("fwd", "bwd"))
    else:
        bounds = (pregathered_bound(k, graph, h, c, l1, pe=entry == "pe")
                  for k in ("fwd", "bwd"))
    b_fwd, b_bwd = bounds
    return {"entry": entry, "dtype": dtype,
            "widths": list(widths) if entry == "fold" else [h, c],
            "l1": l1, "n_node": graph.n_node, "live_edges": E,
            "rows": padded.n_edge, "dead_tail": padded.n_edge - E,
            "fwd_bit_equal": fwd_bits, "bwd_bit_equal": bits,
            "atomic_node_grads": atomics, "atomics_rel_l2_tol": atomics_l2,
            "fwd_vs_plain": fwd_vs_plain, "bwd_vs_plain": vs_plain,
            "tie_receivers_zeroed": int(ties.numel()),
            "ms_in_turns": turns, "bound_fwd": b_fwd, "bound_bwd": b_bwd,
            "ok": bool(ok)}


def spc_graph_segment(dtype, graph, h, seed, dev) -> dict:
    """The segment sum #1 over ``graph``'s sender CSR padded to its edge
    bucket (``snd_perm`` listing the dead rows after the live edges, NaN in
    x's dead rows) against the unpadded sum bit for bit and against the
    plain version (SEG_RTOL, or BF16_SEG_RTOL in bf16, of |want| plus
    SEG_ATOL_REL of its largest), timed padded and unpadded in turns."""
    from magnet_tpu_torch.ops import segment as seg

    E = graph.n_edge
    padded = padded_graph(graph)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(E, h, generator=gen).to(dev)
    x = x.bfloat16() if dtype == "bf16" else x
    x_p = torch.cat([x, torch.full((padded.n_edge - E, h), float("nan"),
                                   dtype=x.dtype, device=dev)])
    ptr, perm = graph.snd_ptr.to(dev), graph.snd_perm.to(dev)
    perm_p = padded.snd_perm.to(dev)
    got_u = seg.segment_sum(x, ptr, perm)
    got_p = seg.segment_sum(x_p, ptr, perm_p)
    want = seg.segment_sum_plain(x_p, ptr, perm_p)
    err = (got_p.double() - want.double()).abs()
    rtol = BF16_SEG_RTOL if dtype == "bf16" else SEG_RTOL
    tol = rtol * want.double().abs() + SEG_ATOL_REL * float(
        want.double().abs().max())
    bits = bool(torch.equal(got_p, got_u))
    turns = padded_turns({"sum": (lambda: seg.segment_sum(x, ptr, perm),
                                  lambda: seg.segment_sum(x_p, ptr, perm_p))})
    return {"dtype": dtype, "h": h, "n_node": graph.n_node,
            "live_edges": E, "rows": padded.n_edge,
            "dead_tail": padded.n_edge - E, "bit_equal": bits,
            "vs_plain": {"max_abs_err": float(err.max()), "rtol": rtol,
                         "ok": bool((err <= tol).all())},
            "ms_in_turns": turns,
            "bound": segment_bound(graph, h, 2.0 if dtype == "bf16" else 4.0),
            "ok": bits and bool((err <= tol).all())}


def small_graphs() -> dict:
    """Graphs of 1 and 300 edges (dead tails of 1,023 and 724 rows once
    padded), on which most of a launch's blocks and clusters lie past the
    live split and exit whole: receiver-grouped, seeded."""
    from magnet_tpu_torch.ops.graph import csr_from_edges

    rng = np.random.default_rng(11)
    out = {"one_edge": csr_from_edges(torch.tensor([3]), torch.tensor([5]),
                                      64)}
    recv = np.sort(rng.integers(0, 100, size=300))
    send = rng.integers(0, 100, size=300)
    out["small"] = csr_from_edges(torch.from_numpy(send),
                                  torch.from_numpy(recv), 100)
    return out


def spc_graph_kernel_cases(dev, data) -> dict:
    """The kernel forms of the captured lanes on padded graphs: the f32
    fold (#8/#9), pe (#6/#7) and pre-gathered (#2/#3) entries at (64, 32)
    (fold (32, 64, 32)) on MAgNet[CNN] 1D's batch-32 training graph (fold,
    pe) and MAgNet[CNN] 2D's (pre-gathered), at width 128 on MAgNet[GNN]
    1D's LR and LR ∪ HR training graphs, the bf16 entries at width 64 on
    the same MAgNet[CNN] graphs and at width 128 on the same MAgNet[GNN]
    graphs and on ``small_graphs``, and #1 in f32 (the pe lane's d_pxj,
    MAgNet[CNN] 1D's graph) and bf16 (the bf16 pre-gathered lane's sender
    gather, MAgNet[CNN] 2D's) on their padded sender CSRs."""
    from magnet_tpu_torch.config import MAGNET_CNN, MAGNET_CNN_2D, MAGNET_GNN
    from magnet_tpu_torch.models.factory import create_model

    def train_graph(name, hp, key, kind=None):
        loader = data[f"spc_graph_{key}_loaders"]["train"]
        loader.set_epoch(0)
        model = create_model(name, hp, device=dev, kind=kind)
        graph = model.build_graph({k: torch.as_tensor(v) for k, v in
                                   next(iter(loader)).items()})
        return model.graph_parts(graph)

    l1 = MAGNET_CNN["mlp_layers"] - 1
    cnn1d = train_graph("magnet_cnn", MAGNET_CNN, "magnet_cnn")["all"]
    cnn2d = train_graph("magnet_cnn_2d", MAGNET_CNN_2D, "magnet_cnn_2d")["all"]
    gnn = train_graph("magnet_gnn", MAGNET_GNN, "magnet_gnn")
    w64, w128 = (32, 64, 32), (128, 128, 128)
    cases = {}
    for dtype in ("f32", "bf16"):
        cases[f"{dtype} fold cnn_1d"] = ("fold", dtype, cnn1d, w64)
        cases[f"{dtype} pe cnn_1d"] = ("pe", dtype, cnn1d, (64, 64, 32))
        cases[f"{dtype} pregathered cnn_2d"] = ("pregathered", dtype, cnn2d,
                                                (64, 64, 32))
    for role, part in gnn.items():
        for dtype in ("f32", "bf16"):
            for entry in ("fold", "pe", "pregathered"):
                cases[f"{dtype} {entry} gnn_1d {role}"] = (entry, dtype, part,
                                                           w128)
    for label, graph in small_graphs().items():
        for entry in ("fold", "pe", "pregathered"):
            cases[f"bf16 {entry} {label}"] = (entry, "bf16", graph, w128)
    out = {label: spc_graph_kernels(entry, dtype, graph, widths, l1, 7, dev)
           for label, (entry, dtype, graph, widths) in cases.items()}
    out["f32 segment_sum cnn_1d"] = spc_graph_segment("f32", cnn1d, 64, 8,
                                                      dev)
    out["bf16 segment_sum cnn_2d"] = spc_graph_segment("bf16", cnn2d, 64, 8,
                                                       dev)
    return out


def padded_step(spec, loader, dev) -> dict:
    """One eager training step of ``spec``'s model (seed 0) on the first
    batch of ``loader``, on its graph and on the graph padded to the
    trainer's buckets: the loss's relative difference and each
    gradient's relative L2 difference, the largest of them (what a fit on
    padded graphs starts from)."""
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops.graph import EdgeBuckets
    from magnet_tpu_torch.utils import to_device

    loader.set_epoch(0)
    batch = {k: torch.as_tensor(v) for k, v in next(iter(loader)).items()}
    model = create_model(spec["name"], spec["hp"], device=dev, seed=0,
                         kind=spec["kind"])
    if spec["impl"] != "kernel":
        model.impl = spec["impl"]
    model.train()
    graph = model.build_graph(batch)
    buckets = EdgeBuckets()
    padded = model.with_graph_parts(graph, {
        role: buckets.pad(role, csr)
        for role, csr in model.graph_parts(graph).items()})
    batch = to_device(batch, dev)
    out = {}
    for label, g in (("unpadded", graph), ("padded", padded)):
        model.zero_grad()
        loss, _ = model.loss(batch, g, train=True)
        loss.backward()
        out[label] = (loss.detach(), {n: p.grad.clone() for n, p in
                                      model.named_parameters()
                                      if p.grad is not None})
    (lu, gu), (lp, gp) = out["unpadded"], out["padded"]
    grads = {n: rel_l2(gp[n], gu[n]) for n in gu}
    worst = max(grads, key=grads.get)
    return {"loss_rel_diff": float(((lp - lu).abs() / lu.abs()).item()),
            "loss_bit_equal": bool(torch.equal(lp, lu)),
            "max_grad_rel_l2": grads[worst], "worst_param": worst,
            "grads_bit_equal": sum(torch.equal(gp[n], gu[n]) for n in gu),
            "n_grads": len(gu)}


def spc_graph_phases(dev, data, groups) -> tuple[int, list, dict]:
    """Phase ``spc_graph``: the captured lanes' kernels on padded training
    graphs at batch 32 (``spc_graph_kernel_cases``); then ``Trainer.fit``
    of each ``spc_graph_fits`` fit at its published widths with one and
    SPC_K steps a call from the same seed, new queries every batch (the
    one-step fit twice where its loss bound needs the spread): the SPC_K
    fit as replays of a captured step over graphs padded to the trainer's
    edge buckets (step counts, captures, buckets), per-step losses against
    the one-step fit, the lane's kernels in a profiler trace of the SPC_K
    fit against its wrappers' eager launches plus a captured step's for
    each replay, and the host's seconds a batch building and padding
    graphs; then seconds a step (an epoch each way, in turns, graphs built
    on the clock), the device's idle share and launches a step, each way.
    Returns the lane kernels' launches in the fits (the one-step fits'
    wrappers', the SPC_K fit's trace) as extra counts of their rows."""
    t_phase = time.perf_counter()
    smi = card()
    kernels = spc_graph_kernel_cases(dev, data)
    kernels_ok = all(v["ok"] for v in kernels.values())
    print("spc_graph kernels on padded graphs: " + "; ".join(
        f"{lbl} ({v['live_edges']} + {v['dead_tail']} dead): ok {v['ok']}, "
        f"ms {v['ms_in_turns']}" for lbl, v in kernels.items())
        + f" ({smi})", flush=True)
    if not kernels_ok:
        print("spc_graph kernels failing: " + json.dumps(
            {k: v for k, v in kernels.items() if not v["ok"]}), flush=True)

    records, extra = [], {}
    for spec in spc_graph_fits():
        name, hp, label = spec["name"], dict(spec["hp"]), spec["label"]
        loaders = data[f"spc_graph_{spec['data']}_loaders"]
        train = spec["train"]
        groups_of = {key for key, (_, counters) in TRACE_GROUPS.items()
                     if set(counters) & set(train)}
        symbols = {key: TRACE_GROUPS[key][0] for key in groups_of}
        rtol, repeat = spec["rtol"], spec["repeat"]
        n_steps = SPC_EPOCHS * len(loaders["train"])
        t_model = time.perf_counter()
        step = padded_step(spec, loaders["train"], dev)
        fits, trainers = {}, {}
        f32 = spec["f32_of"]
        runs = (("k1", 1, False),) \
            + ((("k1_again", 1, False),) if repeat else ()) \
            + ((f"k{SPC_K}", SPC_K, False),) \
            + (((f"k{SPC_K}_eager", SPC_K, True),) if f32 else ())
        with tempfile.TemporaryDirectory() as workdir:
            for run, k, eager in runs:
                trainers[run], fits[run] = spc_fit(
                    name, hp, loaders, dev, k, os.path.join(workdir, run),
                    profiled=k > 1 and not eager, symbols=symbols,
                    kind=spec["kind"], impl=spec["impl"], eager=eager)
        base, got = fits["k1"], fits[f"k{SPC_K}"]
        kk = trainers[f"k{SPC_K}"]
        want = np.array(base["step_losses"])
        rel = {run: (np.abs(np.array(fits[run]["step_losses"]) - want)
                     / np.abs(want)).tolist()
               for run in fits if run not in ("k1", f"k{SPC_K}_eager")}
        bounds = {f"k{SPC_K}": rtol, "k1_again": spec["repeat_rtol"]}
        step_l2 = SPC_GRAPH_FIRST_STEP_L2[
            "bf16" if hp.get("graph_dtype") == "bf16" else "float32"]
        rel_eager = from_f32 = None
        if f32:
            # the captured chunks against the same steps run eagerly, and
            # the one-step fit's distance from the f32 one, which the bound
            # against it must stay below
            twin = np.array(fits[f"k{SPC_K}_eager"]["step_losses"])
            rel_eager = (np.abs(np.array(got["step_losses"]) - twin)
                         / np.abs(twin)).tolist()
            of = next(r for r in records if r["fit"] == f32)
            from_f32 = float(np.max(np.abs(
                want - np.array(of["step_losses"]["k1"])) / np.abs(want)))
        losses = np.array(got["step_losses"])
        loss_rel = max(rel[f"k{SPC_K}"])
        steps = got["steps"]
        counted, traced = got["launches_counted"], got["launches_traced"]
        # a training step's launches of the lane's kernels: the backward's
        # in the one-step fit (every forward of a training step has one)
        per_step = base["launches_counted"].get(train[1], 0) // n_steps
        cross = {key: counted.get(key, 0)
                 + (per_step * steps["replayed"] if key in train else 0)
                 for key in COUNTER_ROWS}
        traced_want = {grp: sum(cross[key] for key in TRACE_GROUPS[grp][1])
                       for grp in symbols}
        host = {run: {**t.host_graph,
                      "build_s_per_batch": t.host_graph["build_s"]
                      / max(t.host_graph["built"], 1),
                      "pad_s_per_graph": t.host_graph["pad_s"]
                      / max(t.host_graph["padded"], 1)}
                for run, t in trainers.items()}
        ok = (steps["captured"] >= 1 and steps["replayed"] > 0
              and steps["eager"] + steps["replayed"] == n_steps
              and per_step > 0
              and all(base["launches_counted"].get(key, 0)
                      == per_step * n_steps for key in train[1:])
              and traced == traced_want and all(traced.values())
              and base["steps"]["eager"] == n_steps
              and np.isfinite(losses).all()
              and all(max(r) <= bounds[run] for run, r in rel.items())
              and (rel_eager is None or max(rel_eager) <= PAR_FIT_RTOL)
              and (from_f32 is None or from_f32 > rtol)
              and step["loss_bit_equal"]
              and step["max_grad_rel_l2"] <= step_l2
              and kk.host_graph["padded"] > 0
              and trainers["k1"].host_graph["padded"] == 0)
        rec = {"fit": label, "model": name, "impl": spec["impl"],
               "graph_dtype": hp.get("graph_dtype", "float32"),
               "batch_size": loaders["train"].batch_size,
               "steps_per_epoch": len(loaders["train"]),
               "epochs": SPC_EPOCHS, "k": SPC_K, "steps": steps,
               "captures": got["captures"],
               "edge_buckets": dict(kk.buckets.edges),
               "step_losses": {run: f["step_losses"]
                               for run, f in fits.items()},
               "step_loss_rel_err_vs_k1": rel,
               "max_step_loss_rel_err": loss_rel,
               "max_step_loss_rel_err_k1_again": (max(rel["k1_again"])
                                                  if repeat else None),
               "loss_rtol": rtol, "repeat_loss_rtol": spec["repeat_rtol"],
               "step_loss_rel_err_vs_eager_on_padded": rel_eager,
               "eager_on_padded_rtol": PAR_FIT_RTOL,
               "max_step_loss_rel_dist_k1_from_f32_k1": from_f32,
               "padded_first_step_vs_unpadded": step,
               "padded_first_step_grad_l2_bound": step_l2,
               "launches_per_step": per_step,
               "launches_counted": {run: f["launches_counted"]
                                    for run, f in fits.items()},
               "launches_traced": traced,
               "launches_counted_plus_replays": traced_want,
               "host_graph": host,
               "seconds_per_step_last_epoch": {
                   run: f["seconds_per_step_last_epoch"]
                   for run, f in fits.items()},
               "seconds_checks": time.perf_counter() - t_model}
        for key in train:
            row = extra.setdefault(COUNTER_ROWS[key], {})
            row["launches_spc_graph"] = (
                row.get("launches_spc_graph", 0) + cross[key]
                + sum(fits[run]["launches_counted"].get(key, 0)
                      for run in fits if run.startswith("k1")))
        # an epoch each way on the host clock, in turns, then one traced;
        # graphs built on the clock, as the fit builds them
        one = trainers["k1"]
        turns = {"k1": [], f"k{SPC_K}": []}
        for i, (run, t) in enumerate((("k1", one), (f"k{SPC_K}", kk),
                                      (f"k{SPC_K}", kk), ("k1", one))):
            turns[run].append(spc_epoch(
                t, loaders["train"], SPC_EPOCHS + i, False, symbols,
                with_graphs=True)["seconds_per_step"])
        rec["seconds_per_step_in_turns"] = turns
        rec["traced"] = {run: spc_epoch(t, loaders["train"], SPC_EPOCHS + 4,
                                        True, symbols, with_graphs=True,
                                        host_ops=False)
                         for run, t in (("k1", one), (f"k{SPC_K}", kk))}
        rec["steps_after_turns"] = dict(kk.step_counts)
        rec["host_graph_after_turns"] = dict(kk.host_graph)
        rec["ok"] = bool(ok)
        rec["seconds"] = time.perf_counter() - t_model
        records.append(rec)
        tr = rec["traced"]
        print(f"spc_graph {label} (batch {rec['batch_size']}, "
              f"{rec['steps_per_epoch']} steps an epoch): ok {rec['ok']}, "
              f"steps {steps}, buckets {rec['edge_buckets']}; k=1 / "
              f"k={SPC_K} s a step {turns}, idle share traced "
              f"{tr['k1']['device_idle_share_traced']} / "
              f"{tr[f'k{SPC_K}']['device_idle_share_traced']}, runtime "
              f"calls a step {tr['k1']['cuda_runtime_calls_per_step']} / "
              f"{tr[f'k{SPC_K}']['cuda_runtime_calls_per_step']}; losses "
              f"{loss_rel} from k=1, bound {rtol} (k=1 again "
              f"{rec['max_step_loss_rel_err_k1_again']}, bound "
              f"{spec['repeat_rtol']}; vs the same chunks eagerly on padded "
              f"graphs {None if rel_eager is None else max(rel_eager)}, "
              f"bound {PAR_FIT_RTOL}; k=1 from f32 k=1 {from_f32}; first "
              f"step padded vs unpadded {step}, bound {step_l2}); "
              f"traced {traced} = counted + {per_step} x "
              f"{steps['replayed']} replays {traced_want}; host graph "
              f"{host} ({smi})", flush=True)
        del trainers, one, kk
    ok = (kernels_ok and len(records) == len(spc_graph_fits())
          and all(r["ok"] for r in records))
    emit({"phase": "spc_graph", "nvidia_smi": smi,
          "torch": torch.__version__, "kernels": kernels,
          "records": records, "seconds": time.perf_counter() - t_phase,
          "ok": ok})
    if not ok:
        return 48, [], {}
    return 0, [], extra


def regular_32(eval64: dict) -> dict:
    """MAgNet[GNN] 2D's eval split: every second row and column of the eval
    solves' 64 x 64 grid, the solver's own 32 x 32 output."""
    nt = eval64["t"].shape[1]
    return {"t": eval64["t"], "x": eval64["x"][:, ::2],
            "y": eval64["y"][:, ::2],
            f"pde_{nt}-32": eval64[f"pde_{nt}-64"][:, :, ::2, ::2]}


def make_data(groups) -> dict:
    """Everything the selected groups read, made on the host from seeds.
    Every solve is a task of a pool of ``DATA_WORKERS`` processes, all of
    them submitted first, so that they run while the kernels build; the
    loaders are assembled here from their results.  Each ``*_seconds`` is
    the time from the start until that group's data was ready."""
    from magnet_tpu_torch.config import (
        DATAMODULE_1D,
        DATAMODULE_2D,
        DATAMODULE_GRAPH,
        DATAMODULE_GRAPH_2D,
        DATAMODULE_IMPLICIT,
        DATAMODULE_IMPLICIT_2D,
        DATAMODULE_IMPLICIT_GNN,
        DATAMODULE_IMPLICIT_GNN_2D,
        HEAT_TEST,
    )
    from magnet_tpu_torch.data.datamodule import (
        SPLITS,
        build_loaders,
        synthetic_split,
        synthetic_test_batches,
    )
    from magnet_tpu_torch.data.heat import heat_batches
    from magnet_tpu_torch.data.synthetic import make_split

    groups = set(groups)
    t0 = time.perf_counter()
    data = {}
    with ProcessPoolExecutor(DATA_WORKERS, mp_context=get_context("spawn")) \
            as pool:
        def splits(cfg):
            """The three splits of ``cfg``'s synthetic source, as tasks."""
            return {split: pool.submit(synthetic_split, cfg, split)
                    for split in SPLITS}

        def arrays(jobs):
            return {f"{split}_path": job.result()
                    for split, job in jobs.items()}

        def joined(jobs):
            parts = [job.result() for job in jobs]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}

        # the KS and Heat trajectories of the cnn, gnn and no_interaction
        # groups; the Burgers-2D splits (seeds 0, 1, 2) shared by the
        # MPNN-2D and the MAgNet[CNN] 2D loaders and 12 more from seed 3;
        # the combined equation of the MPNN-1D step; the new groups' solves
        # in chunks
        ks_cfg = {**DATAMODULE_IMPLICIT, **SMOKE_DATA}
        gnn2d_cfg = {**DATAMODULE_IMPLICIT_GNN_2D, **GNN2D_DATA,
                     "source": "synthetic_burgers_2d"}
        nt, res = DATAMODULE_GRAPH_2D["nt_train"], DATAMODULE_GRAPH_2D["res_train"]
        jobs = {}
        ks_spc = {"par", "par_dist", "par_spc", "spc", "spc_graph"}
        if {"cnn", "gnn", "no_interaction", "cnn_bf16", "gnn_bf16",
                "cnn_pe", "gnn_pre", "remat"} & groups or ks_spc & groups:
            jobs["ks"] = splits(ks_cfg)
        if ks_spc & groups:
            # the spc_graph fits' trajectories past the cnn group's 96
            jobs["ks_more"] = pool.submit(synthetic_split, {
                **ks_cfg, "data_seed": 5,
                "n_train": SPC_GRAPH_TRAJ - ks_cfg["n_train"]}, "train")
        if {"mpnn_paths", "cnn2d", "cnn2d_bf16", "cnn_pe",
                "gnn_pre", "par", "remat", "spc", "spc_graph"} & groups:
            jobs["b2d"] = {split: pool.submit(
                make_split, "B2D", MPNN_2D_DATA[f"n_{split}"], nt, res, seed=i)
                for i, split in enumerate(SPLITS)}
        if {"cnn2d", "cnn2d_bf16", "cnn_pe", "gnn_pre", "remat", "spc",
                "spc_graph"} & groups:
            jobs["b2d_extra"] = pool.submit(make_split, "B2D",
                                            CNN2D_EXTRA_TRAIN, nt, res, seed=3)
        if "mpnn_paths" in groups:
            jobs["ce"] = splits({**DATAMODULE_GRAPH, **MPNN_1D_DATA})
        chunks = B2D_TRAJ // DATA_CHUNK
        nt2, res2 = DATAMODULE_2D["nt_train"], DATAMODULE_2D["res_train"]
        if {"gnn2d", "gnn_bf16", "gnn_pre", "spc", "spc_graph"} & groups:
            # the datamodule's own seeded irregular source, a chunk a task
            jobs["gnn2d_train"] = [pool.submit(synthetic_split, {
                **gnn2d_cfg, "n_train": DATA_CHUNK, "data_seed": 100 + i},
                "train") for i in range(chunks)]
        if {"gnn2d", "fno", "gnn_bf16", "gnn_pre", "spc",
                "spc_graph"} & groups:
            jobs["b2d64_eval"] = [pool.submit(make_split, "B2D", DATA_CHUNK,
                                              nt2, res2, seed=100 + chunks + i)
                                  for i in range(chunks)]
        if "fno" in groups:
            jobs["b2d64_train"] = [pool.submit(make_split, "B2D", DATA_CHUNK,
                                               nt2, res2, seed=100 + i)
                                   for i in range(chunks)]
        if {"fno", "spc"} & groups:
            nt1, nx1 = DATAMODULE_1D["nt_train"], DATAMODULE_1D["nx_train"]
            jobs["e3"] = [pool.submit(make_split, "E3", DATA_CHUNK, nt1, nx1,
                                      seed=200 + i, n_steps=CE_STEPS)
                          for i in range(CE_TRAJ // DATA_CHUNK)]
        if "spc" in groups:
            jobs["e3_spc"] = [pool.submit(make_split, "E3", DATA_CHUNK, nt1,
                                          nx1, seed=200 + i, n_steps=CE_STEPS)
                              for i in range(CE_TRAJ // DATA_CHUNK,
                                             SPC_TRAJ // DATA_CHUNK)]

        if {"cnn", "no_interaction", "cnn_bf16", "cnn_pe", "par",
                "par_dist", "par_spc"} & groups:
            data["heat"] = heat_batches(16, 16, nt=HEAT_TEST["nt"],
                                        nx=HEAT_TEST["nx"])
            data["ks_loaders"] = build_loaders(
                {**ks_cfg, "source": "h5", **arrays(jobs["ks"])}, seed=0)
            data["ks_seconds"] = time.perf_counter() - t0
        if "b2d" in jobs:
            paths = arrays(jobs["b2d"])
            data["b2d_loaders"] = build_loaders(
                {**DATAMODULE_GRAPH_2D, **MPNN_2D_DATA, "source": "h5",
                 **paths}, seed=0, shuffle_eval=False)
            data["b2d_seconds"] = time.perf_counter() - t0
        if "b2d_extra" in jobs:
            extra = jobs["b2d_extra"].result()
            train = paths["train_path"]
            data["cnn2d_loaders"] = build_loaders(
                {**DATAMODULE_IMPLICIT_2D, "batch_size": CNN2D_BATCH, **paths,
                 "train_path": {k: np.concatenate([train[k], extra[k]])
                                for k in extra}},
                seed=0, shuffle_eval=False)
            data["cnn2d_seconds"] = time.perf_counter() - t0
        if "mpnn_paths" in groups:
            data["ce_loaders"] = build_loaders(
                {**DATAMODULE_GRAPH, **MPNN_1D_DATA, "source": "h5",
                 **arrays(jobs["ce"])}, seed=0)
            data["ce_seconds"] = time.perf_counter() - t0
        if {"gnn", "gnn_bf16", "gnn_pre", "par", "remat"} & groups:
            # the cnn group's KS and Heat trajectories
            ks = arrays(jobs["ks"])
            data["gnn_loaders"] = build_loaders(
                {**DATAMODULE_IMPLICIT_GNN, **SMOKE_DATA, "source": "h5",
                 **ks}, seed=0)
            data["gnn_pre_loaders"] = build_loaders(
                {**DATAMODULE_IMPLICIT_GNN, **SMOKE_DATA, "source": "h5",
                 **ks, **{f"{split}_path": {k: v[:GNN_PRE_TRAJ]
                                            for k, v in ks[f"{split}_path"]
                                            .items()}
                          for split in ("train", "val")}}, seed=0)
            data["gnn_eval"] = synthetic_test_batches(
                "magnet_gnn", GNN_EVAL_TRAJ, GNN_EVAL_TRAJ, seed=0)
            data["gnn_seconds"] = time.perf_counter() - t0
        if "b2d64_eval" in jobs:
            eval64 = joined(jobs["b2d64_eval"])
        if {"gnn2d", "gnn_bf16", "gnn_pre", "spc", "spc_graph"} & groups:
            regular = regular_32(eval64)
            data["gnn2d_loaders"] = build_loaders(
                {**gnn2d_cfg, "source": "h5",
                 "train_path": joined(jobs["gnn2d_train"]),
                 "val_path": regular, "test_path": regular},
                seed=0, shuffle_eval=False)
            data["gnn2d_eval"] = list(data["gnn2d_loaders"]["test"])
            data["gnn2d_seconds"] = time.perf_counter() - t0
        if "fno" in groups:
            data["fno_2d_loaders"] = build_loaders(
                {**DATAMODULE_2D, "train_path": joined(jobs["b2d64_train"]),
                 "val_path": eval64, "test_path": eval64},
                seed=0, shuffle_eval=False)
            e3 = joined(jobs["e3"])
            data["fno_1d_loaders"] = build_loaders(
                {**DATAMODULE_1D, **{f"{split}_path": e3 for split in SPLITS}},
                seed=0, shuffle_eval=False)
            data["fno_seconds"] = time.perf_counter() - t0
        if "spc" in groups:
            # SPC_TRAJ E3 trajectories for training, the fno group's 32 for
            # validation and test, in the MPNN-1D and the FNO-1D datamodules
            e3 = {f"{split}_path": joined(jobs["e3"]) for split in SPLITS}
            e3["train_path"] = joined(jobs["e3"] + jobs["e3_spc"])
            for key, dm in (("spc_mpnn_loaders", DATAMODULE_GRAPH),
                            ("spc_fno_1d_loaders", DATAMODULE_1D)):
                data[key] = build_loaders({**dm, **e3}, seed=0,
                                          shuffle_eval=False)
            # and with a NaN in one training trajectory's targets
            nan = joined(jobs["e3"] + jobs["e3_spc"])
            nan[f"pde_{nt1}-{nx1}"][5, 30, 7] = np.nan
            data["spc_fno_1d_nan_loaders"] = build_loaders(
                {**DATAMODULE_1D, **e3, "train_path": nan}, seed=0,
                shuffle_eval=False)
            data["spc_seconds"] = time.perf_counter() - t0
        if ks_spc & groups:
            # SPC_GRAPH_TRAJ KS trajectories for training (4 batches of 32),
            # the cnn group's 32 for validation, through the MAgNet[CNN] 1D
            # and the MAgNet[GNN] 1D datamodules (par_dist's dp fits too)
            ks = arrays(jobs["ks"])
            more = jobs["ks_more"].result()
            train = {k: np.concatenate([ks["train_path"][k], more[k]])
                     for k in more}
            for name, dm in (("magnet_cnn", DATAMODULE_IMPLICIT),
                             ("magnet_gnn", DATAMODULE_IMPLICIT_GNN)):
                data[f"spc_graph_{name}_loaders"] = build_loaders(
                    {**dm, **SMOKE_DATA, "source": "h5", **ks,
                     "train_path": train}, seed=0)
        if {"spc", "spc_graph"} & groups:
            # MAgNet[CNN] 2D and MAgNet[GNN] 2D: the cnn2d group's 24
            # Burgers-2D trajectories and the gnn2d group's 32 irregular
            # ones, each repeated to SPC_GRAPH_TRAJ (their datasets draw
            # every sample's queries anew), validated as those groups do
            def repeated(arrays):
                return {k: np.resize(v, (SPC_GRAPH_TRAJ, *v.shape[1:]))
                        for k, v in arrays.items()}

            b2d_train = {k: np.concatenate([paths["train_path"][k],
                                            jobs["b2d_extra"].result()[k]])
                         for k in paths["train_path"]}
            data["spc_graph_magnet_cnn_2d_loaders"] = build_loaders(
                {**DATAMODULE_IMPLICIT_2D, **paths,
                 "train_path": repeated(b2d_train)}, seed=0,
                shuffle_eval=False)
            data["spc_graph_magnet_gnn_2d_loaders"] = build_loaders(
                {**gnn2d_cfg, "source": "h5",
                 "train_path": repeated(joined(jobs["gnn2d_train"])),
                 "val_path": regular, "test_path": regular},
                seed=0, shuffle_eval=False)
            data["spc_graph_seconds"] = time.perf_counter() - t0
    return data


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    groups = tuple(argv) or GROUPS
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        print(f"chip_smoke: unknown group {unknown} (groups: {GROUPS})",
              file=sys.stderr)
        return 1
    from magnet_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = card()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": "off (matmul and cudnn)",
          "groups": groups})

    # 2. build: one nvcc per source, all started together; the host makes
    # the runs' data meanwhile
    t0 = time.perf_counter()
    def build_all():
        libs = cuda_build.build_all()
        return libs, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=1) as pool:
        building = pool.submit(build_all)
        data = make_data(groups)
        t_data = time.perf_counter() - t0
        libs, t_build = building.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_building": t_build,
          "seconds_making_data_meanwhile": t_data,
          "data_workers": DATA_WORKERS,
          "libraries": {name: {"library": lib.name, "ptxas": ptxas_lines(lib)}
                        for name, lib in libs.items()}})

    kernels, extra = [], {}
    for group_names, phases in ((("cnn",), cnn_phases),
                                (("mpnn_kernels", "mpnn_paths"), mpnn_phases),
                                (("cnn2d",), cnn2d_phases),
                                (("gnn",), gnn_phases),
                                (("gnn2d",), gnn2d_phases),
                                (("fno",), fno_phases),
                                (("no_interaction",), no_interaction_phases),
                                (("cnn_bf16",), cnn_bf16_phases),
                                (("cnn2d_bf16",), cnn2d_bf16_phases),
                                (("gnn_bf16",), gnn_bf16_phases),
                                (("cnn_pe",), cnn_pe_phases),
                                (("gnn_pre",), gnn_pre_phases),
                                (("par", "par_dist", "par_spc"),
                                 par_phases),
                                (("tune",), tune_phases),
                                (("remat",), remat_phases),
                                (("spc",), spc_phases),
                                (("spc", "spc_graph"), spc_graph_phases)):
        if set(group_names) & set(groups):
            t_group = time.perf_counter()
            rc, entries, more = phases(dev, data, groups)
            print(f"chip_smoke: {'/'.join(group_names)} took "
                  f"{time.perf_counter() - t_group:.1f} s", file=sys.stderr,
                  flush=True)
            kernels += entries
            for name, counts in more.items():
                extra.setdefault(name, {}).update(counts)
            if rc:
                emit({"kernels": kernels})
                return rc
    # a kernel's launches (and times) on the paths of another group
    for entry in kernels:
        for key, n in extra.get(entry["name"], {}).items():
            entry[key] = n
            if key.startswith("launches"):
                entry["launches"] += n
    # each row's share of its bound: the tensor-core bound where the kernel
    # issues its products there (tf32x3), else the f32 one; the bf16 rows
    # give theirs (the bf16 rate)
    for entry in kernels:
        if "share_of_bound" in entry:
            continue
        tc = "tc_bound_ms" in entry
        entry["share_of_bound"] = (entry["tc_bound_ms" if tc else "bound_ms"]
                                   / entry["ms"])
        entry["share_against"] = ("tc_bound_ms (tf32x3, 495 TFLOP/s)" if tc
                                  else "bound_ms (f32, 67 TFLOP/s)")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
