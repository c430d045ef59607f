#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (scade_tpu_torch) on one NVIDIA card and checks it.

    python3 chip_smoke.py [--seed N] [--steps N]
                          [--k1-only | --k2-only | --prior-only | --quality-only
                           | --dp-only N]

Builds the CUDA kernels from scade_tpu_torch/csrc/ (one nvcc per source, all
at once), then prints one line per phase (with --k1-only the device and k1
lines, with --k2-only the device and k2 lines, for comparing a kernel's
builds of two trees on one card):

  device  card name and power limit (nvidia-smi), build time, K1's registers,
          spills and warnings (ptxas), its tile, ring stages and resident blocks, and
          its tensor-core instructions (cuobjdump -sass: HGMMA, from wgmma, in
          bf16 and tf32; none of either, or any HMMA, is a fault)
  k1      the fused PE + MLP kernel, through its wrapper, against its plain
          version at the main path's launch shapes (D=8, W=256, F=9): a train
          step's 65,536 coarse and 196,608 fine points and a render chunk's
          1,048,576 and 3,145,728, each in f32 and bf16, the weights' packing
          included; in bf16 also the plain version against itself with its
          sums reordered, and both against the same function summed in f64;
          the weight bytes each launch reads from L2; K1's backward kernels
          at a train step's two shapes (f32): bit-equal over two calls, held
          to the plain f32 gradient and, where no ReLU decision is near 0,
          to the f64 one, which a TF32-products control misses; their device
          time beside their bound (the recompute, the input gradients and
          the weight gradients in 3xTF32) and the plain recompute's time
  k2      the sampling kernel (CDF build + inverse-CDF lookup) at 1,024,
          16,384 and 65,536 rays, M=63 and M=191, S=128, with draws of
          exactly 0 and 1: bit for bit the plain sample_pdf (the same CDF
          law, the JAX package's order of sums) on random and dyadic
          weights and on opaque rows (a ray's weight, 1.0 or 0.999, in 5
          adjacent bins, where an ulp of the CDF decides the 1e-5 guard),
          with the guard's shares there; its device and wall times; one
          forward call must run one kernel. Its backward kernel at 1,024
          rays, M=63 and 191: bit for bit its torch transcription, two
          launches equal, on dyadic weights against autograd through the
          plain sample_pdf; device and wall times, the plain backward's, the
          bytes bound; and on peaked weights (98% of a ray's weight in 3
          adjacent bins, as a trained NeRF's) and opaque ones bit for bit
          again, with their device times (opaque ones also against autograd
          on every draw)
  train   the reference-default train step (64+128 samples, 8x256, N_rand
          1024, f32) on a seeded scene shaped like a SCADE ScanNet scene:
          18 train + 2 val views at 468x624, K=20 hypotheses
  split   where a train step's time goes (forward, backward, Adam), and the
          step with both kernels off (their plain versions)
  repro   one train step twice from one state and seed, f32 and bf16: every
          grad and updated parameter bit-equal; the ops that
          torch.use_deterministic_algorithms warns about in the step, and
          the step's ms with that switch on and off
  check   render_rays through the kernels against the plain path, 512 rays
  render  a full 468x624 val view through render_image, f32 and bf16
  cli     the port's CLI as a user runs it (python -m scade_tpu_torch): a
          ScanNet-shaped scene written to a temporary directory (18 train + 2
          val + 2 test views at 468x624, PNGs, K=20 .npy hypotheses, 6 video
          poses), then `train` for 20 steps at the reference defaults with
          .tar files at 10 and 20 and the i_img renders at 20, then `test`,
          then the train run resumed (10 + 10 steps); K1 and K2 must launch 2
          per step and 36 per view, K2's backward 1 per step and 0 per view,
          the .tar reload bit-equal, the resumed run's 000020.tar the
          straight run's bit for bit, the two metrics.txt agree, and the
          hypotheses load through the native library (`train`) and then from
          its blob (`test`)
  tasks   on the cli phase's scene and run: `test_opt` (its metrics those of
          `test`), `video` (2 frames of 468x276, 16 K1 + 16 K2 launches a
          frame, a file that decodes to 2 frames), then `train --input_ch_cam
          4` for 5 steps (0 K1 + 2 K2 a step) and `test_opt` fitting a camera
          latent per test view (2 finite latent files)
  wild    `python -m scade_tpu_torch.wild train --mask_edges true` on the
          scene read as a processed (wild) scene, 10 steps, then wild `test`
  dp      data parallelism: `train --multihost` on 2 ranks (torchrun; NCCL
          with a card a rank, else gloo on the one card) for 5 steps, held to
          1 rank run twice (the two bit-equal; the first step's loss and
          gradients and the parameters' median distance within 1e-5), the
          ranks' parameters bit-equal, then a sharded `test` against 1 rank
  tp      the mesh's model axis (parallel/mesh.py): 2 ranks as data 1 x model 2
          (torchrun, gloo on the one card), the reference defaults on the
          train phase's scene, 5 steps with K1 on (its weights gathered whole,
          2 launches a step per rank) and 1 on the column-parallel plain path
          (use_fused=False), each held to 1 rank run twice as dp holds its
          ranks; the replicated tensors bit-equal across the model ranks,
          half of each sharded weight, bias and Adam moment on each rank
  spvcnn  the SPVCNN classifier (prior/spvcnn.py) at cr=1.0 through
          refine_focal (5 channels) and refine_shift (3 channels) on a seeded
          468x624 depth map at the input functions' 100,000-point capacity: the
          card's logits against the CPU's (f32, TF32 off), forward ms with
          the kernel maps apart from the gathers and products, peak GB, the
          voxel sites at each stride
  prior_train  the depth prior's training path as a user runs it:
          `python -m scade_tpu_torch.prior.train` on the cli phase's kind of
          scene with the full-width ResNeXt101-32x8d cIMLE model (v2,
          d_latent 32, 448 crop, the five-loss criterion, fresh seeded
          weights): one epoch at batch 4 (AdaIn init over the 18 views, a
          recache of 20 z a view, 5 SGD steps) in f32 with TF32 off, then a
          short bf16 run; its files and finite losses; step times at batch 4
          in f32, f32+TF32 and bf16 against the FLOP bound; and one SGD step
          on the card against the CPU's (two batches, one with quality 3
          and planes so that every loss carries gradient), its update held
          to the same step in f64 as the CPU's is
  prior   the depth prior's inference path on the checkpoint prior_train
          wrote: the model loaded as a user's .pth is, at the 448 crop, the
          card's f32 against the CPU's and bf16 against f32, forward times
          and the FLOP bound; then
          `python -m scade_tpu_torch.prior.dump` on the cli phase's kind of
          scene (360 hypotheses, K=20, bf16) and the CLI's `train` for 5 steps
          on what it wrote, K1 and K2 at 2 launches a step
  prior_pretrain  the prior's pretraining path as a user runs it: a corpus in
          the reference's layout (16 taskonomy views at 512x512 with depth
          and planes, 8 diml_ganet views at 432x768 with disparity), then
          `python -m scade_tpu_torch.prior.train --dataset multi` for one
          epoch of the full-width model (16 examples interleaved, the AdaIn
          init over 8, a recache of 20 z each, 4 steps at batch 4, f32 with
          TF32 off); its files, finite losses, the sources' order; step, recache
          and host read times, peak memory. Then (line prior_dp) its
          checkpoint's first step at global batch 4 on 2 ranks (torchrun,
          gloo on the one card; the ranks' states bit-equal) against the
          1-rank step and the f64 step, and
          the baseline model (ResNeXt101 + AuxiNetV2): card f32 against the
          CPU, a train-mode forward and backward with both criteria at batch 4

then the kernels line (one JSON object per kernel, K2's backward its own:
launches in the cli phase's train run, error, times and bound), the card's
name and power limit, and last a JSON line naming the device. Exits non-zero, with no result line, when
there is no CUDA device or any phase fails. Needs one card. With --dp-only N
it runs the device phase, then the dp phase on N ranks (NCCL where there
are N cards), for even N the tp phase on N ranks (N/2 x 2), and the prior's
first step over N ranks from seeded weights (line prior_dp; N divides 4),
and prints no result line; with --prior-only
the device, prior_train, prior and prior_pretrain phases, and no result
line; with --prior-dp-repeat N the device phase and N prior_pretrain phases
(N lines prior_dp), and no result line; with --quality-only the device
phase, then line quality (see QUALITY_SCENE), and no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

from scade_tpu_torch import _kernels, cli, wild
from scade_tpu_torch.data import image_io
from scade_tpu_torch.data import scene as scene_io
from scade_tpu_torch.eval import evaluate
from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.ops import fused_mlp, fused_sampling, sampling
from scade_tpu_torch.ops.embedding import Embedder, positional_encoding
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.parallel import dist as par_dist
from scade_tpu_torch.parallel import mesh as tp_mesh
from scade_tpu_torch.prior import data as prior_data
from scade_tpu_torch.prior import dump as prior_dump
from scade_tpu_torch.prior import losses as prior_losses
from scade_tpu_torch.prior import model as prior_model
from scade_tpu_torch.prior import spvcnn
from scade_tpu_torch.prior import train as prior_train
from scade_tpu_torch.render.renderer import (
    SceneVars,
    make_render_config,
    render_image,
    render_rays,
)
from scade_tpu_torch.train import loop
from scade_tpu_torch.train import step as train_step
from scade_tpu_torch.train.step import (
    SceneTensors,
    TrainConfig,
    apply_grads,
    compute_loss,
    create_train_state,
    make_train_step,
    sample_ray_batch,
)
from scade_tpu_torch.utils import ckpt

# NVIDIA H100 SXM data sheet, dense: f32 on the CUDA cores, bf16 and TF32 tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
HBM_BYTES = 3.35e12

H, W = 468, 624
N_TRAIN, N_VAL, N_TEST, K_HYP = 18, 2, 2, 20
RENDER_CHUNK = 16384
# K1 against its plain version, per point (max abs over its 4 outputs).
# f32: 1e-4 at every point; the kernel's 3xTF32 products are f32-accurate.
# bf16: the plain version rounds operands to bf16 where the kernel does and
# sums in f32, so only the order of the sums differs; but an activation
# whose f32 sum lies near a bf16 rounding boundary can round the other way
# in another order, and that flip carries through the later layers. So in
# bf16 the kernel is held to two witnesses measured in the same run on the
# same points: the plain version against itself with its sums reordered
# (its share of points within K1_TOL, less K1_BF16_SHARE_SLACK, and
# K1_BF16_MAX_RATIO times its largest error), and the exact sums (each of
# the kernel and the plain version against an oracle that rounds as they do
# but sums in f64: the kernel's share within K1_TOL at most
# K1_BF16_SHARE_SLACK below the plain version's). A kernel that rounded with
# a bias, or got a fraction of its points wrong, would fall behind both. The
# median stays under K1_BF16_MEDIAN. An f32 output differs from a bf16 one by
# ~7e-3 (median ~1e-3), so either bound tells the modes apart.
K1_TOL = 1e-4
K1_BF16_SHARE_SLACK, K1_BF16_MAX_RATIO, K1_BF16_MEDIAN = 0.01, 2.0, 1e-6
# K1's backward, each tensor's largest difference over the largest entry of
# the f64 gradient from |g| (tests/test_torch_cuda.py::
# test_k1_backward_is_the_plain_gradient, where the readings are): against
# the plain f32 gradient, whose ReLU decisions it takes (K1_BWD_PLAIN_TOL);
# and against the f64 gradient with the upstream gradient zeroed at the
# points where a pre-activation of the f64 network lies within K1_BWD_MARGIN
# of 0 (relative to its layer's largest there), which a TF32-products
# control misses (K1_BWD_TOL).
K1_BWD_PLAIN_TOL, K1_BWD_TOL, K1_BWD_MARGIN = 1e-5, 5e-5, 2.0**-13
# K2 against the plain sample_pdf, which builds the CDF in the kernel's
# order (the JAX package's, fused_sampling.cdf_kernel_order) and rounds
# operation by operation as the kernel does: bit for bit on random, dyadic
# and opaque rows (k2_opaque, where the CDF's last ulp decides the 1e-5
# guard). The phase prints the share of the opaque rows' empty bins whose
# CDF gap takes the guard, and of draws that take it.
# K2's backward kernel exactly against its torch transcription
# (fused_sampling.sample_pdf_backward_kernel_order); against autograd
# through the plain sample_pdf (the same CDF, so the same intervals and
# guard decisions) with rtol K2_BWD_TOL[0] and an atol of K2_BWD_TOL[1]
# times the largest entry (at least 1) on dyadic weights, K2_BWD_TOL[2] on
# opaque ones: the gradients' sums run in other orders, and the plain
# backward's gathers add with atomics (tests/test_torch_cuda.py::grads_close).
K2_BWD_TOL = (1e-4, 1e-6, 1e-4)
CHECK_TOL = {"rgb_map": 1e-3, "depth_map": 1e-2}
# The prior phase: the dump's z dimension and K, and the NeRF steps on its output.
PRIOR_D_LATENT, PRIOR_K, PRIOR_NERF_STEPS = 32, 20, 5
# The card's f32 forward (TF32 off) against the CPU's: max abs error over max
# |output|. Both sum in f32, in other orders and with other convolution
# algorithms, through the model's full depth of random weights; the CPU tests
# hold two f32 implementations of the small model to 1e-4, and bf16 differs
# by ~1e-2.
PRIOR_F32_TOL = 1e-3
# bf16 against f32: mean relative difference, tests/test_prior.py's bound on
# the JAX package's bf16 dump.
PRIOR_BF16_REL = 0.05
# The prior_train phase: the trainer's flags (its per-scene defaults, cut to
# one epoch; every train view in the AdaIn init), and one SGD step on the
# card (f32, TF32 off) against the same step on the CPU, from the same
# weights, z and sampled pixels, B=1. Each loss within PRIOR_STEP_LOSS_REL of
# the total loss (the plane loss is a sum of 1 − cos near 0, ~4e-6 here, so
# its own relative error is a cancellation's). The BatchNorm running
# statistics within PRIOR_STEP_BN_REL of each tensor's largest magnitude. The
# parameters' update is held to a witness measured in the same run: the same
# step on the CPU in f64. The f32 gradient of this model is ill-conditioned
# (at B=1 the train-mode BatchNorms subtract the mean of nearly uniform
# incoming gradients), so two f32 steps that sum in other orders differ by
# several % of the largest update (4-6% card against CPU, H100 80GB HBM3, 700 W);
# the card's update must lie no further from the f64 one than
# PRIOR_STEP_WITNESS_RATIO times the CPU's f32 update does (L2 over all
# parameters).
PRIOR_TRAIN_ARGS = ["--epochs", "1", "--batchsize", "4", "--num_samples", "20",
                    "--mini_batch_size", "5", "--adain_subset", str(N_TRAIN)]
PRIOR_STEP_LOSS_REL, PRIOR_STEP_BN_REL, PRIOR_STEP_WITNESS_RATIO = 1e-3, 1e-3, 2.0
# The prior_pretrain phase: a corpus in the reference's layout of two
# sources (name: images, height, width): taskonomy's square 512 renders with
# depth and plane masks, diml_ganet's non-square frames with disparity only.
# One epoch of the sampler's order (each source extended to the longest, 16,
# then cut by the sample ratio: 2 × 8 = 16 examples, 4 steps at batch 4)
# after an AdaIn init over the first 8 and a recache of 20 z each.
PRETRAIN_CORPUS = {"taskonomy": (16, 512, 512), "diml_ganet": (8, 432, 768)}
PRETRAIN_SAMPLE_RATIO = 0.5
PRETRAIN_ARGS = ["--epochs", "1", "--batchsize", "4", "--num_samples", "20",
                 "--mini_batch_size", "5", "--adain_subset", "8",
                 "--sample_ratio", str(PRETRAIN_SAMPLE_RATIO)]
# Its 2-rank check: the first step at global B=4 on 2 ranks (gloo on the one
# card) against the 1-rank step, f32 without TF32, from the same weights, z
# and draws. Each loss within PRETRAIN_DP_LOSS_REL of the total loss; the
# BatchNorm running statistics within PRETRAIN_DP_BN_REL of each tensor's
# largest magnitude; the ranks' states after the step bit-equal; the update
# by the prior_train phase's rule: the 2-rank update no further from the same
# step in f64 than PRIOR_STEP_WITNESS_RATIO times the 1-rank f32 update is
# (L2 over all parameters). --prior-dp-repeat prints both distances for N
# fresh pretraining runs.
PRETRAIN_DP_LOSS_REL, PRETRAIN_DP_BN_REL = 1e-3, 1e-4
# Steps each rank times after the checked one.
PRETRAIN_DP_TIMED = 1
# The baseline model's auxi losses, on top of the five-loss default.
AUXI_LOSS_MODE = (prior_losses.DEFAULT_LOSS_MODE
                  + "ranking-edge-auxi_msgil-normal-auxi_meanstd-tanh-auxi_")
# Video poses in write_scene's scene: the video task renders every 3rd.
N_VIDEO = 6
# Two runs of one program on the card agree in metrics.txt to this, relative
# (a render is deterministic; only training is not).
METRICS_REL = 1e-6
# The dp phase: 2 ranks against 1, each train run this many steps. A train
# run on one card is bit-reproducible (K2's backward adds in a fixed order;
# phase repro), so the 1-rank run is made twice and the two must be
# bit-equal. The 2-rank run is not the 1-rank run bit for bit: its sums over
# the batch are taken in halves (each rank's block, then the all-reduce),
# another order of f32 adds. So it is held to DP_REL of the magnitude: the
# first step's loss and the first step's gradients, summed over the ranks
# (all runs start from the same parameters on the same batch, so only the
# order of the sums differs; Adam is blind to the gradients' scale, so only
# they show a wrong 1/world), and the parameters after DP_STEPS steps by the
# median of their distances. Not by the largest: Adam moves a parameter by
# about lr whatever its gradient's size, so a gradient near zero whose sign
# the halved sums flip moves it by ~2 lr = 1e-3 against the 1-rank run; the
# largest distance is a count of flips, not an error. The later steps'
# losses drift apart for the same reason and are printed, not held.
DP_STEPS, DP_REL = 5, 1e-5
# The tp phase: the model axis (parallel/mesh.py) on a grid of ranks with
# TP_N_MODEL model columns, at the reference defaults, held to 1 rank run
# twice by the dp phase's rule: DP_STEPS steps with K1 on (its weights
# gathered whole), then TP_PLAIN_STEPS with use_fused=False (the
# column-parallel MLP, its activations gathered) against the plain 1-rank
# step. The model group's all-reduces and gathers are sums in other orders
# too, so the grid's run is held to DP_REL, and the two 1-rank runs must be
# bit-equal.
TP_N_MODEL, TP_PLAIN_STEPS = 2, 1
# The spvcnn phase: the classifier at cr=1.0 (pres = vres = 0.01) on a
# seeded 468x624 depth map at focal
# SPVCNN_FOCAL px, through refine_focal (5 channels, voxel 0.005) and
# refine_shift (3 channels, voxel 0.01) at the input functions' 100,000-point
# capacity. The card's logits, each stage's output and the pooled features
# (f32, TF32 off) against the CPU's to SPVCNN_RTOL of their largest entry
# (the logits with atol SPVCNN_ATOL): both sum in f32 in other orders
# (the products, and index_add_ in the voxel means and pooling, which the
# card sums in no fixed order); the sites and kernel maps are exact on both.
SPVCNN_FOCAL, SPVCNN_RTOL, SPVCNN_ATOL, SPVCNN_REPS = 577.9, 1e-4, 1e-6, 5
# The --quality-only check: BASELINE.md round 5's dense-view head-to-head
# (:977-1007), the port trained as a user trains it. The scene
# (tools/make_synthetic_scene.py, numpy only): 32 train views at 96x128 with
# a backdrop wall (75% of pixels with depth), K=20 hypotheses; 4,000 steps at
# N_rand 128 and 32+64 samples, space carving 0.007, every other flag at its
# default; f32 and bf16, each at QUALITY_SEEDS. Pass bar per run: finite
# losses, test depth RMSE inside the union of the upstream oracle's seeds
# {0.2438, 0.2706} and scade_tpu's {0.257, 0.273, 0.349} widened by 10% at
# each end, fine test PSNR at least QUALITY_PSNR (33.6-35.6 on both sides).
# The first f32 seed runs twice, and its two final .tar files must be
# bit-equal.
QUALITY_SCENE = ["--backdrop", "--n_train", "32", "--K", "20", "--H", "96", "--W", "128"]
QUALITY_ARGS = ["--N_rand", "128", "--N_samples", "32", "--N_importance", "64",
                "--num_hypothesis", "20", "--space_carving_weight", "0.007",
                "--num_iterations", "4000", "--i_weights", "4000", "--i_img", "1000000",
                "--i_print", "500", "--cimle_dir", "dump"]
QUALITY_SEEDS, QUALITY_RMSE, QUALITY_PSNR = (0, 1), (0.219, 0.384), 32.0
SCRIPT = os.path.abspath(__file__)


def line(tag: str, **fields) -> None:
    print(f"{tag} " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nerf_macs(D: int, W_: int, E: int) -> int:
    """Multiply-adds per point of the fused network (skip after layer 4)."""
    trunk = E * W_ + (D - 1) * W_ * W_ + E * W_  # layer 0, layers 1..D-1, skip rows
    return trunk + W_ + W_ * W_ + (W_ + 3) * (W_ // 2) + (W_ // 2) * 3


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    per_source = _kernels.build()
    build_s = time.perf_counter() - t0
    for name in _kernels.SOURCES:
        _kernels.load(name)
    tc = k1_tensor_core_instructions()
    ptxas = k1_ptxas()
    line("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=round(build_s, 3), build_s_per_source=per_source, k1_sass=tc,
         k1_ptxas=ptxas, k1_geometry=fused_mlp.kernel_geometry())
    if not (tc["HGMMA.F32.BF16"] and tc["HGMMA.F32.TF32"]) or tc["HMMA"]:
        raise RuntimeError(f"device: K1's layers are not all on wgmma (HGMMA): {tc}")
    return {"smi": smi, "sass": tc}


def k1_tensor_core_instructions() -> dict:
    """Counts K1's tensor-core instructions in the built library's SASS: the
    warpgroup products (HGMMA, from wgmma) in bf16 and tf32, and the warp
    products (HMMA, from mma.sync), of which there must be none: every
    W-wide and W/2-wide layer runs on wgmma."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_kernels.library_path("fused_mlp"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    ops = re.findall(r"\b(HGMMA|HMMA)\.(\S+)", sass)
    shapes = sorted({f"{op}.{form}" for op, form in ops})
    return {"HGMMA.F32.BF16": sum(op == "HGMMA" and "F32.BF16" in f for op, f in ops),
            "HGMMA.F32.TF32": sum(op == "HGMMA" and "F32.TF32" in f for op, f in ops),
            "HMMA": sum(op == "HMMA" for op, _ in ops), "forms": shapes}


def k1_ptxas() -> dict:
    """Registers, stack and spills of each K1 instantiation (the forward's
    and the backward's delta, fix-up and dW kernels), from the build log,
    and any warning ptxas gave (a setmaxnreg it ignored, wgmma products it
    serialized). Raises if the log names no instantiation of the kernel."""
    res, name, warnings = {}, None, []
    for text in (_kernels.BUILD / "fused_mlp.log").read_text().splitlines():
        m = re.search(r"fused_mlp_kernelI(13__nv_bfloat16|f)Li(\d+)E", text)
        b = re.search(r"k1_backward_(delta|fix|dw)_kernelILi(\d+)E", text)
        if "warning" in text.lower() or "Performance Loss" in text:
            warnings.append(text.strip())
        if "Function properties for" in text and m:
            name = f"{'bf16' if m.group(1) != 'f' else 'f32'}_W{m.group(2)}"
            res[name] = {}
        elif "Function properties for" in text and b:
            name = f"bwd_{b.group(1)}_W{b.group(2)}"
            res[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)):
            res[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", text)):
            res[name]["registers"] = int(m.group(1))
            name = None
    want = {f"{t}_W{w}" for t in ("bf16", "f32", "bwd_delta", "bwd_fix", "bwd_dw")
            for w in (64, 128, 256)}
    if set(res) != want or not all("registers" in r for r in res.values()):
        raise RuntimeError(f"k1_ptxas: the build log names {sorted(res)}, expected {sorted(want)}")
    res["warnings"] = warnings
    return res


def permute_hidden(weights, cfg, gen: torch.Generator):
    """The same network with every trunk layer's units permuted: each next
    layer then takes its sums over them in another order."""
    ws = [w.detach().clone() for w in weights]
    E = 3 + 6 * cfg.num_freqs
    for layer in range(cfg.D):
        p = torch.randperm(cfg.W, generator=gen).to(ws[0].device)
        ws[2 * layer], ws[2 * layer + 1] = ws[2 * layer][p], ws[2 * layer + 1][p]
        for nxt in ([cfg.D, cfg.D + 1] if layer == cfg.D - 1 else [layer + 1]):
            w = ws[2 * nxt]
            skip = nxt < cfg.D and (nxt - 1) in cfg.skips  # reads [emb, h]
            ws[2 * nxt] = (torch.cat([w[:, :E], w[:, E:][:, p]], 1) if skip else w[:, p]).contiguous()
    return ws


def point_errors(a, b) -> dict:
    err = (a - b).abs().amax(-1)
    return dict(max=err.max().item(), median=err.median().item(),
                share_within_tol=(err <= K1_TOL).float().mean().item())


def bf16_exact_sums(weights, cfg, pts, dirs, chunk: int = 1 << 20):
    """K1's bf16 function with its sums taken in f64: the PE in f32 and every
    product's operands rounded to bf16, as the kernel and the plain version
    do, then f64 sums and biases. (N, 4) f32."""
    ws = [w.detach().to(torch.bfloat16).double() for w in weights[0::2]]
    bs = [b.detach().double() for b in weights[1::2]]
    emb_cfg = fused_mlp.Embedder(input_dims=3, num_freqs=cfg.num_freqs,
                                 max_freq_log2=float(cfg.num_freqs - 1))

    def dense(x, i):
        return torch.nn.functional.linear(x.to(torch.bfloat16).double(), ws[i], bs[i])

    out = []
    for s in range(0, pts.shape[0], chunk):
        emb = fused_mlp.positional_encoding(pts[s:s + chunk], emb_cfg).double()
        h = emb
        for i in range(cfg.D):
            x = torch.cat([emb, h], -1) if i > 0 and (i - 1) in cfg.skips else h
            h = torch.relu(dense(x, i))
        alpha = dense(h, cfg.D)
        feature = dense(h, cfg.D + 1)
        hv = torch.relu(dense(torch.cat([feature, dirs[s:s + chunk].double()], -1), cfg.D + 2))
        rgb = dense(hv, cfg.D + 3)
        out.append(torch.cat([rgb, torch.nn.functional.softplus(10.0 * alpha) / 10.0], -1).float())
        del emb, h, x, alpha, feature, hv, rgb
    return torch.cat(out)


def bf16_agrees(kernel: dict, reordered: dict, kernel_exact: dict, plain_exact: dict) -> bool:
    """The bf16 bound (see K1_TOL): the kernel against the plain version
    (``kernel``) beside the plain version reordered (``reordered``), and
    each against the exact sums."""
    return (kernel["share_within_tol"] >= reordered["share_within_tol"] - K1_BF16_SHARE_SLACK
            and kernel["max"] <= K1_BF16_MAX_RATIO * reordered["max"]
            and kernel["median"] <= K1_BF16_MEDIAN
            and kernel_exact["share_within_tol"]
            >= plain_exact["share_within_tol"] - K1_BF16_SHARE_SLACK)


def phase_k1(gen: torch.Generator, sass: dict) -> dict:
    """K1 through its wrapper, ``fused_nerf_apply``, at every shape the main
    path launches it with: a train step's coarse and fine passes and a full
    render chunk's, in f32 and bf16, each against the plain version. Bounds:
    bf16 at the tensor cores' bf16 rate; f32 at their TF32 rate for the
    three products 3xTF32 takes (fma_bound_ms: one product at the CUDA
    cores' f32 rate, the bound of the first K1)."""
    dev = torch.device("cuda")
    rc, tc = make_render_config(), TrainConfig()
    nc = rc.nerf_coarse
    cfg = fused_mlp.FusedCfg(nc.D, nc.W, rc.embed_pos.num_freqs, nc.skips)
    model = NeRF(nc, generator=gen).to(dev)
    weights = fused_mlp.flat_weights(model)
    reordered = permute_hidden(weights, cfg, gen)
    n_params = sum(w.numel() for w in weights)
    flop_per_point = 2 * nerf_macs(nc.D, nc.W, nc.input_ch)
    per_ray = {"coarse": rc.n_samples, "fine": rc.n_samples + rc.n_importance}
    launches = {f"{where}_{p}": rays * s for where, rays in (("train", tc.n_rand),
                                                               ("render", RENDER_CHUNK))
                for p, s in per_ray.items()}
    # The wrapper packs the weights on every call; kernel_ms includes it, and
    # pack_ms is its share.
    with torch.no_grad():
        pack_ms = {name: cuda_ms(lambda: fused_mlp.pack_weights(weights, cfg, dt), 20)
                   for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    # Bytes each launch reads from L2: every staged chunk and the heads once
    # per tile.
    geo = fused_mlp.kernel_geometry()
    l2_bytes = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        parts = fused_mlp.pack_layout(cfg, dt)
        elem = torch.empty((), dtype=dt).element_size()
        l2_bytes[name] = (sum(p.size for p in parts if p.staged) * elem,
                          sum(p.size for p in parts if not p.staged) * elem)
    res = {}
    for key, n in launches.items():
        pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
        dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(dev)
        reps = max(2, 655_360 // n)
        for dname, dt, peak, passes in (("f32", torch.float32, PEAK_TF32, 3),
                                        ("bf16", torch.bfloat16, PEAK_BF16, 1)):
            entry = {}
            with torch.no_grad():
                got = fused_mlp.fused_nerf_apply(model, cfg, pts, dirs, dt)
                ref = fused_mlp.fused_mlp_plain(weights, cfg, pts, dirs, dt)
                err = point_errors(got, ref)
                if dt == torch.float32:
                    ok = err["max"] <= K1_TOL
                else:
                    other = fused_mlp.fused_mlp_plain(reordered, cfg, pts, dirs, dt)
                    exact = bf16_exact_sums(weights, cfg, pts, dirs)
                    entry.update(plain_reordered_vs_plain=point_errors(other, ref),
                                 kernel_vs_exact=point_errors(got, exact),
                                 plain_vs_exact=point_errors(ref, exact))
                    ok = bf16_agrees(err, entry["plain_reordered_vs_plain"],
                                     entry["kernel_vs_exact"], entry["plain_vs_exact"])
                    del other, exact
                ok = ok and bool(torch.isfinite(got).all())
                del got, ref
                ms = cuda_ms(lambda: fused_mlp.fused_nerf_apply(model, cfg, pts, dirs, dt), reps)
                plain_ms = cuda_ms(lambda: fused_mlp.fused_mlp_plain(weights, cfg, pts, dirs, dt),
                                   reps)
            flops = flop_per_point * n
            nbytes = n * (6 + 4) * 4 + n_params * (2 if dt == torch.bfloat16 else 4)
            ops_s, bytes_s = passes * flops / peak, nbytes / HBM_BYTES
            entry.update(
                points=n, ok=ok, max_abs_err=err["max"], median_err=err["median"],
                share_within_tol=err["share_within_tol"], kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=max(ops_s, bytes_s) * 1e3,
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                tflops=flops / ms / 1e9)
            tiles = -(-n // geo["tile"])
            staged, heads = l2_bytes[dname]
            entry["l2_weight_bytes"] = tiles * (staged + heads)
            entry["l2_weight_bytes_per_point"] = entry["l2_weight_bytes"] / n
            if dt == torch.float32:
                entry["fma_bound_ms"] = flops / PEAK_F32 * 1e3
            res[f"{key}_{dname}"] = entry
        del pts, dirs
        torch.cuda.empty_cache()
    for key in ("train_coarse", "train_fine"):
        res[f"{key}_backward"] = k1_backward(model, cfg, launches[key], gen)
        torch.cuda.empty_cache()
    line("k1", D=nc.D, W=nc.W, F=rc.embed_pos.num_freqs, mflop_per_point=flop_per_point / 1e6,
         tol=dict(f32=K1_TOL, bf16=dict(point=K1_TOL, share_slack=K1_BF16_SHARE_SLACK,
                                        max_ratio=K1_BF16_MAX_RATIO, median=K1_BF16_MEDIAN),
                  backward=dict(plain=K1_BWD_PLAIN_TOL, f64=K1_BWD_TOL, margin=K1_BWD_MARGIN)),
         sass=sass, geometry=geo, pack_ms=pack_ms, **res)
    bad = [k for k, r in res.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"k1: kernel disagrees with its plain version at {bad}")
    step = [res["train_coarse_f32"], res["train_fine_f32"]]  # one train step's two launches
    bwd = [res["train_coarse_backward"], res["train_fine_backward"]]
    return dict(backward=dict(ms=sum(b["kernel_ms"] for b in bwd),
                              plain_ms=sum(b["plain_ms"] for b in bwd),
                              bound_ms=sum(b["bound_ms"] for b in bwd),
                              max_rel_err_vs_plain=max(b["max_rel_err_vs_plain"] for b in bwd),
                              max_rel_err_vs_f64=max(b["max_rel_err_vs_f64"] for b in bwd)),
                max_abs_err=max(r["max_abs_err"] for k, r in res.items() if k.endswith("f32")),
                max_abs_err_bf16=max(r["max_abs_err"] for k, r in res.items()
                                     if k.endswith("bf16")),
                ms=sum(s["kernel_ms"] for s in step), plain_ms=sum(s["plain_ms"] for s in step),
                bound_ms=sum(s["bound_ms"] for s in step), bound_by=step[1]["bound_by"],
                fma_bound_ms=sum(s["fma_bound_ms"] for s in step))


def k1_backward_macs(cfg) -> int:
    """Tensor-core multiply-adds a point of K1's backward: the recompute and
    the weight gradients each every W- and W/2-wide layer's products, the
    input gradients those of the view layer's feature columns, the feature
    layer and trunk layers D-1 .. 1 (the skip layer's h columns). The heads
    run on the CUDA cores and are left out."""
    D, W, E = cfg.D, cfg.W, 3 + 6 * cfg.num_freqs
    trunk = sum(W * (E if l == 0 else E + W if (l - 1) in cfg.skips else W) for l in range(D))
    layers = trunk + W * W + (W // 2) * (W + 3)
    return 2 * layers + (W // 2) * W + W * W + (D - 1) * W * W


def relu_near_zero(weights, cfg, pts, dirs, margin: float) -> torch.Tensor:
    """Points where the f64 network has a ReLU pre-activation within margin
    of 0, relative to its layer's largest |z| there."""
    w = [t.double() for t in weights]
    emb = positional_encoding(pts.double(), Embedder(input_dims=3, num_freqs=cfg.num_freqs,
                                                     max_freq_log2=float(cfg.num_freqs - 1)))
    near = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)

    def check(z):
        near.logical_or_((z.abs() <= margin * z.abs().amax(1, keepdim=True)).any(1))
        return torch.relu(z)

    h = emb
    for i in range(cfg.D):
        x = torch.cat([emb, h], -1) if i > 0 and (i - 1) in cfg.skips else h
        h = check(torch.nn.functional.linear(x, w[2 * i], w[2 * i + 1]))
    feature = torch.nn.functional.linear(h, w[2 * cfg.D + 2], w[2 * cfg.D + 3])
    check(torch.nn.functional.linear(torch.cat([feature, dirs.double()], -1), w[2 * cfg.D + 4],
                                     w[2 * cfg.D + 5]))
    return near


def k1_backward(model, cfg, n: int, gen: torch.Generator) -> dict:
    """K1's backward kernels (fused_mlp_backward_cuda) at n points: two calls
    bit-equal, held to the plain f32 gradient (K1_BWD_PLAIN_TOL) and, away
    from ReLU decisions near 0, to the f64 one (K1_BWD_TOL), as a
    TF32-products control is not;
    device ms of each (one call a network, the weights' two packings
    included) and the bound: k1_backward_macs in 3xTF32 at the TF32 rate."""
    dev = torch.device("cuda")
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(dev)
    g = torch.randn(n, 4, generator=gen).to(dev)
    weights = [w.detach() for w in fused_mlp.flat_weights(model)]
    before = fused_mlp.fused_mlp_backward_cuda.launches
    got = fused_mlp.fused_mlp_backward_cuda(weights, cfg, pts, dirs, g)
    again = fused_mlp.fused_mlp_backward_cuda(weights, cfg, pts, dirs, g)
    counted = fused_mlp.fused_mlp_backward_cuda.launches - before == 2
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [w.clone().requires_grad_() for w in weights]

    def plain(g=g, dt=torch.float32):
        w = [t.detach().to(dt).requires_grad_() for t in leaves]
        return torch.autograd.grad(fused_mlp.fused_mlp_plain(w, cfg, pts.to(dt), dirs.to(dt)), w,
                                   g.to(dt))

    def rel(a, b, g):
        size = plain(g.abs(), torch.float64)
        return max(((x.double() - y.double()).abs().max() / z.abs().max()).item()
                   for x, y, z in zip(a, b, size))

    vs_plain = rel(got, plain(), g)
    near = relu_near_zero(weights, cfg, pts, dirs, K1_BWD_MARGIN)
    g0 = g.masked_fill(near[:, None], 0.0)
    exact = plain(g0, torch.float64)
    vs_f64 = rel(fused_mlp.fused_mlp_backward_cuda(weights, cfg, pts, dirs, g0), exact, g0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = rel(plain(g0), exact, g0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ok = (counted and bit_equal and vs_plain <= K1_BWD_PLAIN_TOL and vs_f64 <= K1_BWD_TOL
          and control > K1_BWD_TOL)
    del again, exact
    reps = max(2, 655_360 // n)
    ms = cuda_ms(lambda: fused_mlp.fused_mlp_backward_cuda(weights, cfg, pts, dirs, g), reps)
    plain_ms = cuda_ms(plain, reps)
    return dict(points=n, ok=ok, bit_equal=bit_equal, launches_counted=counted,
                max_rel_err_vs_plain=vs_plain, max_rel_err_vs_f64=vs_f64,
                tf32_control_vs_f64=control, points_zeroed=near.float().mean().item(),
                kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=3 * 2 * k1_backward_macs(cfg) * n / PEAK_TF32 * 1e3,
                bound_by="operations")


def k2_inputs(gen: torch.Generator, R: int, M: int, S: int = 128):
    """K2's operands as the renderer passes them: fresh ascending bins, the
    weights as a [:, 1:-1] view of a wider row, and the draws per ray, or at a
    render chunk's size one row broadcast with row stride 0 (a render's
    deterministic draws). Draws include 0, 1 and 1 - 1e-7. Also dyadic
    weights (see tests/test_torch_kernels.py::dyadic_weights), whose CDF
    every order of sums builds exactly."""
    dev = torch.device("cuda")
    bins = (0.5 + torch.cumsum(torch.rand(R, M, generator=gen) * 0.05 + 0.005, -1)).to(dev)
    w = torch.rand(R, M + 1, generator=gen).to(dev)[:, 1:-1]
    u = torch.rand(1 if R == RENDER_CHUNK else R, S, generator=gen)
    u[:, 0], u[:, 1], u[:, 2] = 0.0, 1.0, 1.0 - 1e-7
    u = u.to(dev).expand(R, S)
    k = torch.randint(1, 64, (R, M - 1), generator=gen)
    k[:, -1] += 2 ** int(k.sum(-1).max()).bit_length() - k.sum(-1)
    v = (k * 2.0**-12).float().to(dev)
    dyadic = v - 1e-5
    if not bool((dyadic + 1e-5 == v).all()):
        raise RuntimeError("k2: dyadic weights do not round-trip the 1e-5 floor")
    return bins, w, u, dyadic


def k2_peaked(gen: torch.Generator, R: int, M: int):
    """Weights as a trained NeRF's P_depth weights are: 98% of each ray's
    weight in 3 adjacent bins at a random place, the rest spread at random,
    as the renderer's [:, 1:-1] view."""
    n = M - 1
    at = torch.randint(0, n - 2, (R, 1), generator=gen)
    idx = torch.arange(n)
    heavy = (idx >= at) & (idx < at + 3)
    w = torch.where(heavy, torch.rand(R, n, generator=gen) * 0.5 + 0.5,
                    torch.rand(R, n, generator=gen))
    hw, lw = torch.where(heavy, w, 0), torch.where(heavy, 0, w)
    w = 0.98 * hw / hw.sum(-1, keepdim=True) + 0.02 * lw / lw.sum(-1, keepdim=True)
    return torch.nn.functional.pad(w, (1, 1)).to("cuda")[:, 1:-1]


def k2_opaque(gen: torch.Generator, R: int, M: int, width: int = 5):
    """Weights of rays through an opaque surface, as the renderer's [:, 1:-1]
    view: ``width`` adjacent bins at a random place hold a Dirichlet draw
    summing to 1.0 (even rows) or 0.999 (odd rows), every other bin 0. An
    empty bin's CDF gap, 1e-5 / sum(w'), lies within an ulp of the 1e-5
    guard (tests/test_torch_cuda.py::opaque)."""
    n = M - 1
    h = min(width, n)
    at = torch.randint(0, n - h + 1, (R, 1), generator=gen)
    idx = torch.arange(n)
    e = -torch.log1p(-torch.rand(R, n, generator=gen))  # Exp(1): a Dirichlet's parts
    e = torch.where((idx >= at) & (idx < at + h), e, 0)
    total = torch.where(torch.arange(R)[:, None] % 2 == 0, 1.0, 0.999)
    w = (e / e.sum(-1, keepdim=True) * total).float()
    return torch.nn.functional.pad(w, (1, 1)).to("cuda")[:, 1:-1]


def guard_shares(w, u) -> dict:
    """On opaque weights: the share of empty bins whose CDF gap is under
    1e-5 (the guard fires on a draw there), and of draws u that take it."""
    cdf = sampling._cdf_from_weights(w)
    M = cdf.shape[-1]
    k = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    denom = (torch.gather(cdf, -1, torch.clamp(k, max=M - 1))
             - torch.gather(cdf, -1, torch.clamp(k - 1, min=0)))
    return dict(empty_bins=(cdf.diff(dim=-1)[w == 0] < 1e-5).double().mean().item(),
                draws=(denom < 1e-5).double().mean().item())


def busiest_entry(w, u) -> float:
    """The mean over the rays of the most gradient terms (a draw's below
    and above, as the backward kernel sorts them) that land on one CDF
    entry: the longest serial sum of the ray's warp."""
    cdf = fused_sampling.cdf_kernel_order(w)
    M = cdf.shape[-1]
    k = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    ent = torch.cat([torch.clamp(k - 1, min=0), torch.clamp(k, max=M - 1)], -1)
    counts = torch.zeros(ent.shape[0], M, device=ent.device).scatter_add_(
        -1, ent, torch.ones_like(ent, dtype=torch.float32))
    return counts.amax(-1).mean().item()


def graph_us(fn, n: int = 50, reps: int = 5) -> float:
    """Device µs per call of ``fn``: ``n`` calls captured in one CUDA graph,
    replayed ``reps`` times between two events, so no host time is in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * n) * 1e3


def wall_us(fn, n: int = 200) -> float:
    """Host-clock µs per call of ``fn`` over ``n`` calls ended by a synchronize:
    the larger of the host's time per call and the device's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def device_ops(fn) -> list:
    """Names of the device operations (kernels, copies, fills) that one call
    of ``fn`` runs, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_k2(gen: torch.Generator) -> dict:
    """K2 through its launcher at every shape of the main path (a train
    step's 1,024 rays, a render chunk's 16,384 with broadcast draws, and
    65,536), at the fine resampling's M=63 and the P_depth draws' M=191,
    S=128: bit for bit the plain sample_pdf (the same CDF law) on random,
    dyadic and opaque weights, with the guard's shares on the opaque ones. Times: the kernel's device µs (CUDA graph; on opaque rows
    too), the wall µs of a call of fused_sample_pdf (host included) and of
    its launcher alone, and events around back-to-back calls (which read
    the host wherever it is the slower side); the plain sample_pdf; the
    bytes bound. Then the device operations one forward call runs."""
    S = 128
    shapes = {}
    ok = True
    for R in (1024, RENDER_CHUNK, 65536):
        for M in (63, 191):
            bins, w, u, dyadic = k2_inputs(gen, R, M, S)
            got = fused_sampling.sample_pdf_cuda(bins, w, u)
            plain = sampling.sample_pdf(bins, w, u)
            err = (got - plain).abs().max().item()
            exact = bool(torch.equal(got, plain))
            got_d = fused_sampling.sample_pdf_cuda(bins, dyadic, u)
            plain_d = sampling.sample_pdf(bins, dyadic, u)
            err_d = (got_d - plain_d).abs().max().item()
            exact_d = bool(torch.equal(got_d, plain_d))
            copies = bool(torch.equal(got, fused_sampling.sample_pdf_cuda(
                bins, w.contiguous(), u.contiguous())))
            opaque = k2_opaque(gen, R, M)
            bit_equal_o = bool(torch.equal(fused_sampling.sample_pdf_cuda(bins, opaque, u),
                                           sampling.sample_pdf(bins, opaque, u)))
            guard = guard_shares(opaque, u)
            finite = bool(torch.isfinite(got).all())
            del got, plain, got_d, plain_d
            shape_ok = exact and exact_d and copies and bit_equal_o and finite
            ok = ok and shape_ok
            device_us = graph_us(lambda: fused_sampling.sample_pdf_cuda(bins, w, u))
            device_us_o = graph_us(lambda: fused_sampling.sample_pdf_cuda(bins, opaque, u))
            del opaque
            call_us = wall_us(lambda: fused_sampling.fused_sample_pdf(bins, w, u))
            launcher_us = wall_us(lambda: fused_sampling.sample_pdf_cuda(bins, w, u))
            events_us = cuda_ms(lambda: fused_sampling.fused_sample_pdf(bins, w, u), 200) * 1e3
            plain_ms = cuda_ms(lambda: sampling.sample_pdf(bins, w, u), 50)
            u_rows = 1 if u.stride(0) == 0 else R
            nbytes = (R * (M + (M - 1) + S) + u_rows * S) * 4
            # per weight: +1e-5, two sums, a divide, the CDF's add; per draw:
            # ceil(log2(M + 1)) compares, then 6 operations
            ops = R * (M - 1) * 5 + R * S * (math.ceil(math.log2(M + 1)) + 6)
            shapes[f"R{R}_M{M}"] = dict(
                ok=shape_ok, u_row_stride=u.stride(0), max_abs_err=err, bit_equal=exact,
                max_abs_err_dyadic=err_d, bit_equal_dyadic=exact_d, strided_equals_copies=copies,
                bit_equal_opaque=bit_equal_o, guard_share_opaque=guard, device_us=device_us,
                device_us_opaque=device_us_o,
                wall_us=call_us, launcher_wall_us=launcher_us, events_us=events_us,
                plain_ms=plain_ms,
                bound_ms=max(nbytes / HBM_BYTES, ops / PEAK_F32) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES >= ops / PEAK_F32 else "operations")
            del bins, w, u, dyadic
    # the backward kernel at a train step's 1,024 rays: M=191 is the P_depth
    # draws', the one call with a gradient; M=63 for its other width
    bwd = {f"R1024_M{M}": k2_backward(gen, 1024, M, S) for M in (63, 191)}
    ok = ok and all(v["ok"] for v in bwd.values())
    # one forward call at a train step's 1,024 rays, from the views the
    # renderer passes (weights needing a gradient, as at the P_depth site)
    bins, _, u, _ = k2_inputs(gen, 1024, 191, S)
    w = torch.rand(1024, 192, generator=gen).to("cuda").requires_grad_(True)[:, 1:-1]
    ub = u[:1].expand(1024, S)
    ops_kernel = device_ops(lambda: fused_sampling.fused_sample_pdf(bins, w, ub))
    ops_plain = device_ops(lambda: sampling.sample_pdf(bins, w, ub))
    one_kernel = len(ops_kernel) == 1
    line("k2", S=S, tol=dict(backward_rtol=K2_BWD_TOL[0], backward_atol_of_max=K2_BWD_TOL[1],
                             backward_atol_of_max_opaque=K2_BWD_TOL[2]),
         device_ops_per_call=ops_kernel, plain_device_ops_per_call=len(ops_plain), **shapes,
         backward=bwd)
    if not ok:
        raise RuntimeError("k2: a kernel disagrees with its plain versions")
    if not one_kernel:
        raise RuntimeError(f"k2: one forward call ran {ops_kernel} on the device, not one kernel")
    step = [shapes["R1024_M63"], shapes["R1024_M191"]]  # one train step's two launches
    b = bwd["R1024_M191"]  # and its one backward launch
    return dict(max_abs_err=max(s["max_abs_err"] for s in shapes.values()),
                ms=sum(s["device_us"] for s in step) / 1e3,
                wall_ms=sum(s["wall_us"] for s in step) / 1e3,
                plain_ms=sum(s["plain_ms"] for s in step),
                bound_ms=sum(s["bound_ms"] for s in step), bound_by=step[1]["bound_by"],
                bwd=dict(max_abs_err=max(v["max_abs_err"] for v in bwd.values()),
                         rel_err_vs_autograd_dyadic=max(v["rel_err_vs_autograd_dyadic"]
                                                        for v in bwd.values()),
                         ms=b["device_us"] / 1e3, wall_ms=b["wall_us"] / 1e3,
                         ms_peaked=b["device_us_peaked"] / 1e3,
                         ms_opaque=b["device_us_opaque"] / 1e3,
                         plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"]))


def k2_backward(gen: torch.Generator, R: int, M: int, S: int) -> dict:
    """K2's backward kernel through its launcher at (R, M, S), weights as the
    renderer's [:, 1:-1] view, per-ray draws with 0 and 1, g ~ N(0, 1): bit
    for bit its torch transcription (sample_pdf_backward_kernel_order, all
    three gradients), two launches bit-equal, the weights' view equal to its
    copy; on dyadic weights (an exact CDF) against autograd through the
    plain sample_pdf within K2_BWD_TOL (rtol, and atol of the largest
    entry). Times: device µs (CUDA graph) and wall µs of the launcher asking
    for the weights' gradient alone, as the train step does; the plain
    backward (the forward recomputed, then autograd through it: the
    backward before this kernel); the bytes bound. Then on peaked weights
    (k2_peaked, the same bins, draws and g) and opaque ones (k2_opaque): bit
    for bit the transcription again, on opaque ones also against autograd
    through the plain sample_pdf on every draw (K2_BWD_TOL[2]), and the
    device and wall µs; for uniform and peaked weights the mean over the
    rays of the busiest entry's terms."""
    bins, w, u, dyadic = k2_inputs(gen, R, M, S)
    g = torch.randn(R, S, generator=gen).to("cuda")

    def rel_err(got, ref, atol):
        return max(((a - c).abs() / (K2_BWD_TOL[0] * c.abs() + atol
                                     * max(1.0, c.abs().max().item()))).max().item()
                   for a, c in zip(got, ref))

    got = fused_sampling.sample_pdf_backward_cuda(bins, w, u, g, need_bins=True, need_u=True)
    order = fused_sampling.sample_pdf_backward_kernel_order(bins, w, u, g)
    err = max((a - c).abs().max().item() for a, c in zip(got, order))
    exact = all(torch.equal(a, c) for a, c in zip(got, order))
    again = fused_sampling.sample_pdf_backward_cuda(bins, w, u, g, need_bins=True, need_u=True)
    twice = all(torch.equal(a, c) for a, c in zip(got, again))
    copies = torch.equal(got[1], fused_sampling.sample_pdf_backward_cuda(
        bins, w.contiguous(), u, g)[1])
    got_d = fused_sampling.sample_pdf_backward_cuda(bins, dyadic, u, g, need_bins=True,
                                                    need_u=True)
    leaves = [t.clone().requires_grad_(True) for t in (bins, dyadic, u)]
    rel = rel_err(got_d, torch.autograd.grad(sampling.sample_pdf(*leaves), leaves, g),
                  K2_BWD_TOL[1])
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    del got, order, again, got_d, leaves
    peaked, opaque = k2_peaked(gen, R, M), k2_opaque(gen, R, M)
    got_p, got_o = (fused_sampling.sample_pdf_backward_cuda(bins, x, u, g, need_bins=True,
                                                            need_u=True) for x in (peaked, opaque))
    exact_p, exact_o = (all(torch.equal(a, c) for a, c in zip(
        got_x, fused_sampling.sample_pdf_backward_kernel_order(bins, x, u, g)))
        for got_x, x in ((got_p, peaked), (got_o, opaque)))
    finite = finite and all(bool(torch.isfinite(a).all()) for a in (*got_p, *got_o))
    leaves = [t.clone().requires_grad_(True) for t in (bins, opaque, u)]
    rel_o = rel_err(got_o, torch.autograd.grad(sampling.sample_pdf(*leaves), leaves, g),
                    K2_BWD_TOL[2])
    del got_p, got_o, leaves
    wl = w.detach().requires_grad_(True)
    device_us = graph_us(lambda: fused_sampling.sample_pdf_backward_cuda(bins, w, u, g))
    call_us = wall_us(lambda: fused_sampling.sample_pdf_backward_cuda(bins, w, u, g))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(sampling.sample_pdf(bins, wl, u), wl, g), 50)
    nbytes = R * (M + (M - 1) + 2 * S + (M - 1)) * 4
    # per weight: the CDF build's 5 and the reverse scan's 5; per draw:
    # ceil(log2(M + 1)) compares, then 14 operations and 4 adds into the bins
    ops = R * (M - 1) * 10 + R * S * (math.ceil(math.log2(M + 1)) + 18)
    return dict(ok=exact and twice and copies and rel <= 1.0 and finite and exact_p
                and exact_o and rel_o <= 1.0,
                max_abs_err=err, bit_equal_kernel_order=exact, two_launches_equal=twice,
                strided_equals_copy=copies, rel_err_vs_autograd_dyadic=rel,
                bit_equal_kernel_order_peaked=exact_p, bit_equal_kernel_order_opaque=exact_o,
                rel_err_vs_autograd_opaque=rel_o, guard_share_opaque=guard_shares(opaque, u),
                device_us=device_us,
                device_us_peaked=graph_us(
                    lambda: fused_sampling.sample_pdf_backward_cuda(bins, peaked, u, g)),
                device_us_opaque=graph_us(
                    lambda: fused_sampling.sample_pdf_backward_cuda(bins, opaque, u, g)),
                wall_us=call_us,
                wall_us_peaked=wall_us(
                    lambda: fused_sampling.sample_pdf_backward_cuda(bins, peaked, u, g)),
                busiest_entry_terms=busiest_entry(w, u),
                busiest_entry_terms_peaked=busiest_entry(peaked, u), plain_ms=plain_ms,
                device_ops_per_call=device_ops(
                    lambda: fused_sampling.sample_pdf_backward_cuda(bins, w, u, g)),
                bound_ms=max(nbytes / HBM_BYTES, ops / PEAK_F32) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES >= ops / PEAK_F32 else "operations")


def look_at(eye: np.ndarray) -> np.ndarray:
    """c2w of a camera at ``eye`` looking at the origin, y up, looking down -z."""
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, eye
    return c2w.astype(np.float32)


def make_scene(seed: int) -> SceneTensors:
    """A scene shaped like a SCADE ScanNet scene: 20 posed 468x624 views in a
    ring around a room-sized box, K=20 depth hypotheses per train view."""
    rng = np.random.default_rng(seed)
    n = N_TRAIN + N_VAL
    angles = np.linspace(0.0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 0.1, n)
    poses = np.stack([look_at(np.array([2.5 * np.cos(a), 0.4, 2.5 * np.sin(a)])) for a in angles])
    intr = np.tile(np.array([[577.9, 577.9, 312.0, 234.0]], np.float32), (n, 1))
    dev = torch.device("cuda")
    return SceneTensors(
        images=torch.from_numpy(rng.uniform(size=(n, H, W, 3)).astype(np.float32)).to(dev),
        poses=torch.from_numpy(poses).to(dev),
        intrinsics=torch.from_numpy(intr).to(dev),
        hyps=torch.from_numpy(
            rng.uniform(0.5, 5.5, size=(N_TRAIN, K_HYP, H, W, 1)).astype(np.float32)).to(dev),
        near=torch.tensor(0.1, device=dev),
        far=torch.tensor(6.0, device=dev),
        bb_center=torch.zeros(3, device=dev),
        bb_scale=torch.tensor(1.0 / 3.0, device=dev),
    )


def reset_counts() -> None:
    fused_mlp.fused_mlp_cuda.launches = 0
    fused_mlp.fused_mlp_backward_cuda.launches = 0
    fused_sampling.sample_pdf_cuda.launches = 0
    fused_sampling.sample_pdf_backward_cuda.launches = 0


def counts() -> dict:
    return {"k1": fused_mlp.fused_mlp_cuda.launches,
            "k2": fused_sampling.sample_pdf_cuda.launches,
            "k2_bwd": fused_sampling.sample_pdf_backward_cuda.launches}


def per_step(k1: int = 2) -> dict:
    """A train step's launches: K1 twice (0 on the plain MLP), K2 at the
    importance and P_depth draws, K2's backward once (only the P_depth
    draws carry a gradient)."""
    return {"k1": k1, "k2": 2, "k2_bwd": 1}


def per_view(chunks: int) -> dict:
    """A rendered view's launches: K1 and K2 twice a chunk, no backward."""
    return {"k1": 2 * chunks, "k2": 2 * chunks, "k2_bwd": 0}


def phase_train(seed: int, steps: int):
    scene = make_scene(seed)
    rc = make_render_config()  # reference defaults, kernels on, f32, cuda
    tc = TrainConfig()
    state = create_train_state(seed, rc, tc, n_images=N_TRAIN + N_VAL)
    step_fn = make_train_step(rc, tc, H, W, N_TRAIN)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the k1 phase's plain version peaks far higher
    reset_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step_fn(state, scene, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = counts()
    finite = all(math.isfinite(x) for x in losses)
    # K1's backward kernels run once a network a step
    per_step_ok = (launches == {k: n * steps for k, n in per_step().items()}
                   and fused_mlp.fused_mlp_backward_cuda.launches == 2 * steps)
    launches["k1_bwd"] = fused_mlp.fused_mlp_backward_cuda.launches
    tail = times[-10:]
    line("train", steps=steps, n_rand=tc.n_rand, loss_first=losses[0], loss_last=losses[-1],
         finite=finite, ms_per_step_median_last10=statistics.median(tail),
         ms_per_step_last10=tail, first_step_ms=times[0], launches=launches,
         launches_per_step_ok=per_step_ok,
         hyps_gb=scene.hyps.numel() * 4 / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (finite and per_step_ok):
        raise RuntimeError("train: non-finite loss or wrong kernel launch count")
    return state, scene, rc, tc, launches, statistics.median(tail)


def phase_split(state, scene, rc, tc, seed: int, steps: int = 5) -> None:
    """Where a train step's time goes: the batch gather and forward pass
    (both K1 and both K2 launches), the backward pass (through the plain
    versions) and the two Adams, each ended by a synchronize. Then the whole
    step with both kernels off, so that their plain versions run instead."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    parts = {"forward": [], "backward": [], "adam": []}
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = sample_ray_batch(gen, scene, H, W, N_TRAIN, tc)
        loss, metrics = compute_loss(state, scene, batch, rc, tc, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, state.nerf_params() + [state.scales, state.shifts],
                                    allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        apply_grads(state, list(grads[:-2]), grads[-2], grads[-1], tc, N_TRAIN, metrics)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in (("forward", t1 - t0), ("backward", t2 - t1), ("adam", t3 - t2)):
            parts[name].append(dt * 1e3)
    plain_fn = make_train_step(make_render_config(use_fused=False, fused_sampling=False),
                               tc, H, W, N_TRAIN)
    plain = []
    for _ in range(steps + 1):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = plain_fn(state, scene, gen)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    medians = {f"{k}_ms_median": statistics.median(v) for k, v in parts.items()}
    line("split", steps=steps, **medians, plain_step_ms_median=statistics.median(plain[1:]),
         plain_loss=float(metrics["loss"]))
    if not math.isfinite(float(metrics["loss"])):
        raise RuntimeError("split: non-finite loss on the plain path")


def repro_step(state, scene, rc, tc, seed: int):
    """One train step, as make_train_step runs it, on a copy of ``state``
    with a generator from ``seed``: the grads as applied, the parameters
    after, the loss."""
    st = copy.deepcopy(state)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = sample_ray_batch(gen, scene, H, W, N_TRAIN, tc)
    grads, g_scales, g_shifts, metrics = train_step.compute_grads(st, scene, batch, rc, tc,
                                                                  generator=gen)
    applied = [None if g is None else g.detach().clone() for g in (*grads, g_scales, g_shifts)]
    apply_grads(st, grads, g_scales, g_shifts, tc, N_TRAIN, metrics)
    params = [p.detach().clone() for p in st.nerf_params() + [st.scales, st.shifts]]
    return applied, params, float(metrics["loss"])


def phase_repro(state, scene, tc, seed: int) -> None:
    """Is the train step reproducible on the card? In f32 and bf16, one step
    twice from the train phase's state with generators of one seed: every
    gradient as applied and every updated parameter compared with
    torch.equal, the differing tensors named. Then the step under
    torch.use_deterministic_algorithms(True, warn_only=True): the ops it
    warns about (ops with no deterministic form) and its ms against the
    step's without it (5 steps each, after one)."""
    names = [f"{w}.{n}" for w, m in (("coarse", state.model_coarse), ("fine", state.model_fine))
             for n, _ in m.named_parameters()] + ["scales", "shifts"]
    res = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rc = make_render_config(compute_dtype=dt)
        (ga, pa, la), (gb, pb, lb) = (repro_step(state, scene, rc, tc, seed) for _ in range(2))
        res[name] = dict(
            loss_equal=la == lb,
            grads_differ=[n for n, x, y in zip(names, ga, gb)
                          if not (x is None and y is None) and not torch.equal(x, y)],
            params_differ=[n for n, x, y in zip(names, pa, pb) if not torch.equal(x, y)])
    rc = make_render_config()
    step_fn = make_train_step(rc, tc, H, W, N_TRAIN)
    st = copy.deepcopy(state)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ms = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for mode in (False, True, False, True):
            torch.use_deterministic_algorithms(mode, warn_only=True)
            try:
                times = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step_fn(st, scene, gen)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            finally:
                torch.use_deterministic_algorithms(False)
            ms.setdefault("switch_on" if mode else "switch_off", []).extend(times[1:])
    warned = sorted({str(w.message)[:160] for w in caught if "determinis" in str(w.message)})
    ok = all(r["loss_equal"] and not r["grads_differ"] and not r["params_differ"]
             for r in res.values())
    line("repro", **res, deterministic_algorithms_warnings=warned,
         ms_per_step_median={k: statistics.median(v) for k, v in ms.items()}, ok=ok)
    if not ok:
        raise RuntimeError(f"repro: one step from one state and seed differs between runs: {res}")


def phase_check(state, scene, rc) -> None:
    """render_rays with both kernels against the plain path on the same rays."""
    i_val = N_TRAIN
    c2w, intr = scene.poses[i_val], scene.intrinsics[i_val]
    rays_o, rays_d = get_rays(H, W, intr, c2w)
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(0))[:512].to("cuda")
    ro, rd = rays_o.reshape(-1, 3)[idx], rays_d.reshape(-1, 3)[idx]
    sv = SceneVars(state.model_coarse, state.model_fine, scene.bb_center, scene.bb_scale,
                   torch.zeros(0, device="cuda"))
    plain = make_render_config(use_fused=False, fused_sampling=False).test_mode()
    with torch.no_grad():
        a = render_rays(sv, rc.test_mode(), ro, rd, scene.near, scene.far)
        b = render_rays(sv, plain, ro, rd, scene.near, scene.far)
    errs = {k: (a[k] - b[k]).abs().max().item() for k in CHECK_TOL}
    ok = all(errs[k] <= CHECK_TOL[k] for k in CHECK_TOL)
    line("check", rays=512, max_abs_err=errs, tol=CHECK_TOL, ok=ok)
    if not ok:
        raise RuntimeError("check: kernel path disagrees with the plain path")


def phase_render(state, scene) -> dict:
    i_val = N_TRAIN
    sv = SceneVars(state.model_coarse, state.model_fine, scene.bb_center, scene.bb_scale,
                   torch.zeros(0, device="cuda"))
    res = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rc = make_render_config(compute_dtype=dt)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = render_image(sv, rc, H, W, scene.intrinsics[i_val], scene.poses[i_val],
                           float(scene.near), float(scene.far), chunk=RENDER_CHUNK,
                           outputs=("rgb_map", "depth_map", "acc_map"))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        chunks = -(-H * W // RENDER_CHUNK)
        ok = (tuple(out["rgb_map"].shape) == (H, W, 3) and tuple(out["depth_map"].shape) == (H, W)
              and all(bool(torch.isfinite(v).all()) for v in out.values())
              and counts() == per_view(chunks))
        res[name] = dict(seconds=sec, rays_per_s=H * W / sec, ok=ok, chunks=chunks,
                         launches=counts(), rgb_mean=out["rgb_map"].mean().item(),
                         depth_mean=out["depth_map"].mean().item())
        if not ok:
            raise RuntimeError(f"render {name}: wrong shape, non-finite output or launch count")
    line("render", H=H, W=W, **res)
    return res


def write_scene(root: str, seed: int) -> dict:
    """A ScanNet-shaped scene in the reference's on-disk format under
    ``root/scene``: 18 train + 2 val + 2 test views at 468x624 (RGB and 16-bit
    depth and target_depth PNGs, written by the port's own PNG encoder whether
    or not cv2 exists, so the load reads the codec's files back, through cv2
    where it is installed), K=20 ``leres_cimle/dump/<img>_<k>.npy``
    hypotheses per train view, 6 video poses and a ``transforms_<split>.json``
    per split."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "scene")
    for sub in ("train/rgb", "train/depth", "train/target_depth", "train/leres_cimle/dump"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    near, far, dsf = 0.1, 6.0, 1000.0
    splits = {"train": N_TRAIN, "val": N_VAL, "test": N_TEST}
    n = sum(splits.values())
    angles = np.linspace(0.0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 0.1, n)
    # the video trajectory: poses only (no image files), between the views
    video = [{"file_path": "", "depth_file_path": "", "fx": 577.9, "fy": 577.9, "cx": 312.0,
              "cy": 234.0, "transform_matrix": look_at(np.array(
                  [2.5 * np.cos(a), 0.4, 2.5 * np.sin(a)])).tolist()}
             for a in np.linspace(0.0, 2 * np.pi, N_VIDEO, endpoint=False) + np.pi / n]
    with open(os.path.join(base, "transforms_video.json"), "w") as fp:
        json.dump({"frames": video}, fp)
    k = 0
    for split, count in splits.items():
        frames = []
        for _ in range(count):
            pose = look_at(np.array([2.5 * np.cos(angles[k]), 0.4, 2.5 * np.sin(angles[k])]))
            rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            depth_mm = rng.integers(500, 5500, (H, W), dtype=np.uint16)
            depth_mm[:8] = 0  # invalid depth, as a sensor leaves it
            image_io.png_encode(os.path.join(base, f"train/rgb/{k}.png"), rgb)
            image_io.png_encode(os.path.join(base, f"train/depth/{k}.png"), depth_mm)
            image_io.png_encode(os.path.join(base, f"train/target_depth/{k}.png"), depth_mm)
            if split == "train":
                for j in range(K_HYP):
                    np.save(os.path.join(base, f"train/leres_cimle/dump/{k}_{j}.npy"),
                            rng.uniform(0.5, 5.5, (H, W)).astype(np.float32))
            frames.append({"file_path": f"train/rgb/{k}.png",
                           "depth_file_path": f"train/depth/{k}.png",
                           "transform_matrix": pose.tolist(),
                           "fx": 577.9, "fy": 577.9, "cx": 312.0, "cy": 234.0})
            k += 1
        meta = {"frames": frames}
        if split == "train":
            meta.update(near=near, far=far, depth_scaling_factor=dsf)
        with open(os.path.join(base, f"transforms_{split}.json"), "w") as fp:
            json.dump(meta, fp)
    return {"views": n, "video_poses": N_VIDEO, "hyps_gb": N_TRAIN * K_HYP * H * W * 4 / 1e9}


class CliProbe:
    """Watches the CLI's run without changing it: the kernel launches and a
    CUDA event after every train step (no synchronize), each step's loss
    tensor and TrainConfig, the launches and wall time of every rendered
    view (a video frame's render ends in copies to the host), the wall time
    of the eval path's renders (which end in copies to the host), of each
    camera-latent fit (ends in a copy to the host) and of the scene load,
    and how the hypotheses were read. With ``first_grads`` it also keeps a
    host copy of the first train step's gradients, as the step applies them
    (under ranks: summed over the ranks)."""

    def __init__(self, first_grads: bool = False):
        self.step_launches, self.view_launches, self.view_s = [], [], []
        self.events, self.host_ms, self.losses, self.configs = [], [], [], []
        self.eval_s, self.eval_views, self.load_s, self.hyp_load = 0.0, 0, [], []
        self.fit_s, self.first_grads = [], None
        self._patches = [
            mock.patch.object(loop, "make_train_step", self._wrap_make_train_step(
                loop.make_train_step)),
            mock.patch.object(evaluate, "render_image", self._wrap_render_image(
                evaluate.render_image)),
            mock.patch.object(loop, "render_images_with_metrics", self._wrap_eval(
                loop.render_images_with_metrics)),
            mock.patch.object(evaluate, "render_images_with_metrics", self._wrap_eval(
                evaluate.render_images_with_metrics)),
            mock.patch.object(scene_io, "load_scene_scannet", self._wrap_load(
                scene_io.load_scene_scannet)),
            mock.patch.object(scene_io, "load_scene_processed", self._wrap_load(
                scene_io.load_scene_processed)),
            mock.patch.object(evaluate, "optimize_camera_embedding", self._wrap_fit(
                evaluate.optimize_camera_embedding)),
        ]
        if first_grads:
            self._patches.append(mock.patch.object(train_step, "apply_grads", self._wrap_apply(
                train_step.apply_grads)))

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()

    def _wrap_make_train_step(self, make):
        def made(*args, **kwargs):
            step_fn = make(*args, **kwargs)
            self.configs.append(args[1])  # the TrainConfig

            def step(*a, **kw):
                before, t0 = counts(), time.perf_counter()
                metrics = step_fn(*a, **kw)
                self.host_ms.append((time.perf_counter() - t0) * 1e3)
                after = counts()
                self.step_launches.append({k: after[k] - before[k] for k in after})
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append(event)
                self.losses.append(metrics["loss"])
                return metrics

            return step
        return made

    def _wrap_apply(self, apply):
        def wrapped(state, grads, g_scales, g_shifts, *args, **kwargs):
            if self.first_grads is None:
                wrt = state.nerf_params() + [state.scales, state.shifts]
                self.first_grads = torch.cat([
                    (torch.zeros_like(p) if g is None else g.detach()).flatten().cpu()
                    for g, p in zip((*grads, g_scales, g_shifts), wrt)])
            return apply(state, grads, g_scales, g_shifts, *args, **kwargs)
        return wrapped

    def _wrap_render_image(self, render):
        def wrapped(*args, **kwargs):
            before, t0 = counts(), time.perf_counter()
            out = render(*args, **kwargs)
            torch.cuda.synchronize()
            self.view_s.append(time.perf_counter() - t0)
            after = counts()
            self.view_launches.append({k: after[k] - before[k] for k in after})
            return out
        return wrapped

    def _wrap_eval(self, fn):
        def wrapped(count, indices, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(count, indices, *args, **kwargs)
            self.eval_s += time.perf_counter() - t0
            self.eval_views += len(indices) if count is None else count
            return out
        return wrapped

    def _wrap_load(self, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.load_s.append(time.perf_counter() - t0)
            self.hyp_load.append(out.hypothesis_load)
            return out
        return wrapped

    def _wrap_fit(self, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.fit_s.append(time.perf_counter() - t0)
            return out
        return wrapped

    def step_ms(self) -> list:
        """Device-side ms of each step after the first: between the events
        recorded after consecutive steps, so host stalls between steps count."""
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def read_metrics(path: str) -> dict:
    with open(path) as f:
        return {k: float(v) for k, v in (line.split(": ") for line in f.read().splitlines())}


def cli_common(tmp: str, seed: int, expname: str = "cli") -> list:
    return ["--data_dir", tmp, "--scene_id", "scene", "--ckpt_dir", "ckpt", "--expname", expname,
            "--cimle_dir", "dump", "--num_hypothesis", str(K_HYP), "--seed", str(seed)]


def metrics_agree(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        (math.isnan(x) and math.isnan(y)) or math.isclose(x, y, rel_tol=METRICS_REL, abs_tol=0.0)
        for x, y in zip(a.values(), b.values()))


def phase_cli(tmp: str, seed: int, train_median_ms: float):
    """The port's CLI as a user runs it: ``train`` for 20 steps at the
    reference defaults (64+128 samples, 8x256, N_rand 1024, f32, kernels on)
    on a ScanNet-shaped scene read from disk, a .tar at steps 10 and 20, the
    i_img renders at 20 (2 train + 2 val views) and the final test render (2
    views), then ``test`` from the newest .tar, then the same train run
    resumed (10 steps, then 10 more from its .tar). Everything goes to ``tmp``
    (the TB root is relative to the working directory, so the phase runs
    there), which the later phases reuse. Fails unless K1 and K2 launch 2
    per step (K2's backward 1) and 36 per view (K2's backward 0), the losses
    are finite, the .tar reloads to the trained parameters and Adam state
    exactly, the resumed run's 000020.tar equals the straight run's leaf by
    leaf (``repro_bit_equal``), both metrics.txt agree, i_img
    wrote its TB/JSONL entries, and the hypotheses were read through the
    native library and then from the blob it wrote. Returns the train run's
    launches and the test metrics."""
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        t0 = time.perf_counter()
        scene = write_scene(tmp, seed)
        write_s = time.perf_counter() - t0
        os.chdir(tmp)
        common = cli_common(tmp, seed)
        with CliProbe() as train, contextlib.redirect_stdout(log):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            state = cli.main("scannet", ["train", *common, "--num_iterations", "20",
                                         "--i_weights", "10", "--i_print", "10",
                                         "--i_img", "20"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launches = counts()
        result_dir = os.path.join("ckpt", "cli", "test_images_scene")
        train_metrics = read_metrics(os.path.join(result_dir, "metrics.txt"))
        with CliProbe() as test, contextlib.redirect_stdout(log):
            reset_counts()
            t0 = time.perf_counter()
            cli.main("scannet", ["test", *common])
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            test_launches = counts()
        test_metrics = read_metrics(os.path.join(result_dir, "metrics.txt"))
        # the same run resumed: 10 steps, then 10 more from its 000010.tar
        t0 = time.perf_counter()
        with CliProbe() as resumed, contextlib.redirect_stdout(log):
            for n in (10, 20):
                cli.main("scannet", ["train", *cli_common(tmp, seed, "cli_resumed"),
                                     "--num_iterations", str(n), "--i_weights", "10",
                                     "--i_print", "10", "--i_img", "1000000"])
            torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        repro = tars_equal(os.path.join("ckpt", "cli", "000020.tar"),
                           os.path.join("ckpt", "cli_resumed", "000020.tar"))
        resumed_ok = len(resumed.step_launches) == 20 and all(
            d == per_step() for d in resumed.step_launches)

        chunks = -(-H * W // RENDER_CHUNK)
        view = per_view(chunks)
        steps_ok = len(train.step_launches) == 20 and all(
            d == per_step() for d in train.step_launches)
        views_ok = (len(train.view_launches) == 6 and len(test.view_launches) == 2
                    and all(d == view for d in train.view_launches + test.view_launches)
                    and train_launches == {k: 20 * per_step()[k] + 6 * view[k] for k in view}
                    and test_launches == {k: 2 * view[k] for k in view})
        losses = [float(x) for x in train.losses]
        finite = all(math.isfinite(x) for x in losses)

        raw = ckpt.load_checkpoint_raw(os.path.join("ckpt", "cli", "000020.tar"))
        extra = raw["scade_tpu_torch"]
        tar_ok = (raw["global_step"] == state.step == 20
                  and extra["opt"]["count"] == state.opt.count == 20
                  and extra["ss_opt"]["count"] == state.ss_opt.count == 20)
        for model, key in ((state.model_coarse, "network_fn_state_dict"),
                           (state.model_fine, "network_fine_state_dict")):
            for name, t in model.state_dict().items():
                tar_ok = tar_ok and torch.equal(t.cpu(), raw[key]["module." + name])
        for key, opt in (("opt", state.opt), ("ss_opt", state.ss_opt)):
            for saved, live in ((extra[key]["mu"], opt.mu), (extra[key]["nu"], opt.nu)):
                tar_ok = tar_ok and len(saved) == len(live) and all(
                    torch.equal(a, b.cpu()) for a, b in zip(saved.values(), live))
        tar_ok = tar_ok and torch.equal(raw["depth_scales"], state.scales.detach().cpu())

        keys_ok = list(train_metrics) == list(test_metrics) == [
            "img_loss", "psnr", "ssim", "lpips", "img_loss0", "psnr0", "depth_rmse"]
        agree = keys_ok and metrics_agree(train_metrics, test_metrics)
        hyp_load = dict(train=train.hyp_load[0], test=test.hyp_load[0])
        native = hyp_load == dict(train="npy:native", test="blob:native")
        finite_metrics = all(math.isfinite(test_metrics[k]) for k in ("psnr", "ssim",
                                                                      "depth_rmse"))
        with open(os.path.join("runs", "cli", "scalars.jsonl")) as f:
            logged = [json.loads(x) for x in f.read().splitlines()]
        tags20 = {(x["tag"], tuple(x.get("values", {}))) for x in logged if x["step"] == 20}
        tb_ok = all(t in tags20 for t in (("psnr", ("val",)), ("mse", ("val",)), ("ssim", ()),
                                          ("lpips", ()), ("depth_rmse", ()),
                                          ("psnr", ("train",))))
        files = sorted(os.listdir(result_dir))

        step_ms = train.step_ms()  # step_ms[i - 2] ends at step i
        last10 = step_ms[-10:]
        line("cli", views=scene["views"], H=H, W=W, K=K_HYP, hyps_gb=scene["hyps_gb"],
             scene_write_s=write_s, scene_load_s=train.load_s[0], test_scene_load_s=test.load_s[0],
             train_command_s=train_s, test_command_s=test_s,
             loop_ms_per_step_median_11_20=statistics.median(last10),
             loop_ms_per_step_mean_11_20=statistics.mean(last10), loop_ms_per_step_11_20=last10,
             loop_host_ms_per_step_median_11_20=statistics.median(train.host_ms[10:]),
             train_phase_ms_per_step_median=train_median_ms,
             s_per_view_train_eval=train.eval_s / train.eval_views,
             s_per_view_test=test.eval_s / test.eval_views,
             eval_views=dict(train=train.eval_views, test=test.eval_views),
             launches=dict(train=train_launches, test=test_launches,
                           per_step=train.step_launches[0], per_view=train.view_launches[0]),
             launches_per_step_ok=steps_ok, launches_per_view_ok=views_ok,
             loss_first=losses[0], loss_last=losses[-1], finite=finite, tar_bit_equal=tar_ok,
             repro_bit_equal=repro, resumed_command_s=resume_s,
             resumed_losses_equal=[float(x) for x in resumed.losses] == losses,
             metrics_train=train_metrics, metrics_test=test_metrics, metrics_agree=agree,
             metrics_finite=finite_metrics, tb_entries_ok=tb_ok, result_files=files,
             cv2_installed=image_io.jpeg_available(), hypothesis_load=hyp_load,
             hypothesis_load_native=native)
        bad = [name for name, ok in (("launches per step", steps_ok),
                                     ("launches per view", views_ok), ("finite losses", finite),
                                     (".tar reload", tar_ok), ("metrics.txt agree", agree),
                                     ("resumed run's .tar equals the straight run's", repro),
                                     ("resumed run's launches per step", resumed_ok),
                                     ("finite metrics", finite_metrics),
                                     ("i_img TB entries", tb_ok),
                                     ("native hypothesis load, then its blob", native)) if not ok]
        if bad:
            raise RuntimeError(f"cli: failed {bad}")
        return train_launches, test_metrics
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise
    finally:
        os.chdir(cwd)


def video_frames(path: str) -> int:
    """Frames that cv2 decodes from a video file."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def phase_tasks(tmp: str, seed: int, test_metrics: dict) -> dict:
    """The tasks test_opt and video, on the cli phase's scene and run
    (``ckpt/cli/000020.tar``), at the reference defaults: ``test_opt`` (no
    camera latent, so it renders as ``test`` does: its metrics.txt must
    equal the cli phase's ``test`` within METRICS_REL); ``video`` (every 3rd
    of the 6 video poses: 2 frames of 468x276, 8 chunks, so 16 K1 and 16 K2
    launches a frame, and a file that decodes to 2 frames); then ``train
    --input_ch_cam 4`` for 5 steps (K1 does not serve a network with a
    camera latent, as in the JAX package: 0 K1 and 2 K2 a step) and its
    ``test_opt``, which fits a latent per test view (100 Adam steps on 2,048
    pixels each) and writes 2 finite latent files."""
    cwd = os.getcwd()
    log = io.StringIO()
    chunks_per_frame = -(-H * (int(H / 9.0 * 16.0 / 3.0) // 2 * 2) // RENDER_CHUNK)
    try:
        os.chdir(tmp)
        common = cli_common(tmp, seed)
        with CliProbe() as opt, contextlib.redirect_stdout(log):
            reset_counts()
            t0 = time.perf_counter()
            cli.main("scannet", ["test_opt", *common])
            torch.cuda.synchronize()
            opt_s = time.perf_counter() - t0
            opt_launches = counts()
        opt_metrics = read_metrics(os.path.join(
            "ckpt", "cli", "test_images_with_optimization_scene", "metrics.txt"))

        with CliProbe() as vid, contextlib.redirect_stdout(log):
            reset_counts()
            t0 = time.perf_counter()
            video_file = cli.main("scannet", ["video", *common])
            torch.cuda.synchronize()
            video_s = time.perf_counter() - t0
            video_launches = counts()
        frames = sorted(os.listdir(os.path.join("ckpt", "cli", "video_0")))
        decoded = video_frames(video_file)

        cam = cli_common(tmp, seed, "cam") + ["--input_ch_cam", "4"]
        with CliProbe() as cam_train, contextlib.redirect_stdout(log):
            reset_counts()
            cli.main("scannet", ["train", *cam, "--num_iterations", "5", "--i_weights", "5",
                                 "--i_img", "1000000", "--i_print", "1000000"])
            torch.cuda.synchronize()
            cam_train_launches = counts()
        with CliProbe() as cam_opt, contextlib.redirect_stdout(log):
            reset_counts()
            t0 = time.perf_counter()
            cli.main("scannet", ["test_opt", *cam])
            torch.cuda.synchronize()
            cam_opt_s = time.perf_counter() - t0
            cam_opt_launches = counts()
        latent_dir = os.path.join("ckpt", "cam", "test_latent_codes_scene")
        latents = {n: np.loadtxt(os.path.join(latent_dir, n)) for n in sorted(os.listdir(latent_dir))}

        view = per_view(-(-H * W // RENDER_CHUNK))
        per_frame = per_view(chunks_per_frame)
        checks = {
            "test_opt metrics equal test's": metrics_agree(opt_metrics, test_metrics),
            "test_opt launches": opt_launches == {k: N_TEST * v for k, v in view.items()},
            "video frames": frames == ["0.jpg", "3.jpg"] and decoded == 2,
            "video launches per frame": (len(vid.view_launches) == 2 and all(
                d == per_frame for d in vid.view_launches) and video_launches["k1"] > 0),
            "latent train launches per step": len(cam_train.step_launches) == 5 and all(
                d == per_step(k1=0) for d in cam_train.step_launches),
            "latent train finite loss": all(math.isfinite(float(v)) for v in cam_train.losses),
            "latent files": list(latents) == ["0.txt", "1.txt"] and all(
                v.shape == (4,) and np.isfinite(v).all() for v in latents.values()),
            "latent test_opt launches": cam_opt_launches["k1"] == 0 and cam_opt_launches["k2"] > 0,
        }
        line("tasks", test_opt=dict(command_s=opt_s, s_per_view=opt.eval_s / opt.eval_views,
                                    launches=opt_launches, metrics=opt_metrics),
             video=dict(command_s=video_s, frames=len(frames), decoded_frames=decoded,
                        file=os.path.basename(video_file), H=H,
                        W=int(H / 9.0 * 16.0 / 3.0) // 2 * 2, chunks_per_frame=chunks_per_frame,
                        s_per_frame=vid.view_s, launches_per_frame=vid.view_launches,
                        launches=video_launches, ffmpeg=shutil.which("ffmpeg") is not None),
             latent=dict(input_ch_cam=4, train_steps=5,
                         train_launches_per_step=cam_train.step_launches[0],
                         train_launches=cam_train_launches,
                         train_loss_last=float(cam_train.losses[-1]),
                         test_opt_command_s=cam_opt_s, fit_s_per_image=cam_opt.fit_s,
                         render_s_per_view=cam_opt.eval_s / cam_opt.eval_views,
                         test_opt_launches=cam_opt_launches,
                         latents={k: v.tolist() for k, v in latents.items()}),
             checks=checks)
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"tasks: failed {bad}")
        return checks
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise
    finally:
        os.chdir(cwd)


def phase_wild(tmp: str, seed: int) -> dict:
    """The wild runner as a user runs it (``python -m scade_tpu_torch.wild``,
    through its main): the cli phase's 468x624, K=20 scene read as a
    processed scene (no GT depth), ``train --mask_edges true`` for 10 steps
    (the RGB loss masked by the edge mask, scalars under
    ``runs_prior_corrected/``), then ``test``."""
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        os.chdir(tmp)
        common = cli_common(tmp, seed, "wild")
        with CliProbe() as train, contextlib.redirect_stdout(log):
            reset_counts()
            t0 = time.perf_counter()
            wild.main_wild(["train", *common, "--mask_edges", "true", "--num_iterations", "10",
                            "--i_weights", "10", "--i_print", "5", "--i_img", "1000000"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launches = counts()
        result = os.path.join("ckpt", "wild", "test_images_scene", "metrics.txt")
        train_metrics = read_metrics(result)
        with CliProbe() as test, contextlib.redirect_stdout(log):
            reset_counts()
            cli_s = time.perf_counter()
            wild.main_wild(["test", *common])
            torch.cuda.synchronize()
            test_s = time.perf_counter() - cli_s
            test_launches = counts()
        test_metrics = read_metrics(result)
        losses = [float(v) for v in train.losses]
        tc = train.configs[0]
        scalars = os.path.join("runs_prior_corrected", "wild", "scalars.jsonl")
        view = per_view(-(-H * W // RENDER_CHUNK))
        checks = {
            "launches per step": len(train.step_launches) == 10 and all(
                d == per_step() for d in train.step_launches),
            "finite losses": all(math.isfinite(v) for v in losses),
            "edge mask and masked RGB loss": tc.mask_edges and tc.mask_rgb,
            "runs_prior_corrected scalars": os.path.exists(scalars),
            "test launches": test_launches == {k: N_TEST * v for k, v in view.items()},
            "metrics.txt agree": metrics_agree(train_metrics, test_metrics),
            "finite metrics": all(math.isfinite(test_metrics[k]) for k in ("psnr", "ssim")),
        }
        line("wild", steps=10, train_command_s=train_s, test_command_s=test_s,
             loop_ms_per_step_median=statistics.median(train.step_ms()),
             loss_first=losses[0], loss_last=losses[-1], launches=dict(
                 train=train_launches, test=test_launches, per_step=train.step_launches[0]),
             mask_edges=tc.mask_edges, mask_rgb=tc.mask_rgb, hypothesis_load=train.hyp_load[0],
             metrics_test=test_metrics, checks=checks)
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"wild: failed {bad}")
        return checks
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise
    finally:
        os.chdir(cwd)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(out_dir: str, argv: list, log: io.StringIO, world: int) -> list:
    """``argv`` through the CLI on ``world`` ranks (torchrun, this script as
    each rank's program: ``dp_worker``); returns the ranks' records."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()), SCRIPT,
           "--dp-worker", out_dir, *argv, "--multihost"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    log.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"dp: torchrun exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    records = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}_{argv[0]}.json")) as f:
            records.append(json.load(f))
    return records


def dp_worker(out_dir: str, argv: list) -> int:
    """One rank of the dp phase: the CLI's main under a CliProbe, then the
    rank's launches, step times, losses and (for train) parameters."""
    rank = int(os.environ["RANK"])
    with CliProbe(first_grads=argv[0] == "train") as probe:
        reset_counts()
        state = cli.main("scannet", argv)
        torch.cuda.synchronize()
    rec = dict(rank=rank, launches=counts(), step_launches=probe.step_launches,
               step_ms=probe.step_ms(), host_ms=probe.host_ms,
               losses=[float(v) for v in probe.losses], view_launches=probe.view_launches,
               view_s=probe.view_s, hypothesis_load=probe.hyp_load)
    if argv[0] == "train":
        torch.save(model_params(state), os.path.join(out_dir, f"rank{rank}.pt"))
        torch.save(probe.first_grads, os.path.join(out_dir, f"rank{rank}_grads.pt"))
    with open(os.path.join(out_dir, f"rank{rank}_{argv[0]}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def model_params(state) -> dict:
    return {f"{w}.{n}": t.detach().cpu() for w, m in (("coarse", state.model_coarse),
                                                       ("fine", state.model_fine))
            for n, t in m.state_dict().items()}


def tar_params(path: str) -> dict:
    raw = ckpt.load_checkpoint_raw(path)
    return {f"{w}.{n[len('module.'):]}": t for w, key in (("coarse", "network_fn_state_dict"),
                                                          ("fine", "network_fine_state_dict"))
            for n, t in raw[key].items()}


def tars_equal(path_a: str, path_b: str) -> bool:
    """Two .tar files equal leaf by leaf: every tensor bit for bit, every
    other value by ==."""
    def leaves(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, x

    la = dict(leaves(ckpt.load_checkpoint_raw(path_a)))
    lb = dict(leaves(ckpt.load_checkpoint_raw(path_b)))
    return la.keys() == lb.keys() and all(
        torch.equal(v, lb[k]) if torch.is_tensor(v) else v == lb[k] for k, v in la.items())


def abs_diffs(a: dict, b: dict) -> torch.Tensor:
    return torch.cat([(a[k] - b[k]).abs().flatten() for k in a])


def phase_dp(tmp: str, seed: int, world: int = 2) -> dict:
    """Data parallelism on the cli phase's scene: ``train --multihost`` on
    ``world`` ranks for DP_STEPS steps at the reference defaults (N_rand 1024,
    1024 / world rays a rank) against 1 rank run twice in the same phase
    (the two bit-equal; see DP_STEPS for what the ranks are held to), the
    ranks' parameters bit-equal;
    then ``test --multihost`` (each view's rays split over the ranks)
    against ``test`` on 1 rank on the same checkpoint. Ranks share a card over
    gloo where there are fewer cards than ranks; else NCCL, a card a rank."""
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        os.chdir(tmp)
        flags = ["--num_iterations", str(DP_STEPS), "--i_weights", str(DP_STEPS),
                 "--i_print", "1", "--i_img", "1000000"]
        one = {}
        for name in ("dp1a", "dp1b"):
            with CliProbe(first_grads=True) as probe, contextlib.redirect_stdout(log):
                reset_counts()
                cli.main("scannet", ["train", *cli_common(tmp, seed, name), *flags])
                torch.cuda.synchronize()
            one[name] = dict(losses=[float(v) for v in probe.losses], step_ms=probe.step_ms(),
                             launches=probe.step_launches, grads=probe.first_grads,
                             params=tar_params(os.path.join("ckpt", name, f"{DP_STEPS:06d}.tar")))
        out = os.path.join(tmp, "dp_ranks")
        os.makedirs(out, exist_ok=True)
        t0 = time.perf_counter()
        ranks = torchrun(out, ["train", *cli_common(tmp, seed, "dp2"), *flags], log, world)
        dp_train_s = time.perf_counter() - t0
        two = tar_params(os.path.join("ckpt", "dp2", f"{DP_STEPS:06d}.tar"))
        per_rank = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
        # ranks print at once, so a line may run into another rank's output
        backend = re.findall(r"multihost: rank \d+/\d+ on \S+, (?:nccl|gloo)", log.getvalue())

        a, b = one["dp1a"], one["dp1b"]
        grads_two = [torch.load(os.path.join(out, f"rank{r}_grads.pt")) for r in range(world)]
        held = witness_check(a, b, dict(losses=ranks[0]["losses"], grads=grads_two[0], params=two))
        d_one, d_two = abs_diffs(b["params"], a["params"]), abs_diffs(two, a["params"])

        result = os.path.join("ckpt", "dp2", "test_images_scene", "metrics.txt")
        t0 = time.perf_counter()
        test_ranks = torchrun(out, ["test", *cli_common(tmp, seed, "dp2")], log, world)
        dp_test_s = time.perf_counter() - t0
        sharded = read_metrics(result)
        with CliProbe() as single, contextlib.redirect_stdout(log):
            cli.main("scannet", ["test", *cli_common(tmp, seed, "dp2")])
            torch.cuda.synchronize()
        single_metrics = read_metrics(result)

        rays_per_rank = -(-H * W // world)
        view = per_view(-(-rays_per_rank // RENDER_CHUNK))
        checks = {
            f"{world} ranks": len(backend) == world,
            "1 rank run twice bit-equal": held["one_rank_twice_bit_equal"]["ok"],
            "params within DP_REL of 1 rank's (median)": held["params_median"]["ok"],
            "first loss within DP_REL of 1 rank's": held["first_loss"]["ok"],
            "first grads within DP_REL of 1 rank's": held["first_grads"]["ok"],
            "ranks' first grads bit-equal": all(torch.equal(grads_two[0], g)
                                                for g in grads_two[1:]),
            "ranks' params bit-equal": all(torch.equal(per_rank[0][k], r[k])
                                           for r in per_rank[1:] for k in per_rank[0]),
            ".tar is rank 0's params": all(torch.equal(per_rank[0][k], two[k]) for k in two),
            "launches per step per rank": all(
                len(r["step_launches"]) == DP_STEPS
                and all(d == per_step() for d in r["step_launches"]) for r in ranks),
            "sharded test launches per view per rank": all(
                len(r["view_launches"]) == N_TEST
                and all(d == view for d in r["view_launches"])
                for r in test_ranks),
            "sharded test metrics equal 1 rank's": metrics_agree(sharded, single_metrics),
        }
        line("dp", world=world, backend=backend, steps=DP_STEPS, n_rand=1024,
             rays_per_rank=1024 // world,
             params=dict(median_abs_err_2_vs_1=held["params_median"]["err"],
                         median_spread_1_vs_1=held["params_median"]["spread"],
                         tol=held["params_median"]["tol"],
                         max_abs_err_2_vs_1=held["params_max"]["err"],
                         max_abs_spread_1_vs_1=held["params_max"]["spread"],
                         share_equal_2_vs_1=(d_two == 0).double().mean().item(),
                         share_equal_1_vs_1=(d_one == 0).double().mean().item(),
                         share_over_1e_4_2_vs_1=(d_two > 1e-4).double().mean().item(),
                         share_over_1e_4_1_vs_1=(d_one > 1e-4).double().mean().item(),
                         max_abs_param=max(t.abs().max().item() for t in a["params"].values())),
             losses=dict(two=ranks[0]["losses"], one_a=a["losses"], one_b=b["losses"],
                         first_abs_err=held["first_loss"]["err"],
                         first_spread=held["first_loss"]["spread"], first_tol=held["first_loss"]["tol"],
                         max_abs_err=max(abs(x - y) for x, y in zip(ranks[0]["losses"],
                                                                     a["losses"])),
                         max_spread=max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))),
             first_grads=dict(n=a["grads"].numel(), max_abs_err_2_vs_1=held["first_grads"]["err"],
                              max_abs_spread_1_vs_1=held["first_grads"]["spread"],
                              max_abs_grad=a["grads"].abs().max().item(),
                              tol=held["first_grads"]["tol"]),
             ms_per_step=dict(one_rank=[statistics.median(a["step_ms"]),
                                        statistics.median(b["step_ms"])],
                              per_rank=[statistics.median(r["step_ms"]) for r in ranks],
                              per_rank_host=[statistics.median(r["host_ms"][1:]) for r in ranks]),
             train_command_s=dp_train_s, test_command_s=dp_test_s,
             s_per_view=dict(sharded=[statistics.median(r["view_s"]) for r in test_ranks],
                             one_rank=statistics.median(single.view_s)),
             launches=dict(train=[r["launches"] for r in ranks],
                           test=[r["launches"] for r in test_ranks]),
             metrics=dict(sharded=sharded, one_rank=single_metrics), checks=checks)
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"dp: failed {bad}")
        return checks
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise
    finally:
        os.chdir(cwd)


def tp_run(scene: SceneTensors, seed: int, fused: bool, steps: int, grid=None) -> dict:
    """``steps`` train steps at the reference defaults on ``make_scene(seed)``'s
    ``scene`` through ``make_train_step(ranks=grid)``, on a state from
    ``create_train_state(grid=grid)`` (``use_fused=False``: the plain MLP,
    column-parallel on a grid): the losses, each step's ms and launches, the
    first step's grads as applied and the params after, whole (gathered over
    the model group); on a grid also the replicated tensors and what this
    rank holds."""
    rc = make_render_config(use_fused=fused)
    tc = TrainConfig()
    state = create_train_state(seed, rc, tc, n_images=N_TRAIN + N_VAL, grid=grid)
    step_fn = make_train_step(rc, tc, H, W, N_TRAIN, ranks=grid)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    first, apply = [], train_step.apply_grads

    def spy(st, grads, g_scales, g_shifts, *args, **kwargs):
        if not first:
            whole = tp_mesh.gather_nerf(st, grads) + [g_scales, g_shifts]
            first.append(torch.cat([g.detach().flatten().cpu() for g in whole]))
        return apply(st, grads, g_scales, g_shifts, *args, **kwargs)

    losses, ms, launches = [], [], []
    with mock.patch.object(train_step, "apply_grads", spy):
        for _ in range(steps):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            metrics = step_fn(state, scene, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = counts()
            launches.append({k: after[k] - before[k] for k in after})
            losses.append(float(metrics["loss"]))
    models = (("coarse", state.model_coarse), ("fine", state.model_fine))
    params = {f"{w}.{k}": v.cpu() for w, m in models for k, v in tp_mesh.gather_params(m).items()}
    out = dict(losses=losses, ms=ms, launches=launches, grads=first[0], params=params)
    if grid is not None:
        dims = tp_mesh.nerf_dims(state)
        names = [f"{w}.{k}" for w, m in models for k, _ in m.named_parameters()]
        local = state.nerf_params()
        rep = ([p for p, d in zip(local, dims) if d is None]
               + [m for m, d in zip(state.opt.mu + state.opt.nu, dims + dims) if d is None]
               + [state.scales, state.shifts, *state.ss_opt.mu, *state.ss_opt.nu])
        sharded = [(n, p, mu, nu) for n, p, mu, nu, d in
                   zip(names, local, state.opt.mu, state.opt.nu, dims) if d is not None]
        out.update(
            replicated=torch.cat([t.detach().flatten().cpu() for t in rep]),
            n_sharded=len(sharded),
            halves=all(p.shape[0] * grid.n_model == params[n].shape[0]
                       and p.shape[1:] == params[n].shape[1:] and mu.shape == p.shape
                       and nu.shape == p.shape for n, p, mu, nu in sharded),
            held_bytes=3 * 4 * sum(p.numel() for p in local),
            whole_bytes=3 * 4 * sum(params[n].numel() for n in names),
            sharded_held_bytes=3 * 4 * sum(p.numel() for _, p, _, _ in sharded),
            sharded_whole_bytes=3 * 4 * sum(params[n].numel() for n, _, _, _ in sharded),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def tp_worker(out_dir: str, seed: int) -> int:
    """One rank of the tp phase (torchrun): a grid of TP_N_MODEL model
    columns, DP_STEPS steps with K1 on, then TP_PLAIN_STEPS on the plain
    column-parallel path, each from the seed's weights."""
    ranks, device, backend = par_dist.init_from_env("cuda")
    try:
        grid = par_dist.make_grid(TP_N_MODEL)
        rec = dict(rank=ranks.rank, data_index=grid.data_index, model_index=grid.model_index,
                   backend=backend, device=device)
        scene = make_scene(seed)
        torch.cuda.reset_peak_memory_stats()
        rec["fused"] = tp_run(scene, seed, True, DP_STEPS, grid)
        torch.cuda.empty_cache()
        rec["plain"] = tp_run(scene, seed, False, TP_PLAIN_STEPS, grid)
        torch.save(rec, os.path.join(out_dir, f"tp_rank{ranks.rank}.pt"))
    finally:
        par_dist.destroy()
    return 0


def witness_check(a: dict, b: dict, got: dict) -> dict:
    """``got`` (from ranks) held to the 1-rank run ``a`` and its repeat
    ``b``, the rule of the dp and tp phases: ``a`` and ``b`` bit-equal (losses,
    first grads, params), and the first loss, the first grads and the
    params' median distance within DP_REL of their magnitude."""
    d_one, d_got = abs_diffs(b["params"], a["params"]), abs_diffs(got["params"], a["params"])
    scale = max(t.abs().max().item() for t in a["params"].values())
    out = {}
    for name, err, spread, mag in (
            ("params_median", d_got.median().item(), d_one.median().item(), scale),
            ("first_loss", abs(got["losses"][0] - a["losses"][0]),
             abs(b["losses"][0] - a["losses"][0]), abs(a["losses"][0])),
            ("first_grads", (got["grads"] - a["grads"]).abs().max().item(),
             (b["grads"] - a["grads"]).abs().max().item(), a["grads"].abs().max().item())):
        tol = DP_REL * mag
        out[name] = dict(err=err, spread=spread, tol=tol, ok=err <= tol)
    out["params_max"] = dict(err=d_got.max().item(), spread=d_one.max().item())
    out["one_rank_twice_bit_equal"] = dict(ok=bool(
        a["losses"] == b["losses"] and torch.equal(a["grads"], b["grads"])
        and all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])))
    return out


def phase_tp(seed: int, world: int = 2) -> dict:
    """The mesh's model axis: ``world`` ranks (torchrun, this script as each
    rank's program: ``--tp-worker``; NCCL with a card a rank, else gloo on the
    one card) as ``world / TP_N_MODEL`` data rows by TP_N_MODEL model
    columns, at the reference defaults (8x256, 64+128 samples, N_rand 1024,
    f32) on the train phase's scene, held to 1 rank run twice: DP_STEPS
    steps with K1 on (2 launches a step per rank, on gathered weights), then
    TP_PLAIN_STEPS on the column-parallel plain path (use_fused=False)
    against the plain 1-rank step. A data row's ranks hold bit-equal
    replicated tensors, and each rank 1/TP_N_MODEL of each sharded weight,
    bias and Adam moment."""
    t_phase = time.perf_counter()
    scene = make_scene(seed)
    one = {name: [tp_run(scene, seed, fused, steps) for _ in range(2)]
           for name, fused, steps in (("fused", True, DP_STEPS), ("plain", False, TP_PLAIN_STEPS))}
    del scene
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="scade_tp_")
    try:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
               "--master_addr", "127.0.0.1", "--master_port", str(free_port()), SCRIPT,
               "--tp-worker", out, str(seed)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        command_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"tp: torchrun exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        ranks = [torch.load(os.path.join(out, f"tp_rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    want = {"fused": per_step(), "plain": per_step(k1=0)}
    # the coarse and the fine model's sharded tensors, by the rule on a whole model
    n_sharded = 2 * sum(d is not None for d in tp_mesh.nerf_param_specs(
        NeRF(make_render_config(device="cpu").nerf_coarse)).values())
    held = {name: [witness_check(*one[name], r[name]) for r in ranks] for name in one}
    checks = {
        f"{world} ranks as {world // TP_N_MODEL}x{TP_N_MODEL}": sorted(
            (r["data_index"], r["model_index"]) for r in ranks) == [
                (d, m) for d in range(world // TP_N_MODEL) for m in range(TP_N_MODEL)],
        "launches per step per rank": all(
            all(d == want[name] for d in r[name]["launches"]) for r in ranks for name in want),
        "replicated bit-equal across a data row": all(
            torch.equal(a[name]["replicated"], b[name]["replicated"])
            for a in ranks for b in ranks if a["data_index"] == b["data_index"] for name in one),
        "each rank holds 1/n_model of each sharded weight, bias, moment": all(
            r[name]["halves"] and r[name]["n_sharded"] == n_sharded
            for r in ranks for name in one),
        "1 rank run twice bit-equal, params, first loss, first grads within DP_REL": all(
            c["ok"] for h in held.values() for r in h for k, c in r.items() if "ok" in c),
        "finite losses": all(math.isfinite(x) for r in ranks for name in one
                             for x in r[name]["losses"]),
    }
    r0 = ranks[0]
    line("tp", world=world, n_model=TP_N_MODEL, backend=[r["backend"] for r in ranks],
         steps=DP_STEPS, plain_steps=TP_PLAIN_STEPS, n_rand=1024,
         rays_per_data_row=1024 // (world // TP_N_MODEL),
         held={name: [{k: {kk: vv for kk, vv in c.items() if kk != "ok"} for k, c in h.items()
                       if k != "one_rank_twice_bit_equal"} for h in held[name]] for name in held},
         one_rank_twice_bit_equal={name: held[name][0]["one_rank_twice_bit_equal"]["ok"]
                                   for name in held},
         losses=dict(fused=[r["fused"]["losses"] for r in ranks],
                     one_a=one["fused"][0]["losses"], one_b=one["fused"][1]["losses"],
                     plain=[r["plain"]["losses"] for r in ranks],
                     plain_one=[x["losses"] for x in one["plain"]]),
         ms_per_step=dict(
             per_rank=[statistics.median(r["fused"]["ms"][1:]) for r in ranks],
             one_rank=[statistics.median(x["ms"][1:]) for x in one["fused"]],
             first_step_per_rank=[r["fused"]["ms"][0] for r in ranks],
             plain_per_rank=[r["plain"]["ms"] for r in ranks],
             plain_one_rank=[x["ms"] for x in one["plain"]]),
         bytes_per_rank=dict(
             nerf_params_and_moments=[r["fused"]["held_bytes"] for r in ranks],
             whole=r0["fused"]["whole_bytes"],
             sharded_tensors=[r["fused"]["sharded_held_bytes"] for r in ranks],
             sharded_tensors_whole=r0["fused"]["sharded_whole_bytes"]),
         n_sharded_tensors=r0["fused"]["n_sharded"],
         launches=[r["fused"]["launches"] for r in ranks],
         peak_gb_per_rank=[r["plain"]["peak_gb"] for r in ranks],
         command_s=command_s, phase_s=time.perf_counter() - t_phase, checks=checks)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"tp: failed {bad}")
    return dict(launches=r0["fused"]["launches"])


def spvcnn_depth(seed: int) -> np.ndarray:
    """A seeded 468x624 depth map of a room-like scene (a tilted back wall
    and floor, smooth bumps, 1% invalid pixels), in metres."""
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    depth = (2.0 + 1.5 * v / H + 0.4 * u / W + 0.3 * np.sin(u / 53.0) * np.cos(v / 41.0)
             + 0.005 * rng.standard_normal((H, W))).astype(np.float32)
    depth[rng.random((H, W)) < 0.01] = 0.0
    return depth


class SpvcnnProbe:
    """Times the classifier's parts with a synchronize around each call (so
    only in a pass of its own): the kernel maps (kernel_map, sparse_unique)
    apart from the gathers and products (_sparse_products), and
    counts the voxel sites of each conv's output by its stride."""

    def __init__(self):
        self.map_ms, self.gemm_ms, self.sites = 0.0, 0.0, {}
        self._patches = [mock.patch.object(spvcnn, name, self._timed(getattr(spvcnn, name), kind))
                         for name, kind in (("kernel_map", "map"), ("sparse_unique", "map"),
                                            ("_sparse_products", "gemm"))]
        conv = spvcnn.sparse_conv3d

        def counted(*args, **kwargs):
            y = conv(*args, **kwargs)
            self.sites[y.stride] = int(y.mask.sum())
            return y

        self._patches.append(mock.patch.object(spvcnn, "sparse_conv3d", counted))

    def _timed(self, fn, kind):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if kind == "map":
                self.map_ms += dt
            else:
                self.gemm_ms += dt
            return out
        return wrapped

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def spvcnn_on_cpu(x):
    """A tensor or a SparseVoxels, on the CPU."""
    if isinstance(x, spvcnn.SparseVoxels):
        return x._replace(feats=x.feats.cpu(), coords=x.coords.cpu(), mask=x.mask.cpu())
    return x.cpu()


def spvcnn_tap_err(card, cpu) -> dict:
    """A stage's output (SparseVoxels: the same sites and coordinates, the
    features on its valid rows) or the pooled features on the card against
    the CPU's, to SPVCNN_RTOL of their own largest |feature|, with no atol:
    at seeded weights each stage's features are about a tenth of the one
    before, so the logit, and an atol, would hardly see the last stages."""
    sites = True
    if isinstance(cpu, spvcnn.SparseVoxels):
        sites = (card.stride == cpu.stride and torch.equal(card.mask, cpu.mask)
                 and torch.equal(card.coords[cpu.mask], cpu.coords[cpu.mask]))
        card, cpu = card.feats[cpu.mask], cpu.feats[cpu.mask]
    err = (card - cpu).abs().max().item()
    tol = SPVCNN_RTOL * cpu.abs().max().item()
    return dict(shape=list(cpu.shape), abs_err=err, tol=tol, same_sites=sites,
                ok=sites and err <= tol)


def phase_spvcnn(seed: int) -> dict:
    """The SPVCNN classifier (prior/spvcnn.py) at full width on the card:
    refine_focal with a 5-channel model and refine_shift with a 3-channel
    one (seeded weights, cr=1.0, pres = vres) on a seeded 468x624 depth map,
    on the card and on the CPU; their logits, each stage's output and the
    pooled features held within SPVCNN_RTOL (the sites exactly); the
    forward's ms (the kernel maps apart from the gathers and products in a
    synchronized pass), peak GB and the voxel sites at each stride."""
    t_phase = time.perf_counter()
    depth = spvcnn_depth(seed)
    u0, v0 = W / 2.0, H / 2.0
    res = {}
    for name, channels in (("focal", 5), ("shift", 3)):
        cfg = spvcnn.SPVCNNConfig(input_channel=channels, num_classes=1, cr=1.0, pres=0.01,
                                  vres=0.01)
        cpu_model = spvcnn.init_spvcnn(cfg, torch.Generator().manual_seed(seed + channels))
        card_model = spvcnn.init_spvcnn(cfg, torch.Generator().manual_seed(seed + channels))
        card_model.cuda()
        seen = {"cpu": [], "cuda": []}

        def bound(model, dev):
            def apply(points):
                taps = {}
                hooks = [getattr(model, f"stage{i}").register_forward_hook(
                    lambda _m, _x, y, i=i: taps.__setitem__(f"stage{i}", y)) for i in range(1, 5)]
                hooks.append(model.classifier.register_forward_pre_hook(
                    lambda _m, x: taps.__setitem__("pooled", x[0])))
                try:
                    with torch.no_grad():
                        out = model(points.to(dev))
                finally:
                    for h in hooks:
                        h.remove()
                seen[dev].append((points, out.cpu(), {k: spvcnn_on_cpu(v) for k, v in taps.items()}))
                return out
            return apply

        values, secs = {}, {}
        for dev, model in (("cuda", card_model), ("cpu", cpu_model)):
            t0 = time.perf_counter()
            if name == "focal":
                values[dev] = spvcnn.refine_focal(depth, SPVCNN_FOCAL, bound(model, dev), u0, v0)
            else:
                values[dev] = spvcnn.refine_shift(depth, bound(model, dev), SPVCNN_FOCAL, u0, v0)
            secs[dev] = time.perf_counter() - t0
        points, card_logit, card_taps = seen["cuda"][0]
        cpu_logit, cpu_taps = seen["cpu"][0][1:]
        err = (card_logit - cpu_logit).abs().max().item()
        tol = SPVCNN_RTOL * cpu_logit.abs().max().item() + SPVCNN_ATOL
        taps = {k: spvcnn_tap_err(card_taps[k], cpu_taps[k]) for k in cpu_taps}
        del seen, card_taps, cpu_taps
        pts = points.to("cuda")
        with torch.no_grad():
            card_model(pts)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: card_model(pts), reps=SPVCNN_REPS, warmup=0)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            with SpvcnnProbe() as probe:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card_model(pts)
                torch.cuda.synchronize()
                probed_ms = (time.perf_counter() - t0) * 1e3
        res[name] = dict(channels=channels, valid_points=int(points.mask.sum()),
                         capacity=points.mask.numel(), value_card=values["cuda"],
                         value_cpu=values["cpu"], logit_card=card_logit.item(),
                         logit_cpu=cpu_logit.item(), abs_err=err, tol=tol, ok=err <= tol,
                         taps=taps,
                         forward_ms=ms, probed_pass_ms=probed_ms, kernel_map_ms=probe.map_ms,
                         gather_matmul_ms=probe.gemm_ms,
                         other_ms=probed_ms - probe.map_ms - probe.gemm_ms,
                         sites_by_stride={str(k): v for k, v in sorted(probe.sites.items())},
                         peak_gb=peak_gb, card_call_s=secs["cuda"], cpu_call_s=secs["cpu"],
                         params=sum(p.numel() for p in cpu_model.parameters()))
        del card_model
        torch.cuda.empty_cache()
    checks = {f"{k} card logit within rtol of the CPU's": v["ok"] for k, v in res.items()}
    checks.update({f"{k} card {t} within rtol of the CPU's": d["ok"]
                   for k, v in res.items() for t, d in v["taps"].items()})
    checks["finite"] = all(math.isfinite(v["logit_card"]) for v in res.values())
    line("spvcnn", H=H, W=W, focal_px=SPVCNN_FOCAL, cr=1.0, rtol=SPVCNN_RTOL, **res,
         phase_s=time.perf_counter() - t_phase, checks=checks)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"spvcnn: failed {bad}")
    return res


def conv_linear_flops(model, x, z, shifts) -> int:
    """Operations (2 per multiply-add) of every Conv2d and Linear in one
    forward of ``model``, counted from their weights and output shapes."""
    total = [0]

    def count(mod, _inputs, out):
        total[0] += 2 * mod.weight[0].numel() * out.numel()  # weight[0]: in/groups·kh·kw

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            model(x, z, shifts)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def prior_forward_ms(model, shifts, x, z, reps: int = 5) -> float:
    with torch.inference_mode():
        xb, zb = x.expand(z.shape[0], -1, -1, -1), z.to(x.dtype)
        return cuda_ms(lambda: model(xb, zb, shifts), reps)


class TimeProbe:
    """Times each call of the functions ``names`` of ``module`` (in ``s``,
    by name), without changing them; with ``sync`` each call is ended by a
    synchronize, so its time is the device's too."""

    def __init__(self, module, names, sync: bool = False):
        self.s = {name: [] for name in names}
        self._patches = [mock.patch.object(module, name, self._timed(getattr(module, name),
                                                                     self.s[name], sync))
                         for name in names]

    @staticmethod
    def _timed(fn, into, sync):
        def wrapped(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return wrapped

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def prior_step_on(device, state: dict, shifts: dict, batch: dict, z, draws: dict,
                  dtype=torch.float32) -> dict:
    """One SGD step of the trainer (TF32 off) from ``state`` on ``device``
    in ``dtype``: the losses, and the state after it on the host."""
    cfg = prior_model.backbone_config("resnext101_32x8d", d_latent=PRIOR_D_LATENT)
    m = prior_model.DepthModelCIMLE(cfg, "v2")
    m.load_state_dict(state, strict=True)
    m.to(device, dtype)
    tc = prior_train.PriorTrainConfig()
    opt = prior_train.PriorOptimizer(m, tc)

    def to(t):
        return t.to(device, dtype) if t.is_floating_point() else t.to(device)

    with prior_dump.matmul_precision("highest"):
        total, losses = prior_train.train_step(
            m, opt, {k: to(v) for k, v in shifts.items()}, {k: to(v) for k, v in batch.items()},
            to(z), {k: tuple(t.to(device) for t in v) for k, v in draws.items()}, tc)
    return dict(total=float(total), losses={k: float(v) for k, v in losses.items()},
                state={k: v.detach().cpu() for k, v in m.state_dict().items()},
                params=[n for n, _ in m.named_parameters()])


def prior_step_check(ckpt: str, shifts: dict, examples: list, seed: int) -> dict:
    """The card's SGD step against the CPU's on two one-view batches: the
    scene's first view as the trainer reads it (quality 2, no planes), and
    its second with quality 3 and a seeded plane mask (two planes over most
    of the image), so that the PWN edge and plane losses carry gradient. The
    same z and the same sampled pixels, drawn once on the host; the same
    step on the CPU in f64 is the update's witness."""
    state = torch.load(ckpt)["model_state_dict"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, ex, quality in (("scene_view", examples[0], None), ("planes_q3", examples[1], 3)):
        batch = prior_data.collate([ex])
        if quality is not None:
            S = batch["planes"].shape[1]
            planes = np.zeros((1, S, S), np.int32)
            planes[:, :, : S // 2] = 1
            planes[:, : S // 2, S // 2:] = 2
            planes[rng.uniform(size=planes.shape) < 0.05] = 0
            batch.update(planes=planes, quality_flg=np.array([quality], np.int32))
        batch = prior_train.batch_to_torch(batch, "cpu")
        z = torch.randn((1, PRIOR_D_LATENT), generator=gen)
        draws = prior_losses.draw_criterion(gen, batch, prior_losses.DEFAULT_LOSS_MODE)
        t0 = time.perf_counter()
        cpu = prior_step_on("cpu", state, shifts, batch, z, draws)
        cpu_s = time.perf_counter() - t0
        f64 = prior_step_on("cpu", state, shifts, batch, z, draws, torch.float64)
        card = prior_step_on("cuda", state, shifts, batch, z, draws)
        total = abs(cpu["losses"]["total_loss"])
        loss_err = max(abs(card["losses"][k] - v) for k, v in cpu["losses"].items()) / total

        def update(run):
            return torch.cat([(run["state"][n].double() - state[n].double()).flatten()
                              for n in cpu["params"]])

        u_cpu, u_card, u64 = update(cpu), update(card), update(f64)
        dist = {name: dict(l2=float((u - u64).norm()), max=float((u - u64).abs().max()))
                for name, u in (("cpu_f32", u_cpu), ("card_f32", u_card))}
        bn_err = max((card["state"][k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
                     for k, v in cpu["state"].items()
                     if k.endswith(("running_mean", "running_var")))
        out[name] = dict(losses_cpu=cpu["losses"], losses_card=card["losses"],
                         losses_cpu_f64=f64["losses"], loss_max_err_rel_to_total=loss_err,
                         update_l2_f64=float(u64.norm()), update_max_f64=float(u64.abs().max()),
                         distance_from_f64=dist,
                         card_vs_cpu_update_max=float((u_card - u_cpu).abs().max()),
                         bn_max_rel_err=bn_err, cpu_step_s=cpu_s,
                         ok=bool(loss_err <= PRIOR_STEP_LOSS_REL and bn_err <= PRIOR_STEP_BN_REL
                                 and dist["card_f32"]["l2"]
                                 <= PRIOR_STEP_WITNESS_RATIO * dist["cpu_f32"]["l2"]))
    active = out["planes_q3"]["losses_card"]
    out["edge_and_plane_active"] = bool(active["pairwise-normal-regress-edge_loss"] > 0
                                        and active["pairwise-normal-regress-plane_loss"] > 0)
    return out


def phase_prior_train(tmp: str, seed: int) -> dict:
    """The depth prior's training path, as a user runs it:
    ``python -m scade_tpu_torch.prior.train`` on a ScanNet-shaped scene
    (write_scene's, in ``tmp``) with the full-width ResNeXt101-32x8d v2
    model (d_latent 32, 448 crop, the five-loss default), fresh seeded
    weights, one epoch at batch 4: the AdaIn init over the 18 views, a
    recache of 20 z (4 sets of 5) per view, 5 SGD steps, f32 with TF32 off;
    then a short bf16 run (AdaIn init over 4 views, zero z, one epoch). It
    must write the 4 encoder AdaIn means and variances, finite, cache an
    (18, 32) finite z, log finite losses at every step and write
    ``epoch0_step0.pth``; one SGD step on the card must equal the CPU's
    (``prior_step_check``). Times: the AdaIn init per view, the recache per
    image, a B=4 step in f32, f32 with TF32 and bf16 beside 3× the forward's
    conv+linear FLOP bound, the criterion's forward+backward against the
    model's. Returns the checkpoint and the AdaIn statistics for the prior
    phase to dump from."""
    log = io.StringIO()
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    try:
        write_scene(tmp, seed)
        scene_dir = os.path.join(tmp, "scene")
        common = ["--scene_dir", scene_dir, "--seed_num", str(seed), "--d_latent",
                  str(PRIOR_D_LATENT)]
        log_dir, jsonl = os.path.join(tmp, "prior_log"), os.path.join(tmp, "prior_losses.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        names = ("compute_adain_stats", "recache_z", "train_step")
        with TimeProbe(prior_train, names, sync=True) as probe, contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            out = prior_train.main([*common, "--log_dir", log_dir, *PRIOR_TRAIN_ARGS,
                                    "--precision", "highest", "--loss_jsonl", jsonl])
            command_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = prior_model.backbone_config("resnext101_32x8d", d_latent=PRIOR_D_LATENT)
        mv_path = os.path.join(log_dir, "mean_var_adain.npy")
        mv = np.load(mv_path, allow_pickle=True).item()
        dims = prior_model.encoder_adain_dims(cfg)
        mv_ok = sorted(mv) == sorted(f"{w}{i}" for i in range(4) for w in ("mean", "var")) and all(
            mv[f"{w}{i}"].shape == (d,) and np.isfinite(mv[f"{w}{i}"]).all()
            for i, d in enumerate(dims) for w in ("mean", "var"))
        z = out["z"]
        recs = [json.loads(x) for x in open(jsonl).read().splitlines()]
        n_steps = -(-N_TRAIN // 4)
        steps_ok = len(recs) == n_steps and all(math.isfinite(v) for r in recs
                                                for v in r.values())
        ckpt = os.path.join(log_dir, "epoch0_step0.pth")

        log16, jsonl16 = os.path.join(tmp, "prior_log_bf16"), os.path.join(tmp, "bf16.jsonl")
        with TimeProbe(prior_train, ("train_step",), sync=True) as probe16, \
                contextlib.redirect_stdout(log):
            prior_train.main([*common, "--log_dir", log16, "--epochs", "1", "--batchsize", "4",
                              "--adain_subset", "4", "--debug_mode", "--compute_dtype",
                              "bfloat16", "--loss_jsonl", jsonl16])
        recs16 = [json.loads(x) for x in open(jsonl16).read().splitlines()]
        bf16_ok = len(recs16) == n_steps and all(math.isfinite(v) for r in recs16
                                                 for v in r.values())

        # a B=4 step, timed alone in each mode, on the trained model
        model, shifts = out["model"], out["shifts"]
        ds = prior_data.FinetuneDataset(os.path.join(scene_dir, "train"))
        examples = [ds[i] for i in range(4)]
        batch = prior_train.batch_to_torch(prior_data.collate(examples), dev)
        z4 = torch.from_numpy(z[:4]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        mode = prior_losses.DEFAULT_LOSS_MODE
        draws = prior_losses.draw_criterion(gen, batch, mode)
        tc = prior_train.PriorTrainConfig()
        opt = prior_train.PriorOptimizer(model, tc)
        step_ms = {}
        for name, precision, dtype in (("f32", "highest", None), ("f32_tf32", "high", None),
                                       ("bf16", "highest", "bfloat16")):
            tcm = dataclasses.replace(tc, compute_dtype=dtype)
            with prior_dump.matmul_precision(precision):
                step_ms[name] = cuda_ms(lambda: prior_train.train_step(
                    model, opt, shifts, batch, z4, draws, tcm), reps=3)
        model.train()
        with prior_dump.matmul_precision("highest"):
            with torch.no_grad():
                depth = prior_model.prior_apply(model, shifts, batch["rgb"], z4, train=True)
            leaf = depth.float().requires_grad_(True)
            criterion_ms = cuda_ms(lambda: prior_losses.criterion(
                leaf, batch, mode, draws)[1].mean().backward(), reps=3)
            model_ms = cuda_ms(lambda: prior_model.prior_apply(
                model, shifts, batch["rgb"], z4, train=True).mean().backward(), reps=3)
            draw_ms = cuda_ms(lambda: prior_losses.draw_criterion(gen, batch, mode), reps=3)
        model.eval()
        step_flops = 3 * conv_linear_flops(model, batch["rgb"], z4, shifts)
        del model, opt, out, leaf, depth
        torch.cuda.empty_cache()

        check = prior_step_check(ckpt, {k: v.cpu() for k, v in shifts.items()}, examples, seed)
        adain_s, recache_s = probe.s["compute_adain_stats"][0], probe.s["recache_z"][0]
        checks = {"AdaIn statistics: 4 finite means and variances": mv_ok,
                  "cached z (18, 32), finite": z.shape == (N_TRAIN, PRIOR_D_LATENT)
                  and bool(np.isfinite(z).all()),
                  "finite losses every f32 step": steps_ok,
                  "checkpoint written": os.path.exists(ckpt),
                  "finite losses every bf16 step": bf16_ok,
                  "card step = CPU step (scene view)": check["scene_view"]["ok"],
                  "card step = CPU step (planes, quality 3)": check["planes_q3"]["ok"],
                  "PWN edge and plane losses active": check["edge_and_plane_active"]}
        line("prior_train", backbone="resnext101_32x8d", version="v2", d_latent=PRIOR_D_LATENT,
             crop=448, views=N_TRAIN, argv=PRIOR_TRAIN_ARGS, command_s=command_s,
             adain_s_per_view=adain_s / N_TRAIN, recache_s_per_image=recache_s / N_TRAIN,
             recache_z=20, cli_step_ms=[1e3 * v for v in probe.s["train_step"]],
             cli_bf16_step_ms=[1e3 * v for v in probe16.s["train_step"]],
             losses_first_step=recs[0], step_ms_b4=step_ms, criterion_fwd_bwd_ms_b4=criterion_ms,
             model_fwd_bwd_ms_b4=model_ms, criterion_draw_ms_b4=draw_ms,
             step_gflop_b4=step_flops / 1e9,
             step_bound_ms=dict(f32=step_flops / PEAK_F32 * 1e3,
                                tf32=step_flops / PEAK_TF32 * 1e3,
                                bf16=step_flops / PEAK_BF16 * 1e3),
             peak_gb=peak_gb, phase_s=time.perf_counter() - t_phase, card_vs_cpu_step=check,
             tol=dict(loss_rel_to_total=PRIOR_STEP_LOSS_REL, bn_rel=PRIOR_STEP_BN_REL,
                      update_witness_ratio=PRIOR_STEP_WITNESS_RATIO), checks=checks)
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"prior_train: failed {bad}")
        return {"ckpt": ckpt, "mean_var": mv_path}
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise


def phase_prior(tmp: str, seed: int, trained: dict) -> dict:
    """The depth prior's inference path on what the prior_train phase wrote,
    then a NeRF trained on its output. Its checkpoint of the full-width
    ResNeXt101-32x8d cIMLE model (v2, d_latent 32) and its
    ``mean_var_adain.npy``, loaded as a user's checkpoint is (strictly, and
    bit-equal to the file); on the first view of the scene at the 448 crop:
    the card's f32 forward (TF32 off) against the CPU's on 2 z, and bf16
    against f32 on the card on 20 z, with forward times in bf16, f32 with
    TF32 and f32; then ``python -m scade_tpu_torch.prior.dump`` as a user runs
    it (K=20 in one set of 20, bf16, the defaults) on the scene's 18 train
    views, which must write 360 finite (468, 624) float32 files; then the
    CLI's ``train`` for 5 steps on those files, K1 and K2 at 2 launches a
    step."""
    cwd = os.getcwd()
    log = io.StringIO()
    dev = torch.device("cuda")
    try:
        scene_dir = os.path.join(tmp, "scene")
        ckpt_path, mean_var = trained["ckpt"], trained["mean_var"]
        t0 = time.perf_counter()
        saved = torch.load(ckpt_path)["model_state_dict"]
        cpu_model = prior_dump.build_prior(ckpt_path, device="cpu")
        loaded = cpu_model.state_dict()
        loaded_equal = saved.keys() == loaded.keys() and all(torch.equal(saved[k], v)
                                                             for k, v in loaded.items())
        n_params = sum(p.numel() for p in cpu_model.parameters())
        del saved, loaded
        setup_s = time.perf_counter() - t0
        shifts_cpu = prior_model.load_mean_var_adain(mean_var)
        shifts = {k: v.to(dev) for k, v in shifts_cpu.items()}

        ds = prior_data.FinetuneDataset(os.path.join(scene_dir, "train"))
        x_cpu = torch.from_numpy(np.ascontiguousarray(ds[0].rgb.transpose(2, 0, 1)))[None]
        x = x_cpu.to(dev)
        zgen = torch.Generator(device=dev).manual_seed(seed)
        z20 = torch.randn((PRIOR_K, PRIOR_D_LATENT), generator=zgen, device=dev)

        # card f32 (TF32 off) against the CPU's f32, one image, 2 z
        t0 = time.perf_counter()
        cpu_out = prior_dump.infer(cpu_model, shifts_cpu, x_cpu, z20[:2].cpu())
        cpu_s = time.perf_counter() - t0
        del cpu_model
        model = prior_dump.build_prior(ckpt_path, device=dev)
        with prior_dump.matmul_precision("highest"):
            card_out = prior_dump.infer(model, shifts, x, z20[:2])
            f32_20 = prior_dump.infer(model, shifts, x, z20)
            f32_ms = prior_forward_ms(model, shifts, x, z20)
        with prior_dump.matmul_precision("high"):
            tf32_ms = prior_forward_ms(model, shifts, x, z20)
        f32_err = float(np.abs(card_out - cpu_out).max())
        f32_scale = float(np.abs(cpu_out).max())
        flops = conv_linear_flops(model, x.expand(PRIOR_K, -1, -1, -1), z20, shifts)

        # bf16 against f32 on the card, 20 z
        bf16_shifts = {k: v.bfloat16() for k, v in shifts.items()}
        model.bfloat16()
        bf16_20 = prior_dump.infer(model, bf16_shifts, x.bfloat16(), z20)
        bf16_ms = prior_forward_ms(model, bf16_shifts, x.bfloat16(), z20)
        bf16_rel = float(np.abs(bf16_20 - f32_20).mean() / np.abs(f32_20).mean())
        # where the bf16 forward's time goes: the encoder alone (the rest is
        # the decoder), and the whole in channels_last, which the port does
        # not use (a layout to weigh against NCHW)
        encoder_ms = prior_forward_ms(model.encoder_modules, bf16_shifts, x.bfloat16(), z20)
        encoder_flops = conv_linear_flops(model.encoder_modules, x.expand(PRIOR_K, -1, -1, -1)
                                          .bfloat16(), z20.bfloat16(), bf16_shifts)
        model.to(memory_format=torch.channels_last)
        x_cl = x.bfloat16().contiguous(memory_format=torch.channels_last)
        cl_rel = float(np.abs(prior_dump.infer(model, bf16_shifts, x_cl, z20) - bf16_20).mean()
                       / np.abs(bf16_20).mean())
        cl_ms = prior_forward_ms(model, bf16_shifts, x_cl, z20)
        del model
        torch.cuda.empty_cache()

        # the dump as a user runs it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with TimeProbe(prior_dump, ("infer", "write_view", "recover_metric_depth")) as probe, \
                contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            out_dir = prior_dump.main(["--scene_dir", scene_dir, "--ckpt", ckpt_path,
                                       "--mean_var", mean_var, "--dump_dir", "prior",
                                       "--num_hypothesis", str(PRIOR_K), "--mini_batch_size",
                                       str(PRIOR_K), "--seed_num", str(seed)])
            dump_s = time.perf_counter() - t0
        dump_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        names = sorted(os.listdir(out_dir))
        expect = sorted(f"{i}_{k}.npy" for i in range(N_TRAIN) for k in range(PRIOR_K))
        arrays = [np.load(os.path.join(out_dir, n)) for n in names]
        files_ok = names == expect and all(
            a.shape == (H, W) and a.dtype == np.float32 and np.isfinite(a).all() for a in arrays)
        hyp_range = (float(min(a.min() for a in arrays)), float(max(a.max() for a in arrays)))
        del arrays

        # prior → NeRF: the CLI trains on what the dump wrote
        os.chdir(tmp)
        with CliProbe() as train, contextlib.redirect_stdout(log):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            cli.main("scannet", ["train", "--data_dir", tmp, "--scene_id", "scene",
                                 "--ckpt_dir", "ckpt", "--expname", "prior", "--cimle_dir", "prior",
                                 "--num_hypothesis", str(PRIOR_K), "--seed", str(seed),
                                 "--num_iterations", str(PRIOR_NERF_STEPS), "--i_weights",
                                 "1000000", "--i_img", "1000000", "--i_print", "1000000"])
            torch.cuda.synchronize()
            nerf_s = time.perf_counter() - t0
        losses = [float(v) for v in train.losses]
        steps_ok = len(train.step_launches) == PRIOR_NERF_STEPS and all(
            d == per_step() for d in train.step_launches)
        finite = all(math.isfinite(v) for v in losses)

        checks = {"checkpoint reloads bit-equal": loaded_equal,
                  "card f32 against CPU f32": f32_err <= PRIOR_F32_TOL * f32_scale,
                  "bf16 against f32": bf16_rel < PRIOR_BF16_REL,
                  "finite forward": bool(np.isfinite(f32_20).all() and np.isfinite(bf16_20).all()),
                  "360 hypothesis files": files_ok,
                  "NeRF launches per step": steps_ok, "NeRF finite loss": finite}
        infer_s, write_s = probe.s["infer"], probe.s["write_view"]
        n_views = len(write_s)
        line("prior", backbone="resnext101_32x8d", version="v2", d_latent=PRIOR_D_LATENT,
             crop=448, K=PRIOR_K, params=n_params, setup_s=setup_s,
             f32_vs_cpu=dict(max_abs_err=f32_err, max_abs_out=f32_scale,
                             tol_rel_to_max=PRIOR_F32_TOL, z=2, cpu_s=cpu_s),
             bf16_vs_f32=dict(mean_rel_diff=bf16_rel, tol=PRIOR_BF16_REL, z=PRIOR_K),
             forward_ms_per_image=dict(bf16=bf16_ms, f32_tf32=tf32_ms, f32=f32_ms),
             bf16_encoder_ms_per_image=encoder_ms, bf16_channels_last_ms_per_image=cl_ms,
             bf16_channels_last_mean_rel_diff=cl_rel,
             gflop_per_image=flops / 1e9, encoder_gflop_per_image=encoder_flops / 1e9,
             bound_ms=dict(bf16=flops / PEAK_BF16 * 1e3, tf32=flops / PEAK_TF32 * 1e3,
                           f32=flops / PEAK_F32 * 1e3),
             dump=dict(command_s=dump_s, views=n_views, files=len(names),
                       forward_s_per_view=sum(infer_s) / n_views,
                       forward_s_first_view=infer_s[0],
                       forward_s_per_view_after_first=statistics.median(infer_s[1:]),
                       host_s_per_view=sum(write_s) / n_views,
                       host_s_per_view_median=statistics.median(write_s),
                       polyfit_s_per_view=sum(probe.s["recover_metric_depth"]) / n_views,
                       peak_gb=dump_peak_gb, hypothesis_range=hyp_range),
             nerf=dict(steps=PRIOR_NERF_STEPS, command_s=nerf_s, loss_first=losses[0],
                       loss_last=losses[-1], launches_per_step=train.step_launches,
                       scene_load_s=train.load_s[0]),
             checks=checks)
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"prior: failed {bad}")
        return checks
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise
    finally:
        os.chdir(cwd)


def corpus_image(rng, H: int, W: int):
    """One corpus view, as tools/make_prior_corpus.py makes them: a smooth
    depth gradient with 2–4 slanted half-plane walls, each a plane instance,
    and an RGB correlated with both. → rgb uint8, depth (float, > 0),
    planes uint8."""
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    depth = 2.0 + 1.5 * xx + 1.0 * yy
    planes = np.zeros((H, W), np.uint8)
    for pid in range(1, int(rng.integers(2, 5)) + 1):
        a, b = rng.normal(size=2)
        region = (a * (xx - 0.5) + b * (yy - 0.5) + rng.uniform(-0.5, 0.5)) > 0
        slant = 1.0 + 0.8 * rng.random() * xx + 0.8 * rng.random() * yy
        depth = np.where(region, 0.8 + 1.2 * rng.random() * slant, depth)
        planes[region] = pid
    rgb = np.stack([np.clip(50 + 40 * depth + 20 * rng.normal(size=(H, W)), 0, 255),
                    np.clip(30 + 300 * planes.astype(np.float64), 0, 255),
                    np.clip(200 - 30 * depth, 0, 255)], -1).astype(np.uint8)
    return rgb, depth, planes


def write_corpus(root: str, seed: int) -> dict:
    """PRETRAIN_CORPUS in the reference's layout under ``root`` (the layout
    tools/make_prior_corpus.py documents: ``<name>/annotations/
    train_annotations.json`` with ``rgb_path``/``depth_path``/``disp_path``/
    ``ins_planes_path`` relative to ``root``), PNGs written by the port's own
    encoder. taskonomy: uint16 depth below its 28000 invalid mark, plane
    masks; diml_ganet: uint16 disparity only. → bytes written."""
    rng = np.random.default_rng(seed)
    nbytes = 0
    for name, (n, H, W) in PRETRAIN_CORPUS.items():
        os.makedirs(os.path.join(root, name, "annotations"), exist_ok=True)
        os.makedirs(os.path.join(root, name, "imgs"), exist_ok=True)
        annos = []
        for i in range(n):
            rgb, depth, planes = corpus_image(rng, H, W)
            anno = {"rgb_path": f"{name}/imgs/{i}.png"}
            files = [(anno["rgb_path"], rgb)]
            if name == "taskonomy":
                anno["depth_path"] = f"{name}/imgs/{i}_d.png"
                anno["ins_planes_path"] = f"{name}/imgs/{i}_p.png"
                files += [(anno["depth_path"],
                           np.clip(depth / depth.max() * 20000, 1, 27999).astype(np.uint16)),
                          (anno["ins_planes_path"], planes)]
            else:
                disp = 1.0 / depth
                anno["disp_path"] = f"{name}/imgs/{i}_disp.png"
                files.append((anno["disp_path"], (disp / disp.max() * 60000).astype(np.uint16)))
            for rel, img in files:
                path = os.path.join(root, rel)
                (image_io.write_png16 if img.dtype == np.uint16 else image_io.write_png8)(path, img)
                nbytes += os.path.getsize(path)
            annos.append(anno)
        with open(os.path.join(root, name, "annotations", "train_annotations.json"), "w") as f:
            json.dump(annos, f)
    return {"bytes": nbytes}


def pretrain_argv(root: str, seed: int) -> list:
    return ["--dataset", "multi", "--dataroot", root, "--dataset_list", *PRETRAIN_CORPUS,
            "--seed_num", str(seed), "--d_latent", str(PRIOR_D_LATENT)]


def prior_dp_worker(case_path: str, out_dir: str) -> int:
    """One rank of the prior's 2-rank check (torchrun): its block of the
    case's global batch through ``train_step(ranks=...)``, then
    PRETRAIN_DP_TIMED more steps timed. Every rank saves its state after the
    first step, its losses and step times."""
    from scade_tpu_torch.parallel import dist

    ranks, device, backend = dist.init_from_env("cuda")
    try:
        case = torch.load(case_path, weights_only=False)
        cfg = prior_model.backbone_config("resnext101_32x8d", d_latent=PRIOR_D_LATENT)
        m = prior_model.DepthModelCIMLE(cfg, "v2")
        m.load_state_dict(case["state"], strict=True)
        m.to(device)
        tc = prior_train.PriorTrainConfig()
        opt = prior_train.PriorOptimizer(m, tc)
        mine = ranks.block(case["batch"]["rgb"].shape[0])
        batch = prior_train.rows_of({k: v.to(device) for k, v in case["batch"].items()}, mine)
        draws = prior_train.draws_of({k: tuple(t.to(device) for t in v)
                                      for k, v in case["draws"].items()}, mine)
        shifts = {k: v.to(device) for k, v in case["shifts"].items()}
        z = case["z"].to(device)[mine]
        with prior_dump.matmul_precision("highest"):
            total, losses = prior_train.train_step(m, opt, shifts, batch, z, draws, tc, ranks)
            rec = dict(rank=ranks.rank, backend=backend, total=float(total),
                       losses={k: float(v) for k, v in losses.items()})
            torch.save({k: v.detach().cpu() for k, v in m.state_dict().items()},
                       os.path.join(out_dir, f"state{ranks.rank}.pt"))
            step_ms = []
            for _ in range(PRETRAIN_DP_TIMED):
                dist.barrier()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                prior_train.train_step(m, opt, shifts, batch, z, draws, tc, ranks)
                torch.cuda.synchronize(device)
                step_ms.append(1e3 * (time.perf_counter() - t0))
        rec.update(step_ms=step_ms, peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        with open(os.path.join(out_dir, f"rank{ranks.rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy()
    return 0


def phase_prior_dp(tmp: str, seed: int, world: int, batch: dict, state: dict,
                   shifts: dict) -> dict:
    """The prior's data-parallel step on the card: the first step at global
    B=4 over ``world`` ranks (torchrun, this script as each rank's program:
    ``--prior-dp-worker``; NCCL with a card a rank, else gloo on the one
    card) against the 1-rank step and the same step in f64, from ``state``
    with the same z and draws (drawn once on the host). Prints the line
    ``prior_dp``."""
    out_dir = os.path.join(tmp, f"prior_dp{world}")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    B = batch["rgb"].shape[0]
    z = torch.randn((B, PRIOR_D_LATENT), generator=gen)
    draws = prior_losses.draw_criterion(gen, batch, prior_losses.DEFAULT_LOSS_MODE)
    case_path = os.path.join(out_dir, "case.pt")
    torch.save(dict(state=state, batch=batch, z=z, draws=draws, shifts=shifts), case_path)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()), SCRIPT,
           "--prior-dp-worker", case_path, out_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    ranks_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"prior_dp: torchrun exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(world)]
    two, *others = (torch.load(os.path.join(out_dir, f"state{r}.pt")) for r in range(world))
    one = prior_step_on("cuda", state, shifts, batch, z, draws)
    f64 = prior_step_on("cuda", state, shifts, batch, z, draws, torch.float64)
    total = abs(one["losses"]["total_loss"])
    loss_err = max(abs(recs[0]["losses"][k] - v) for k, v in one["losses"].items()) / total

    def update(st):
        return torch.cat([(st[n].double() - state[n].double()).flatten() for n in one["params"]])

    u1, u2, u64 = update(one["state"]), update(two), update(f64["state"])
    dist_f64 = {name: float((u - u64).norm()) for name, u in (("one_rank", u1), ("ranks", u2))}
    bn_err = max((two[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
                 for k, v in one["state"].items() if k.endswith(("running_mean", "running_var")))
    checks = {"ranks report one loss": all(r["losses"] == recs[0]["losses"] for r in recs),
              "ranks hold one state": all(torch.equal(st[k], v) for st in others
                                          for k, v in two.items()),
              "losses = 1 rank's": loss_err <= PRETRAIN_DP_LOSS_REL,
              "BN statistics = 1 rank's": bn_err <= PRETRAIN_DP_BN_REL,
              "update within the f64 witness": dist_f64["ranks"]
              <= PRIOR_STEP_WITNESS_RATIO * dist_f64["one_rank"]}
    line("prior_dp", world=world, backend=recs[0]["backend"], global_batch=B, crop=448,
         ranks_command_s=ranks_s, ms_per_step_per_rank={r["rank"]: r["step_ms"] for r in recs},
         peak_gb_per_rank={r["rank"]: r["peak_gb"] for r in recs},
         losses_ranks=recs[0]["losses"], losses_one_rank=one["losses"],
         losses_f64=f64["losses"], loss_max_err_rel_to_total=loss_err, bn_max_rel_err=bn_err,
         update_l2_f64=float(u64.norm()), update_distance_from_f64=dist_f64,
         ranks_vs_one_rank_update_max=float((u2 - u1).abs().max()),
         tol=dict(loss_rel_to_total=PRETRAIN_DP_LOSS_REL, bn_rel=PRETRAIN_DP_BN_REL,
                  update_witness_ratio=PRIOR_STEP_WITNESS_RATIO), checks=checks)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"prior_dp: failed {bad}: update's L2 distance from f64 {dist_f64}, "
                           f"loss error {loss_err:.3g}, BatchNorm error {bn_err:.3g}")
    return checks


def pretrain_batch(root: str, seed: int) -> dict:
    """The first global batch of 4 of the trainer's order, as the CLI reads
    it, on the host."""
    args = prior_train.parse_args(pretrain_argv(root, seed) + PRETRAIN_ARGS + ["--device", "cpu"])
    _, batches, _, _ = prior_train._multi_input(args, "cpu")
    return next(batches(4))


def baseline_check(batch: dict, seed: int) -> dict:
    """``DepthModelBaseline`` (ResNeXt101-32x8d + AuxiNetV2) at the 448 crop
    from seeded weights: the card's f32 forward (TF32 off) against the
    CPU's on one image, both outputs; then a train-mode forward and backward
    of ``criterion`` + ``auxi_criterion`` at B=4, its ms and peak GB."""
    cfg = prior_model.backbone_config("resnext101_32x8d", d_latent=PRIOR_D_LATENT)
    m = prior_model.init_weights_(prior_model.DepthModelBaseline(cfg, "v2"),
                                  torch.Generator().manual_seed(seed))
    x = batch["rgb"][:1]
    m.eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = m(x)
    cpu_s = time.perf_counter() - t0
    m.cuda()
    dev = {k: v.cuda() for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = prior_losses.draw_criterion(gen, dev, AUXI_LOSS_MODE)
    auxi_draws = prior_losses.draw_auxi_criterion(gen, dev, AUXI_LOSS_MODE)
    with prior_dump.matmul_precision("highest"):
        with torch.no_grad():
            card = m(x.cuda())
        errs = {name: float((c.cpu() - r).abs().max() / r.abs().max())
                for name, c, r in zip(("depth", "auxi"), card, cpu)}
        m.train()

        def step():
            depth, auxi = m(dev["rgb"])
            _, total = prior_losses.criterion(depth, dev, AUXI_LOSS_MODE, draws)
            _, auxi_total = prior_losses.auxi_criterion(auxi, dev, AUXI_LOSS_MODE, auxi_draws)
            (total + auxi_total).mean().backward()
            return total, auxi_total

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        total, auxi_total = step()
        ms = cuda_ms(step, reps=3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(total).all() and torch.isfinite(auxi_total).all()
                  and all(torch.isfinite(p.grad).all() for p in m.parameters()))
    total, auxi_total = total.detach(), auxi_total.detach()
    return dict(params=sum(p.numel() for p in m.parameters()), f32_vs_cpu_rel=errs, cpu_s=cpu_s,
                train_fwd_bwd_ms_b4=ms, peak_gb=peak_gb, finite=finite,
                loss_b4=float(total.mean()), auxi_loss_b4=float(auxi_total.mean()))


def phase_prior_pretrain(tmp: str, seed: int) -> dict:
    """The depth prior's pretraining path, as a user runs it: a two-source
    corpus (PRETRAIN_CORPUS) written to ``tmp``, then
    ``python -m scade_tpu_torch.prior.train --dataset multi`` for one epoch
    of the full-width ResNeXt101-32x8d v2 model (d_latent 32, 448 crop, the
    five-loss default, fresh seeded weights, f32 without TF32): the AdaIn
    init over 8 examples, a recache of 20 z for each of the 16 examples of
    the sampler's order, 4 SGD steps at batch 4. It must write finite AdaIn
    statistics, cache a finite (16, 32) z, log 4 finite steps and a
    checkpoint, and visit the sources round-robin. Times: the command, each
    step, the recache per image, the host's read per example (decode and
    resize, ``MultiDataset.load_test_data_v2``) against a step; peak GB.
    Then, from the checkpoint it wrote, the 2-rank check (``phase_prior_dp``)
    and the baseline model (``baseline_check``)."""
    log = io.StringIO()
    t_phase = time.perf_counter()
    try:
        from scade_tpu_torch.prior import multi_data

        root = os.path.join(tmp, "corpus")
        t0 = time.perf_counter()
        corpus = write_corpus(root, seed)
        corpus_s = time.perf_counter() - t0
        log_dir, jsonl = os.path.join(tmp, "pretrain_log"), os.path.join(tmp, "pretrain.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        names = ("compute_adain_stats", "recache_z", "train_step")
        with TimeProbe(prior_train, names, sync=True) as probe, \
                TimeProbe(multi_data.MultiDataset, ("load_test_data_v2",)) as reads, \
                contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            out = prior_train.main([*pretrain_argv(root, seed), "--log_dir", log_dir,
                                    *PRETRAIN_ARGS, "--precision", "highest",
                                    "--loss_jsonl", jsonl])
            command_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n = 2 * int(max(v[0] for v in PRETRAIN_CORPUS.values()) * PRETRAIN_SAMPLE_RATIO)
        steps = n // 4
        mv = np.load(os.path.join(log_dir, "mean_var_adain.npy"), allow_pickle=True).item()
        recs = [json.loads(x) for x in open(jsonl).read().splitlines()]
        order = out["order"]["source"]
        counts = {name: order.count(name) for name in PRETRAIN_CORPUS}
        ckpt = os.path.join(log_dir, "epoch0_step0.pth")
        shifts = {k: v.cpu() for k, v in out["shifts"].items()}
        checks = {"AdaIn statistics finite": len(mv) == 8 and all(np.isfinite(v).all()
                                                                 for v in mv.values()),
                  f"cached z ({n}, 32), finite": out["z"].shape == (n, PRIOR_D_LATENT)
                  and bool(np.isfinite(out["z"]).all()),
                  f"{steps} finite steps": len(recs) == steps and all(
                      math.isfinite(v) for r in recs for v in r.values()),
                  "checkpoint written": os.path.exists(ckpt),
                  "round-robin order": order[0::2] == ["taskonomy"] * (n // 2)
                  and order[1::2] == ["diml_ganet"] * (n // 2)}
        read_s = reads.s["load_test_data_v2"]
        step_ms = [1e3 * v for v in probe.s["train_step"]]
        del out
        torch.cuda.empty_cache()

        batch = pretrain_batch(root, seed)
        state = torch.load(ckpt)["model_state_dict"]
        dp = phase_prior_dp(tmp, seed, 2, batch, state, shifts)
        del state
        torch.cuda.empty_cache()
        base = baseline_check(batch, seed)
        torch.cuda.empty_cache()
        checks.update({"2-rank step = 1-rank step": all(dp.values()),
                       "baseline card f32 against CPU f32": max(base["f32_vs_cpu_rel"].values())
                       <= PRIOR_F32_TOL,
                       "baseline losses and grads finite": base["finite"]})
        line("prior_pretrain", backbone="resnext101_32x8d", version="v2",
             d_latent=PRIOR_D_LATENT, crop=448, corpus={k: list(v) for k, v in
                                                        PRETRAIN_CORPUS.items()},
             corpus_bytes=corpus["bytes"], corpus_write_s=corpus_s, examples=n,
             argv=PRETRAIN_ARGS, command_s=command_s, cli_step_ms=step_ms,
             ms_per_step_median=statistics.median(step_ms),
             adain_s_per_image=probe.s["compute_adain_stats"][0] / 8,
             recache_s_per_image=probe.s["recache_z"][0] / n,
             host_read_s_per_example=dict(median=statistics.median(read_s), max=max(read_s),
                                          n=len(read_s)),
             host_read_s_per_step_b4=4 * statistics.median(read_s), peak_gb=peak_gb,
             first_batches_sources=[order[i:i + 4] for i in (0, 4)], sources_visited=counts,
             losses_first_step=recs[0], baseline=base,
             phase_s=time.perf_counter() - t_phase, checks=checks)
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"prior_pretrain: failed {bad}")
        return checks
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise


def phase_quality(seeds=QUALITY_SEEDS, dtypes=("float32", "bfloat16"), extra=(),
                  repeat: bool = True) -> dict:
    """The port's trained NeRF against the JAX package's and the upstream
    oracle's (see QUALITY_SCENE): the scene written by
    tools/make_synthetic_scene.py, then per dtype and seed the CLI's
    ``train`` for 4,000 steps (cli.main, as ``python -m scade_tpu_torch
    train`` runs it, with QUALITY_ARGS and ``extra``) and ``test`` on its
    .tar; with ``repeat`` the first run once more. Fails unless every run
    has finite losses, its launches per step, RMSE and PSNR inside the bar,
    train and test metrics.txt agree, and the repeat's .tar equals the
    first run's."""
    tmp = tempfile.mkdtemp(prefix="scade_quality_")
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        subprocess.run([sys.executable, os.path.join(os.path.dirname(SCRIPT), "tools",
                                                     "make_synthetic_scene.py"),
                        os.path.join(tmp, "scene"), *QUALITY_SCENE],
                       check=True, capture_output=True, timeout=600)
        os.chdir(tmp)
        runs = [(dt, sd, f"q_{dt}_s{sd}") for dt in dtypes for sd in seeds]
        if repeat:
            runs.append((*runs[0][:2], runs[0][2] + "_again"))
        res = {}
        for dt, sd, name in runs:
            argv = ["--data_dir", tmp, "--scene_id", "scene", "--ckpt_dir", "ckpt",
                    "--expname", name, "--seed", str(sd), "--compute_dtype", dt, *QUALITY_ARGS,
                    *extra]
            with CliProbe() as train, contextlib.redirect_stdout(log):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                cli.main("scannet", ["train", *argv])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            result = os.path.join("ckpt", name, "test_images_scene", "metrics.txt")
            train_metrics = read_metrics(result)
            with contextlib.redirect_stdout(log):
                cli.main("scannet", ["test", *argv])
                torch.cuda.synchronize()
            m = read_metrics(result)
            losses = torch.stack([torch.as_tensor(x).float().cpu() for x in train.losses])
            steps = len(train.step_launches)
            res[name] = dict(
                dtype=dt, seed=sd, steps=steps, psnr=m["psnr"], psnr0=m["psnr0"],
                depth_rmse=m["depth_rmse"], ssim=m["ssim"], train_command_s=train_s,
                loop_ms_per_step_median=statistics.median(train.step_ms()),
                loss_first=losses[0].item(), loss_last=losses[-1].item(),
                finite=bool(torch.isfinite(losses).all()),
                launches_per_step_ok=all(d == per_step() for d in train.step_launches),
                metrics_agree=metrics_agree(train_metrics, m))
            r = res[name]
            r["ok"] = (r["finite"] and steps == 4000 and r["launches_per_step_ok"]
                       and r["metrics_agree"] and QUALITY_RMSE[0] <= r["depth_rmse"]
                       <= QUALITY_RMSE[1] and r["psnr"] >= QUALITY_PSNR)
        same = None if not repeat else tars_equal(
            os.path.join("ckpt", runs[0][2], "004000.tar"),
            os.path.join("ckpt", runs[-1][2], "004000.tar"))
        ok = same is not False and all(r["ok"] for r in res.values())
        line("quality", scene=QUALITY_SCENE, argv=[*QUALITY_ARGS, *extra], bar=dict(
            depth_rmse=QUALITY_RMSE, psnr_min=QUALITY_PSNR), runs=res,
             repeat_tar_bit_equal=same, ok=ok)
        if not ok:
            raise RuntimeError("quality: a run misses the bar or the repeat differs")
        return res
    except Exception:
        sys.stderr.write(log.getvalue()[-20000:])
        raise
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_prior_paths(seed: int) -> None:
    """prior_train, then prior on what it wrote, in one temporary scene;
    then prior_pretrain in another."""
    tmp = tempfile.mkdtemp(prefix="scade_prior_")
    try:
        trained = phase_prior_train(tmp, seed)
        torch.cuda.empty_cache()
        phase_prior(tmp, seed, trained)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="scade_pretrain_")
    try:
        phase_prior_pretrain(tmp, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of the dp phase (torchrun)
        return dp_worker(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--prior-dp-worker"]:  # one rank of the prior_dp check (torchrun)
        return prior_dp_worker(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--tp-worker"]:  # one rank of the tp phase (torchrun)
        return tp_worker(sys.argv[2], int(sys.argv[3]))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--k1-only", action="store_true",
                        help="run the device and k1 phases only and print no result line: "
                             "for comparing K1 builds of two trees on one card")
    parser.add_argument("--k2-only", action="store_true",
                        help="run the device and k2 phases only and print no result line: "
                             "for comparing K2 builds of two trees on one card")
    parser.add_argument("--prior-only", action="store_true",
                        help="run the device phase, then the prior_train, prior and "
                             "prior_pretrain phases, and print no result line: for the prior's "
                             "paths alone")
    parser.add_argument("--prior-dp-repeat", type=int, default=0, metavar="N",
                        help="run the device phase, then the prior_pretrain phase N times "
                             "(each a fresh pretraining run and its 2-rank check), and print "
                             "no result line: for the spread of line prior_dp's distances")
    parser.add_argument("--quality-only", action="store_true",
                        help="run the device phase, then train and score the port on "
                             "BASELINE.md round 5's scene (4 runs of 4,000 steps and a "
                             "repeat), and print no result line")
    parser.add_argument("--dp-only", type=int, default=0, metavar="N",
                        help="run the device phase, then the dp phase on N ranks on a "
                             "freshly written scene, for even N the tp phase (N/2 x 2), and the "
                             "prior's step over N ranks, and print no result line: for data and "
                             "model parallelism over N cards (NCCL)")
    args = parser.parse_args()
    if args.dp_only and 4 % args.dp_only:
        parser.error(f"--dp-only {args.dp_only}: N must divide the prior's global batch of 4")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed)

    dev = phase_device()
    if args.dp_only:
        tmp = tempfile.mkdtemp(prefix="scade_dp_")
        try:
            write_scene(tmp, args.seed)
            phase_dp(tmp, args.seed, args.dp_only)
            if args.dp_only % TP_N_MODEL == 0:
                phase_tp(args.seed, args.dp_only)
            # the prior's step over the N cards, from fresh seeded weights
            write_corpus(os.path.join(tmp, "corpus"), args.seed)
            cfg = prior_model.backbone_config("resnext101_32x8d", d_latent=PRIOR_D_LATENT)
            model = prior_model.init_weights_(prior_model.DepthModelCIMLE(cfg, "v2"),
                                              torch.Generator().manual_seed(args.seed),
                                              random_stats=False)
            phase_prior_dp(tmp, args.seed, args.dp_only,
                           pretrain_batch(os.path.join(tmp, "corpus"), args.seed),
                           model.state_dict(), prior_model.zero_shifts_for(model))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if args.prior_only:
        phase_prior_paths(args.seed)
        return 0
    for _ in range(args.prior_dp_repeat):
        tmp = tempfile.mkdtemp(prefix="scade_pretrain_")
        try:
            phase_prior_pretrain(tmp, args.seed)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if args.prior_dp_repeat:
        return 0
    if args.quality_only:
        phase_quality()
        return 0
    if args.k2_only:
        phase_k2(gen)
        return 0
    k1 = phase_k1(gen, dev["sass"])
    if args.k1_only:
        return 0
    k2 = phase_k2(gen)
    state, scene, rc, tc, train_launches, train_median_ms = phase_train(args.seed, args.steps)
    phase_split(state, scene, rc, tc, args.seed)
    phase_repro(state, scene, tc, args.seed)
    phase_check(state, scene, rc)
    phase_render(state, scene)
    del state, scene
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="scade_cli_")
    try:
        cli_launches, test_metrics = phase_cli(tmp, args.seed, train_median_ms)
        torch.cuda.empty_cache()
        phase_tasks(tmp, args.seed, test_metrics)
        torch.cuda.empty_cache()
        phase_wild(tmp, args.seed)
        torch.cuda.empty_cache()
        phase_dp(tmp, args.seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    tp = phase_tp(args.seed)
    torch.cuda.empty_cache()
    phase_spvcnn(args.seed)
    torch.cuda.empty_cache()
    phase_prior_paths(args.seed)
    tp_launches = {k: sum(d[k] for d in tp["launches"]) for k in ("k1", "k2", "k2_bwd")}

    # launches: the CLI's train run (20 steps and 6 rendered views), the main
    # path as a user drives it; launches_tp_phase: rank 0's in the tp phase's
    # DP_STEPS steps on the model axis; launches_train_phase: the bare train phase's
    kernels = [
        dict(name="fused_mlp", route="cuda", source="scade_tpu_torch/csrc/fused_mlp.cu",
             replaces="scade_tpu/ops/fused_mlp.py:187", launches=cli_launches["k1"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None, check="pass",
             launches_train_phase=train_launches["k1"], launches_tp_phase=tp_launches["k1"],
             max_abs_err_bf16=k1["max_abs_err_bf16"], fma_bound_ms=k1["fma_bound_ms"]),
        dict(name="fused_mlp_bwd", route="cuda", source="scade_tpu_torch/csrc/fused_mlp.cu",
             replaces="scade_tpu/ops/fused_mlp.py:265", launches=train_launches["k1_bwd"],
             max_rel_err_vs_f64=k1["backward"]["max_rel_err_vs_f64"], ms=k1["backward"]["ms"],
             plain_ms=k1["backward"]["plain_ms"], bound_ms=k1["backward"]["bound_ms"],
             bound_by="operations", library_ms=None, check="pass"),
        dict(name="sample_pdf", route="cuda",
             source="scade_tpu_torch/csrc/fused_sampling.cu",
             replaces="scade_tpu/ops/fused_sampling.py:110", launches=cli_launches["k2"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None, check="pass",
             launches_train_phase=train_launches["k2"], launches_tp_phase=tp_launches["k2"],
             wall_ms=k2["wall_ms"]),
        dict(name="sample_pdf_bwd", route="cuda",
             source="scade_tpu_torch/csrc/fused_sampling.cu",
             replaces="scade_tpu/ops/fused_sampling.py:172", launches=cli_launches["k2_bwd"],
             max_abs_err=k2["bwd"]["max_abs_err"], ms=k2["bwd"]["ms"],
             plain_ms=k2["bwd"]["plain_ms"], bound_ms=k2["bwd"]["bound_ms"],
             bound_by=k2["bwd"]["bound_by"], library_ms=None, check="pass",
             launches_train_phase=train_launches["k2_bwd"],
             launches_tp_phase=tp_launches["k2_bwd"], wall_ms=k2["bwd"]["wall_ms"],
             ms_peaked=k2["bwd"]["ms_peaked"],
             rel_err_vs_autograd_dyadic=k2["bwd"]["rel_err_vs_autograd_dyadic"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
