#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (scade_tpu_torch) on one NVIDIA card and checks it.

    python3 chip_smoke.py [--seed N] [--steps N] [--k1-only | --dp-only N]

Builds the CUDA kernels from scade_tpu_torch/csrc/ (one nvcc per source, all
at once), then prints one line per phase (with --k1-only the first two, for
comparing K1 builds of two trees on one card):

  device  card name and power limit (nvidia-smi), build time, K1's registers
          and spills (ptxas) and its tensor-core instructions (cuobjdump
          -sass: HMMA.16816.F32.BF16 and HMMA.1688.F32.TF32, none is a fault)
  k1      the fused PE + MLP kernel, through its wrapper, against its plain
          version at the main path's launch shapes (D=8, W=256, F=9): a train
          step's 65,536 coarse and 196,608 fine points and a render chunk's
          1,048,576 and 3,145,728, each in f32 and bf16, the weights' packing
          included; in bf16 also the plain version against itself with its
          sums reordered, and both against the same function summed in f64
  k2      the sampling kernel (CDF build + inverse-CDF lookup) at 1,024,
          16,384 and 65,536 rays, M=63 and M=191, S=128, with draws of
          exactly 0 and 1: exact against the plain lookup of the CDF summed
          in its order and on dyadic weights, and against the plain
          sample_pdf within that version's own distance from f64 sums; its
          device and wall times; one forward call must run one kernel
  train   the reference-default train step (64+128 samples, 8x256, N_rand
          1024, f32) on a seeded scene shaped like a SCADE ScanNet scene:
          18 train + 2 val views at 468x624, K=20 hypotheses
  split   where a train step's time goes (forward, backward, Adam), and the
          step with both kernels off (their plain versions)
  check   render_rays through the kernels against the plain path, 512 rays
  render  a full 468x624 val view through render_image, f32 and bf16
  cli     the port's CLI as a user runs it (python -m scade_tpu_torch): a
          ScanNet-shaped scene written to a temporary directory (18 train + 2
          val + 2 test views at 468x624, PNGs, K=20 .npy hypotheses, 6 video
          poses), then `train` for 20 steps at the reference defaults with
          .tar files at 10 and 20 and the i_img renders at 20, then `test`;
          K1 and K2 must launch 2 per step and 36 per view, the .tar reload
          bit-equal, the two metrics.txt agree, and the hypotheses load
          through the native library (`train`) and then from its blob (`test`)
  tasks   on the cli phase's scene and run: `test_opt` (its metrics those of
          `test`), `video` (2 frames of 468x276, 16 K1 + 16 K2 launches a
          frame, a file that decodes to 2 frames), then `train --input_ch_cam
          4` for 5 steps (0 K1 + 2 K2 a step) and `test_opt` fitting a camera
          latent per test view (2 finite latent files)
  wild    `python -m scade_tpu_torch.wild train --mask_edges true` on the
          scene read as a processed (wild) scene, 10 steps, then wild `test`
  dp      data parallelism: `train --multihost` on 2 ranks (torchrun; NCCL
          with a card a rank, else gloo on the one card) for 5 steps, held to
          1 rank run twice (the card's run-to-run spread is the witness: the
          first step's loss and gradients, the parameters' median distance),
          the ranks' parameters bit-equal, then a sharded `test` against 1 rank
  prior   the depth prior's inference path: the full-width ResNeXt101-32x8d
          cIMLE model (seeded weights, saved as a reference-format .pth and
          loaded back) at the 448 crop, the card's f32 against the CPU's and
          bf16 against f32, forward times and the FLOP bound; then
          `python -m scade_tpu_torch.prior.dump` on the cli phase's kind of
          scene (360 hypotheses, K=20, bf16) and the CLI's `train` for 5 steps
          on what it wrote, K1 and K2 at 2 launches a step

then the kernels line (one JSON object per kernel: launches in the cli
phase's train run, error, times and bound), the card's name and power limit, and last
a JSON line naming the device. Exits non-zero, with no result line, when
there is no CUDA device or any phase fails. Needs one card. With --dp-only N
it runs the device phase and then the dp phase on N ranks (NCCL where there
are N cards) and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
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
from unittest import mock

import numpy as np
import torch

from scade_tpu_torch import _kernels, cli, wild
from scade_tpu_torch.data import image_io
from scade_tpu_torch.data import scene as scene_io
from scade_tpu_torch.eval import evaluate
from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.ops import fused_mlp, fused_sampling, sampling
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.prior import data as prior_data
from scade_tpu_torch.prior import dump as prior_dump
from scade_tpu_torch.prior import model as prior_model
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
# K2 exactly (atol, rtol) where the order of the CDF's sums cannot matter:
# against the plain lookup of the CDF summed in the kernel's order
# (fused_sampling.cdf_kernel_order) and on dyadic weights. Against the plain
# sample_pdf on random weights the two CDFs differ by f32 ulps (another
# order of sums than torch.cumsum's), which the lookup multiplies by bin
# width / CDF gap, the gap down to 1e-5. There the kernel is held to the
# plain version's own distance from the same function computed in f64, in
# the same run: its share of draws within K2_WITNESS at most K2_SHARE_SLACK
# below the plain version's, and its CDF's largest distance from the f64 CDF
# at most K2_CDF_RATIO times the plain CDF's. The largest distance of a draw
# is printed for both but bounds neither: at the 1e-5 guard the function
# jumps (an interval with a CDF gap under 1e-5 maps to its lower bin), so
# an ulp of the CDF moves a draw that lies near such a gap by up to a bin
# width, in either version, at draws that differ between them.
K2_TOL = (2e-6, 1e-6)
K2_WITNESS, K2_SHARE_SLACK, K2_CDF_RATIO = 1e-5, 0.001, 2.0
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
# Video poses in write_scene's scene: the video task renders every 3rd.
N_VIDEO = 6
# Two runs of one program on the card agree in metrics.txt to this, relative
# (a render is deterministic; only training is not).
METRICS_REL = 1e-6
# The dp phase: 2 ranks against 1, each train run this many steps. Training on
# the card is not bit-reproducible from run to run (atomics in the backward),
# so the 2-rank run is held to the larger of DP_SPREAD_RATIO times the
# distance between two 1-rank runs and DP_REL of the magnitude: the first
# step's loss and the first step's gradients, summed over the ranks (all runs
# start from the same parameters on the same batch, so only the order of the
# sums differs; Adam is blind to the gradients' scale, so only they show a
# wrong 1/world), and the parameters after DP_STEPS steps by the median of
# their distances. Not by the largest: Adam moves a parameter by about lr
# whatever its gradient's size, so a gradient near zero whose sign an f32
# reordering flips moves it by ~2 lr = 1e-3 in one run against the other.
# Such flips come from the atomics in one rank's backward and, in 2 ranks,
# from every sum over the batch taken in two halves; their largest distance
# is a count of flips, not an error. The later steps' losses drift apart for
# the same reason and are printed, not held.
DP_STEPS, DP_SPREAD_RATIO, DP_REL = 5, 2.0, 1e-5
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
    hmma = k1_tensor_core_instructions()
    line("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=round(build_s, 3), build_s_per_source=per_source, k1_sass_hmma=hmma,
         k1_ptxas=k1_ptxas())
    if not all(hmma.values()):
        raise RuntimeError(f"device: K1 has no tensor-core instruction of some kind: {hmma}")
    return {"smi": smi, "hmma": hmma}


def k1_tensor_core_instructions() -> dict:
    """Counts K1's tensor-core instructions in the built library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_kernels.library_path("fused_mlp"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return {op: sass.count(op) for op in ("HMMA.16816.F32.BF16", "HMMA.1688.F32.TF32")}


def k1_ptxas() -> dict:
    """Registers, stack and spills of each K1 instantiation, from the build log."""
    res, name = {}, None
    for text in (_kernels.BUILD / "fused_mlp.log").read_text().splitlines():
        m = re.search(r"fused_mlp_kernelI(13__nv_bfloat16|f)Li(\d+)E", text)
        if "Function properties for" in text and m:
            name = f"{'bf16' if m.group(1) != 'f' else 'f32'}_W{m.group(2)}"
            res[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)):
            res[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", text)):
            res[name]["registers"] = int(m.group(1))
            name = None
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


def phase_k1(gen: torch.Generator, hmma: dict) -> dict:
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
        packed_bytes = {name: fused_mlp.pack_weights(weights, cfg, dt).nbytes
                        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
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
                tflops=flops / ms / 1e9,
                # every 128-point tile reads all packed weights from L2
                l2_weight_bytes=-(-n // 128) * packed_bytes[dname])
            if dt == torch.float32:
                entry["fma_bound_ms"] = flops / PEAK_F32 * 1e3
            res[f"{key}_{dname}"] = entry
        del pts, dirs
        torch.cuda.empty_cache()
    line("k1", D=nc.D, W=nc.W, F=rc.embed_pos.num_freqs, mflop_per_point=flop_per_point / 1e6,
         tol=dict(f32=K1_TOL, bf16=dict(point=K1_TOL, share_slack=K1_BF16_SHARE_SLACK,
                                        max_ratio=K1_BF16_MAX_RATIO, median=K1_BF16_MEDIAN)),
         sass_hmma=hmma, pack_ms=pack_ms, **res)
    bad = [k for k, r in res.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"k1: kernel disagrees with its plain version at {bad}")
    step = [res["train_coarse_f32"], res["train_fine_f32"]]  # one train step's two launches
    return dict(max_abs_err=max(r["max_abs_err"] for k, r in res.items() if k.endswith("f32")),
                max_abs_err_bf16=max(r["max_abs_err"] for k, r in res.items()
                                     if k.endswith("bf16")),
                ms=sum(s["kernel_ms"] for s in step), plain_ms=sum(s["plain_ms"] for s in step),
                bound_ms=sum(s["bound_ms"] for s in step), bound_by=step[1]["bound_by"],
                fma_bound_ms=sum(s["fma_bound_ms"] for s in step))


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


def k2_witness(bins, w, u, got) -> dict:
    """The K2 bound on random weights (see K2_WITNESS): the kernel's and the
    plain version's distances from sample_pdf computed in f64, per draw and
    for the CDF (the kernel's is cdf_kernel_order, whose lookup it matches
    exactly), the CDFs' in units of 2^-24."""
    cdf64 = sampling._cdf_from_weights(w.double())
    oracle = sampling.lookup(cdf64, bins.double(), u.double())
    plain = sampling.sample_pdf(bins, w, u)
    ek, ep = (got.double() - oracle).abs(), (plain.double() - oracle).abs()
    res = dict(kernel_max=ek.max().item(), plain_max=ep.max().item(),
               kernel_share=(ek <= K2_WITNESS).double().mean().item(),
               plain_share=(ep <= K2_WITNESS).double().mean().item(),
               kernel_vs_plain_max=(got - plain).abs().max().item(),
               cdf_kernel_ulps=(fused_sampling.cdf_kernel_order(w).double() - cdf64).abs().max()
               .item() * 2**24,
               cdf_plain_ulps=(sampling._cdf_from_weights(w).double() - cdf64).abs().max().item()
               * 2**24)
    res["ok"] = (res["kernel_share"] >= res["plain_share"] - K2_SHARE_SLACK
                 and res["cdf_kernel_ulps"] <= K2_CDF_RATIO * res["cdf_plain_ulps"])
    return res


def phase_k2(gen: torch.Generator) -> dict:
    """K2 through its launcher at every shape of the main path (a train
    step's 1,024 rays, a render chunk's 16,384 with broadcast draws, and
    65,536), at the fine resampling's M=63 and the P_depth draws' M=191,
    S=128: exact where the order of the CDF's sums cannot matter, and within
    the plain version's own distance from an f64 oracle on random weights.
    Times: the kernel's device µs (CUDA graph), the wall µs of a call of
    fused_sample_pdf (host included) and of its launcher alone, and events
    around back-to-back calls (which read the host wherever it is the
    slower side); the plain sample_pdf; the bytes bound. Then the
    device operations one forward call runs."""
    S = 128
    shapes = {}
    ok = True
    for R in (1024, RENDER_CHUNK, 65536):
        for M in (63, 191):
            bins, w, u, dyadic = k2_inputs(gen, R, M, S)
            got = fused_sampling.sample_pdf_cuda(bins, w, u)
            kernel_order = sampling.lookup(fused_sampling.cdf_kernel_order(w), bins, u)
            err = (got - kernel_order).abs().max().item()
            exact = bool(torch.allclose(got, kernel_order, atol=K2_TOL[0], rtol=K2_TOL[1]))
            got_d = fused_sampling.sample_pdf_cuda(bins, dyadic, u)
            plain_d = sampling.sample_pdf(bins, dyadic, u)
            err_d = (got_d - plain_d).abs().max().item()
            exact_d = bool(torch.allclose(got_d, plain_d, atol=K2_TOL[0], rtol=K2_TOL[1]))
            copies = bool(torch.equal(got, fused_sampling.sample_pdf_cuda(
                bins, w.contiguous(), u.contiguous())))
            witness = k2_witness(bins, w, u, got)
            finite = bool(torch.isfinite(got).all())
            del got, kernel_order, got_d, plain_d
            shape_ok = exact and exact_d and copies and witness["ok"] and finite
            ok = ok and shape_ok
            device_us = graph_us(lambda: fused_sampling.sample_pdf_cuda(bins, w, u))
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
                ok=shape_ok, u_row_stride=u.stride(0), max_abs_err=err, max_abs_err_dyadic=err_d,
                strided_equals_copies=copies, vs_f64=witness, device_us=device_us,
                wall_us=call_us, launcher_wall_us=launcher_us, events_us=events_us,
                plain_ms=plain_ms,
                bound_ms=max(nbytes / HBM_BYTES, ops / PEAK_F32) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES >= ops / PEAK_F32 else "operations")
            del bins, w, u, dyadic
    # one forward call at a train step's 1,024 rays, from the views the
    # renderer passes (weights needing a gradient, as at the P_depth site)
    bins, _, u, _ = k2_inputs(gen, 1024, 191, S)
    w = torch.rand(1024, 192, generator=gen).to("cuda").requires_grad_(True)[:, 1:-1]
    ub = u[:1].expand(1024, S)
    ops_kernel = device_ops(lambda: fused_sampling.fused_sample_pdf(bins, w, ub))
    ops_plain = device_ops(lambda: sampling.sample_pdf(bins, w, ub))
    one_kernel = len(ops_kernel) == 1
    line("k2", S=S, tol=dict(atol=K2_TOL[0], rtol=K2_TOL[1], within=K2_WITNESS,
                             share_slack=K2_SHARE_SLACK, cdf_ratio=K2_CDF_RATIO),
         device_ops_per_call=ops_kernel, plain_device_ops_per_call=len(ops_plain), **shapes)
    if not ok:
        raise RuntimeError("k2: kernel disagrees with its plain versions")
    if not one_kernel:
        raise RuntimeError(f"k2: one forward call ran {ops_kernel} on the device, not one kernel")
    step = [shapes["R1024_M63"], shapes["R1024_M191"]]  # one train step's two launches
    return dict(max_abs_err=max(s["max_abs_err"] for s in shapes.values()),
                max_abs_err_vs_sample_pdf=max(s["vs_f64"]["kernel_vs_plain_max"]
                                              for s in shapes.values()),
                ms=sum(s["device_us"] for s in step) / 1e3,
                wall_ms=sum(s["wall_us"] for s in step) / 1e3,
                plain_ms=sum(s["plain_ms"] for s in step),
                bound_ms=sum(s["bound_ms"] for s in step), bound_by=step[1]["bound_by"])


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
    fused_sampling.sample_pdf_cuda.launches = 0


def counts() -> dict:
    return {"k1": fused_mlp.fused_mlp_cuda.launches,
            "k2": fused_sampling.sample_pdf_cuda.launches}


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
    per_step_ok = launches == {"k1": 2 * steps, "k2": 2 * steps}
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
              and counts() == {"k1": 2 * chunks, "k2": 2 * chunks})
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
    views), then ``test`` from the newest .tar. Everything goes to ``tmp``
    (the TB root is relative to the working directory, so the phase runs
    there), which the later phases reuse. Fails unless K1 and K2 launch 2
    per step and 36 per view, the losses are finite, the .tar reloads to the
    trained parameters and Adam state exactly, both metrics.txt agree, i_img
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

        chunks = -(-H * W // RENDER_CHUNK)
        per_view = {"k1": 2 * chunks, "k2": 2 * chunks}
        steps_ok = len(train.step_launches) == 20 and all(
            d == {"k1": 2, "k2": 2} for d in train.step_launches)
        views_ok = (len(train.view_launches) == 6 and len(test.view_launches) == 2
                    and all(d == per_view for d in train.view_launches + test.view_launches)
                    and train_launches == {k: 2 * 20 + 6 * per_view[k] for k in per_view}
                    and test_launches == {k: 2 * per_view[k] for k in per_view})
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
             metrics_train=train_metrics, metrics_test=test_metrics, metrics_agree=agree,
             metrics_finite=finite_metrics, tb_entries_ok=tb_ok, result_files=files,
             cv2_installed=image_io.jpeg_available(), hypothesis_load=hyp_load,
             hypothesis_load_native=native)
        bad = [name for name, ok in (("launches per step", steps_ok),
                                     ("launches per view", views_ok), ("finite losses", finite),
                                     (".tar reload", tar_ok), ("metrics.txt agree", agree),
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

        per_view = {"k1": 2 * (-(-H * W // RENDER_CHUNK)), "k2": 2 * (-(-H * W // RENDER_CHUNK))}
        per_frame = {"k1": 2 * chunks_per_frame, "k2": 2 * chunks_per_frame}
        checks = {
            "test_opt metrics equal test's": metrics_agree(opt_metrics, test_metrics),
            "test_opt launches": opt_launches == {k: N_TEST * v for k, v in per_view.items()},
            "video frames": frames == ["0.jpg", "3.jpg"] and decoded == 2,
            "video launches per frame": (len(vid.view_launches) == 2 and all(
                d == per_frame for d in vid.view_launches) and video_launches["k1"] > 0),
            "latent train launches per step": len(cam_train.step_launches) == 5 and all(
                d == {"k1": 0, "k2": 2} for d in cam_train.step_launches),
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
        per_view = 2 * (-(-H * W // RENDER_CHUNK))
        checks = {
            "launches per step": len(train.step_launches) == 10 and all(
                d == {"k1": 2, "k2": 2} for d in train.step_launches),
            "finite losses": all(math.isfinite(v) for v in losses),
            "edge mask and masked RGB loss": tc.mask_edges and tc.mask_rgb,
            "runs_prior_corrected scalars": os.path.exists(scalars),
            "test launches": test_launches == {"k1": N_TEST * per_view, "k2": N_TEST * per_view},
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


def abs_diffs(a: dict, b: dict) -> torch.Tensor:
    return torch.cat([(a[k] - b[k]).abs().flatten() for k in a])


def phase_dp(tmp: str, seed: int, world: int = 2) -> dict:
    """Data parallelism on the cli phase's scene: ``train --multihost`` on
    ``world`` ranks for DP_STEPS steps at the reference defaults (N_rand 1024,
    1024 / world rays a rank) against 1 rank run twice in the same phase (the witness: training
    on the card is not bit-reproducible; see DP_STEPS for what is held to
    it), the ranks' parameters bit-equal;
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
        d_one, d_two = abs_diffs(b["params"], a["params"]), abs_diffs(two, a["params"])
        scale = max(t.abs().max().item() for t in a["params"].values())
        spread, err = d_one.median().item(), d_two.median().item()
        param_tol = max(DP_SPREAD_RATIO * spread, DP_REL * scale)
        loss_spread = abs(b["losses"][0] - a["losses"][0])
        loss_err = abs(ranks[0]["losses"][0] - a["losses"][0])
        loss_tol = max(DP_SPREAD_RATIO * loss_spread, DP_REL * abs(a["losses"][0]))
        grads_two = [torch.load(os.path.join(out, f"rank{r}_grads.pt")) for r in range(world)]
        grad_spread = (b["grads"] - a["grads"]).abs().max().item()
        grad_err = (grads_two[0] - a["grads"]).abs().max().item()
        grad_scale = a["grads"].abs().max().item()
        grad_tol = max(DP_SPREAD_RATIO * grad_spread, DP_REL * grad_scale)

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
        per_view = 2 * (-(-rays_per_rank // RENDER_CHUNK))
        checks = {
            f"{world} ranks": len(backend) == world,
            "params within the 1-rank spread (median)": err <= param_tol,
            "first loss within the 1-rank spread": loss_err <= loss_tol,
            "first grads within the 1-rank spread": grad_err <= grad_tol,
            "ranks' first grads bit-equal": all(torch.equal(grads_two[0], g)
                                                for g in grads_two[1:]),
            "ranks' params bit-equal": all(torch.equal(per_rank[0][k], r[k])
                                           for r in per_rank[1:] for k in per_rank[0]),
            ".tar is rank 0's params": all(torch.equal(per_rank[0][k], two[k]) for k in two),
            "launches per step per rank": all(
                len(r["step_launches"]) == DP_STEPS
                and all(d == {"k1": 2, "k2": 2} for d in r["step_launches"]) for r in ranks),
            "sharded test launches per view per rank": all(
                len(r["view_launches"]) == N_TEST
                and all(d == {"k1": per_view, "k2": per_view} for d in r["view_launches"])
                for r in test_ranks),
            "sharded test metrics equal 1 rank's": metrics_agree(sharded, single_metrics),
        }
        line("dp", world=world, backend=backend, steps=DP_STEPS, n_rand=1024,
             rays_per_rank=1024 // world,
             params=dict(median_abs_err_2_vs_1=err, median_spread_1_vs_1=spread, tol=param_tol,
                         max_abs_err_2_vs_1=d_two.max().item(),
                         max_abs_spread_1_vs_1=d_one.max().item(),
                         share_equal_2_vs_1=(d_two == 0).double().mean().item(),
                         share_equal_1_vs_1=(d_one == 0).double().mean().item(),
                         share_over_1e_4_2_vs_1=(d_two > 1e-4).double().mean().item(),
                         share_over_1e_4_1_vs_1=(d_one > 1e-4).double().mean().item(),
                         max_abs_param=scale),
             losses=dict(two=ranks[0]["losses"], one_a=a["losses"], one_b=b["losses"],
                         first_abs_err=loss_err, first_spread=loss_spread, first_tol=loss_tol,
                         max_abs_err=max(abs(x - y) for x, y in zip(ranks[0]["losses"],
                                                                     a["losses"])),
                         max_spread=max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))),
             first_grads=dict(n=a["grads"].numel(), max_abs_err_2_vs_1=grad_err,
                              max_abs_spread_1_vs_1=grad_spread, max_abs_grad=grad_scale,
                              tol=grad_tol),
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


class DumpProbe:
    """Times the dump's forward passes (each ends in a copy to the host), its
    host side per view (resize, polyfit, np.save) and the polyfits within
    it, without changing them."""

    def __init__(self):
        self.infer_s, self.write_s, self.fit_s = [], [], []
        self._patches = [mock.patch.object(prior_dump, name, self._timed(getattr(prior_dump, name),
                                                                          into))
                         for name, into in (("infer", self.infer_s), ("write_view", self.write_s),
                                            ("recover_metric_depth", self.fit_s))]

    @staticmethod
    def _timed(fn, into):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
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


def phase_prior(seed: int) -> dict:
    """The depth prior's inference path, then a NeRF trained on its output.
    The full-width ResNeXt101-32x8d cIMLE model (v2, d_latent 32) with seeded
    weights and AdaIn shifts, saved as a reference-format ``.pth`` and
    ``mean_var_adain.npy`` and loaded back as a user's checkpoint is; on the
    first view of a ScanNet-shaped scene at the 448 crop: the card's f32
    forward (TF32 off) against the CPU's on 2 z, and bf16 against f32 on the
    card on 20 z, with forward times in bf16, f32 with TF32 and f32; then
    ``python -m scade_tpu_torch.prior.dump`` as a user runs it (K=20 in one
    set of 20, bf16, the defaults) on the scene's 18 train views, which must
    write 360 finite (468, 624) float32 files; then the CLI's ``train`` for 5
    steps on those files, K1 and K2 at 2 launches a step."""
    tmp = tempfile.mkdtemp(prefix="scade_prior_")
    cwd = os.getcwd()
    log = io.StringIO()
    dev = torch.device("cuda")
    try:
        write_scene(tmp, seed)
        scene_dir = os.path.join(tmp, "scene")
        cfg = prior_model.backbone_config("resnext101_32x8d", d_latent=PRIOR_D_LATENT)
        t0 = time.perf_counter()
        net = prior_model.init_weights_(prior_model.DepthModelCIMLE(cfg, "v2"),
                                        torch.Generator().manual_seed(seed))
        ckpt_path, mean_var = os.path.join(tmp, "prior.pth"), os.path.join(tmp, "mv.npy")
        torch.save({"model_state_dict": net.state_dict()}, ckpt_path)
        rng = np.random.default_rng(seed)
        np.save(mean_var, {f"{w}{i}": (0.1 * rng.standard_normal((1, d)) if w == "mean"
                                       else rng.uniform(0.0, 0.2, (1, d))).astype(np.float32)
                           for i, d in enumerate(prior_model.encoder_adain_dims(cfg))
                           for w in ("mean", "var")})
        cpu_model = prior_dump.build_prior(ckpt_path, device="cpu")
        loaded_equal = all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                             cpu_model.state_dict().values()))
        n_params = sum(p.numel() for p in net.parameters())
        del net
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
        with DumpProbe() as probe, contextlib.redirect_stdout(log):
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
            d == {"k1": 2, "k2": 2} for d in train.step_launches)
        finite = all(math.isfinite(v) for v in losses)

        checks = {"checkpoint reloads bit-equal": loaded_equal,
                  "card f32 against CPU f32": f32_err <= PRIOR_F32_TOL * f32_scale,
                  "bf16 against f32": bf16_rel < PRIOR_BF16_REL,
                  "finite forward": bool(np.isfinite(f32_20).all() and np.isfinite(bf16_20).all()),
                  "360 hypothesis files": files_ok,
                  "NeRF launches per step": steps_ok, "NeRF finite loss": finite}
        n_views = len(probe.write_s)
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
                       forward_s_per_view=sum(probe.infer_s) / n_views,
                       forward_s_first_view=probe.infer_s[0],
                       forward_s_per_view_after_first=statistics.median(probe.infer_s[1:]),
                       host_s_per_view=sum(probe.write_s) / n_views,
                       host_s_per_view_median=statistics.median(probe.write_s),
                       polyfit_s_per_view=sum(probe.fit_s) / n_views,
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
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of the dp phase (torchrun)
        return dp_worker(sys.argv[2], sys.argv[3:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--k1-only", action="store_true",
                        help="run the device and k1 phases only and print no result line: "
                             "for comparing K1 builds of two trees on one card")
    parser.add_argument("--dp-only", type=int, default=0, metavar="N",
                        help="run the device phase, then the dp phase on N ranks on a "
                             "freshly written scene, and print no result line: for data "
                             "parallelism over N cards (NCCL)")
    args = parser.parse_args()
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
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    k1 = phase_k1(gen, dev["hmma"])
    if args.k1_only:
        return 0
    k2 = phase_k2(gen)
    state, scene, rc, tc, train_launches, train_median_ms = phase_train(args.seed, args.steps)
    phase_split(state, scene, rc, tc, args.seed)
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
    phase_prior(args.seed)

    # launches: the CLI's train run (20 steps and 6 rendered views), the main
    # path as a user drives it; launches_train_phase: the bare train phase's
    kernels = [
        dict(name="fused_mlp", route="cuda", source="scade_tpu_torch/csrc/fused_mlp.cu",
             replaces="scade_tpu/ops/fused_mlp.py:187", launches=cli_launches["k1"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None, check="pass",
             launches_train_phase=train_launches["k1"],
             max_abs_err_bf16=k1["max_abs_err_bf16"], fma_bound_ms=k1["fma_bound_ms"]),
        dict(name="sample_pdf", route="cuda",
             source="scade_tpu_torch/csrc/fused_sampling.cu",
             replaces="scade_tpu/ops/fused_sampling.py:110", launches=cli_launches["k2"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None, check="pass",
             launches_train_phase=train_launches["k2"],
             wall_ms=k2["wall_ms"], max_abs_err_vs_sample_pdf=k2["max_abs_err_vs_sample_pdf"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
