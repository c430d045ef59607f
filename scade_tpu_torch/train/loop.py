"""The host-side train loop: cadence, checkpoints, logging, the final test.

The device does all per-step work (``train/step.py``). This loop seeds each
step's generator, reads the metrics only every ``i_print`` steps (reading
them every step would wait for the device each time), and does the
``i_weights`` / ``i_img`` / final-test side effects (reference cadence:
run_scade_scannet.py:1002-1087), as the JAX package's ``train/loop.py`` does.

Under a process group (``--multihost``) every rank runs the same steps on
its block of rays (``train/step.py``) and renders its share of every eval
view; only rank 0 writes the ``.tar`` files, the TB/JSONL scalars and the
test images (scade_tpu/train/loop.py:246-255,301-304).

Deterministic resume: step ``i`` reseeds one reused generator on the device
with ``step_seed(args.seed, i)``, the counterpart of the JAX loop's
``fold_in(PRNGKey(seed + 1), i)``, and the checkpoint carries both Adams'
state, so a run resumed from step N continues exactly as if uninterrupted.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from scade_tpu_torch.eval.evaluate import render_images_with_metrics, write_images_with_metrics
from scade_tpu_torch.eval.lpips import LPIPSAlex
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.parallel.dist import Ranks
from scade_tpu_torch.render.renderer import SceneVars, make_render_config
from scade_tpu_torch.train.step import (
    TrainConfig,
    create_train_state,
    make_train_step,
    scene_tensors_from_scene,
)
from scade_tpu_torch.utils.ckpt import (
    find_checkpoints,
    load_weights,
    restore_train_state,
    save_checkpoint,
)
from scade_tpu_torch.utils.logging import Writer, make_image_grid


def check_device(name: str) -> torch.device:
    """``name`` as a device; ``cuda`` without a CUDA device raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return torch.device(name)


def step_seed(seed: int, i: int) -> int:
    """The seed of step ``i``'s generator: (seed + 1) in the high 32 bits,
    the step in the low 32."""
    return ((seed + 1) << 32) + i


def compute_scene_bounds(scene, device):
    """Scene bbox from the far-plane points of all train rays (reference
    run_nerf, run_scade_scannet.py:1236-1244): each train view's rays made on
    ``device`` and reduced there. min/max are exact, so the order of the
    reduction does not matter."""
    dev = torch.device(device)
    far = torch.tensor(scene.far, dtype=torch.float32, device=dev)
    mins, maxs = [], []
    with torch.no_grad():
        for idx in scene.i_train:
            intr = torch.from_numpy(scene.intrinsics[idx]).to(dev)
            pose = torch.from_numpy(scene.poses[idx]).to(dev)
            rays_o, rays_d = get_rays(scene.H, scene.W, intr, pose)
            pts = (rays_o + rays_d * far).reshape(-1, 3)
            mins.append(pts.amin(0))
            maxs.append(pts.amax(0))
        min_xyz = torch.stack(mins).amin(0).cpu().numpy()
        max_xyz = torch.stack(maxs).amax(0).cpu().numpy()
    min_xyz = np.minimum(min_xyz, np.full((3,), 1e6, np.float32))
    max_xyz = np.maximum(max_xyz, np.full((3,), -1e6, np.float32))
    bb_center = (max_xyz + min_xyz) / 2.0
    bb_scale = 2.0 / (max_xyz - min_xyz).max()
    return bb_center, float(bb_scale)


def args_to_configs(args):
    """CLI args → (RenderConfig, TrainConfig), on ``args.device``."""
    rc = make_render_config(
        multires=args.multires,
        multires_views=args.multires_views,
        i_embed=args.i_embed,
        netdepth=args.netdepth,
        netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine,
        netwidth_fine=args.netwidth_fine,
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb > 0.0,
        raw_noise_std=args.raw_noise_std,
        lindisp=args.lindisp,
        is_joint=args.is_joint,
        use_viewdirs=args.use_viewdirs,
        input_ch_cam=args.input_ch_cam,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
        use_fused=args.use_fused,
        fused_sampling=args.use_fused,
        device=args.device,
    )
    tc = TrainConfig(
        n_rand=args.N_rand,
        num_iterations=args.num_iterations,
        lrate=args.lrate,
        decay_step=args.decay_step,
        decay_rate=args.decay_rate,
        scaleshift_lr=args.scaleshift_lr,
        scale_init=args.scale_init,
        shift_init=args.shift_init,
        freeze_ss=args.freeze_ss,
        warm_start_nerf=args.warm_start_nerf,
        space_carving_weight=args.space_carving_weight,
        space_carving_threshold=args.space_carving_threshold,
        is_joint=args.is_joint,
        norm_p=args.norm_p,
        mask_corners=getattr(args, "mask_corners", False),
        mask_edges=getattr(args, "mask_edges", False),
        # the wild runner masks the RGB loss wherever a pixel mask exists
        mask_rgb=getattr(args, "mask_rgb", False),
        pixel_sampling=getattr(args, "pixel_sampling", "stratified"),
    )
    return rc, tc


def _tb_grid(images: dict, with0: bool) -> np.ndarray:
    """Columns of vertically stacked renders, as the reference's
    make_grid(nrow=1) concatenation (run_scade_scannet.py:1044-1048 train,
    :1063-1074 val, which interleaves the coarse rgbs0/depths0 columns)."""
    keys = ["rgbs"]
    if with0 and "rgbs0" in images:
        keys.append("rgbs0")
    keys += ["target_rgbs", "depths"]
    if with0 and "depths0" in images:
        keys.append("depths0")
    keys.append("target_depths")
    return np.concatenate([make_image_grid(images[k]) for k in keys], axis=1)


def train_nerf(scene, args, ranks: Optional[Ranks] = None):
    """SCADE training (reference train_nerf :830-1089) on ``args.device``.
    ``scene`` is a loaded ``data.scene.Scene``; ``ranks``: data-parallel over
    the process group (every rank calls this). Returns the final TrainState."""
    device = check_device(args.device)
    rc, tc = args_to_configs(args)
    if ranks is not None and tc.n_rand % ranks.world:
        raise ValueError(f"--N_rand {tc.n_rand} does not split evenly over {ranks.world} ranks")
    primary = ranks is None or ranks.primary

    # val/test get GT depth where it exists (:843-847)
    if scene.gt_depths is not None:
        for idx in (scene.i_test, scene.i_val):
            scene.depths[idx] = scene.gt_depths[idx]
            scene.valid_depths[idx] = scene.gt_valid_depths[idx]

    bb_center, bb_scale = compute_scene_bounds(scene, device)
    st = scene_tensors_from_scene(scene, bb_center, bb_scale, device)
    n_train = len(scene.i_train)
    n_rel = int(st.images.shape[0])

    state = create_train_state(args.seed, rc, tc, n_images=n_rel,
                               scales_init=scene.scales_init, shifts_init=scene.shifts_init)

    run_dir = os.path.join(args.ckpt_dir, args.expname)
    if primary:
        os.makedirs(run_dir, exist_ok=True)
    start = 0
    resumed = False
    if not args.no_reload:
        ckpts = find_checkpoints(args.ckpt_dir, args.expname)
        if ckpts:
            print(f"Reloading from {ckpts[-1]}")
            restore_train_state(ckpts[-1], state, rc)
            start = state.step
            resumed = True
    if args.load_pretrained and resumed:
        # resume wins over a warm start: re-applying the pretrained weights
        # would throw away `start` steps (the reference's load_pretrained block
        # never loads its dicts either, run_scade_scannet.py:915-926)
        print(f"Run checkpoint found at step {start}; ignoring --load_pretrained "
              "(resume takes precedence)")
    elif args.load_pretrained:
        ckpts = find_checkpoints(os.path.dirname(args.pretrained_dir.rstrip("/")),
                                 os.path.basename(args.pretrained_dir.rstrip("/")))
        if not ckpts:
            raise FileNotFoundError(f"no ckpts in {args.pretrained_dir}")
        print(f"Warm-starting from {ckpts[-1]}")
        # weights and depth scales/shifts only, with fresh optimizers and step
        # 0, as the reference's warm start (run_scade_scannet.py:906-938)
        load_weights(ckpts[-1], state, rc)

    step_fn = make_train_step(rc, tc, scene.H, scene.W, n_train, ranks)
    if ranks is not None:
        print(f"Training data-parallel over {ranks.world} ranks, "
              f"{tc.n_rand // ranks.world} rays a rank")
    # the wild runner logs under runs_prior_corrected (run_scade_wild.py:842)
    tb_root = "runs_prior_corrected" if getattr(args, "variant", "scannet") == "wild" else "runs"
    tb = Writer(os.path.join(tb_root, args.expname)) if primary else None
    lpips_fn = LPIPSAlex().to(device)
    no_cam = torch.zeros((rc.input_ch_cam,), device=device)

    def scene_vars():
        return SceneVars(state.model_coarse, state.model_fine, st.bb_center, st.bb_scale, no_cam)

    i_val_local = np.arange(n_train, n_rel)
    if len(i_val_local) == 0:
        i_val_local = np.arange(n_train)
    # host rows aligned with st.images: train then val (test without val)
    i_val_global = scene.i_val if len(scene.i_val) else scene.i_test
    i_rel = np.concatenate([scene.i_train, i_val_global])

    generator = torch.Generator(device=device)
    for i in range(start + 1, tc.num_iterations + 1):
        generator.manual_seed(step_seed(args.seed, i))
        metrics = step_fn(state, st, generator)

        if i % args.i_weights == 0 and primary:
            path = os.path.join(run_dir, f"{i:06d}.tar")
            save_checkpoint(path, state)
            print(f"Saved checkpoints at {path}")

        if i % args.i_print == 0 and primary:
            m = {k: float(v) for k, v in metrics.items()}
            tb.add_scalars("mse", {"train": m["img_loss"]}, i)
            if tc.space_carving_weight > 0.0:
                tb.add_scalars("space_carving_loss", {"train": m["space_carving_loss"]}, i)
            tb.add_scalars("psnr", {"train": m["psnr"]}, i)
            if "img_loss0" in m:
                tb.add_scalars("mse0", {"train": m["img_loss0"]}, i)
                tb.add_scalars("psnr0", {"train": m["psnr0"]}, i)
            tb.add_scalars("depth_scale_mean", {"train": m["depth_scale_mean"]}, i)
            tb.add_scalars("depth_shift_mean", {"train": m["depth_shift_mean"]}, i)
            print(f"[TRAIN] Iter: {i} Loss: {m['loss']:.6f}  PSNR: {m['psnr']:.3f}"
                  f"  MSE: {m['img_loss']:.6f} Space carving: {m['space_carving_loss']:.6f}")

        if i % args.i_img == 0:
            imgs, depths, poses = scene.images[i_rel], scene.depths[i_rel], scene.poses[i_rel]
            valid, intr = scene.valid_depths[i_rel], scene.intrinsics[i_rel]
            # 2 train renders for the TB grid (reference :1041-1048); the
            # subsets are drawn by generators seeded with the step
            _, images_train = render_images_with_metrics(
                min(2, n_train), np.arange(n_train), imgs, depths, valid, poses, scene.H,
                scene.W, intr, scene_vars(), rc, scene.near, scene.far, chunk=args.chunk // 2,
                lpips_fn=lpips_fn, rng=np.random.default_rng(i), verbose=primary, ranks=ranks)
            # val metrics and up to 8 val renders (reference :1050-1074)
            mean_val, images_val = render_images_with_metrics(
                min(8, len(i_val_local)), i_val_local, imgs, depths, valid, poses, scene.H,
                scene.W, intr, scene_vars(), rc, scene.near, scene.far, chunk=args.chunk // 2,
                lpips_fn=lpips_fn, rng=np.random.default_rng(i + 1), verbose=primary,
                ranks=ranks)
        if i % args.i_img == 0 and primary:
            tb.add_image("train_image", _tb_grid(images_train, with0=False), i)
            tb.add_scalars("mse", {"val": mean_val.get("img_loss")}, i)
            tb.add_scalars("psnr", {"val": mean_val.get("psnr")}, i)
            tb.add_scalar("ssim", mean_val.get("ssim"), i)
            tb.add_scalar("lpips", mean_val.get("lpips"), i)
            if mean_val.has("depth_rmse"):
                tb.add_scalar("depth_rmse", mean_val.get("depth_rmse"), i)
            if mean_val.has("img_loss0"):
                tb.add_scalars("mse0", {"val": mean_val.get("img_loss0")}, i)
                tb.add_scalars("psnr0", {"val": mean_val.get("psnr0")}, i)
            tb.add_image("val_image", _tb_grid(images_val, with0=True), i)

        if i == tc.num_iterations:
            i_test = scene.i_test
            mean_test, images_test = render_images_with_metrics(
                None, np.arange(len(i_test)), scene.images[i_test], scene.depths[i_test],
                scene.valid_depths[i_test], scene.poses[i_test], scene.H, scene.W,
                scene.intrinsics[i_test], scene_vars(), rc, scene.near, scene.far,
                chunk=args.chunk // 2, lpips_fn=lpips_fn, verbose=primary, ranks=ranks)
            if primary:
                write_images_with_metrics(images_test, mean_test, scene.far, args.ckpt_dir,
                                          args.expname, args.scene_id)
    if primary:
        tb.close()
    return state
