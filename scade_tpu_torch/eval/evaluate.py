"""Rendering views with metrics, and writing the test results.

The reference's eval pipeline (run_scade_scannet.py:304-409), as the JAX
package's ``scade_tpu/eval/evaluate.py`` runs it: a deterministic render of
each view on ``rc.device``, PSNR/SSIM/depth RMSE computed there, LPIPS where
its weights exist (NaN otherwise), and the results under
``<ckpt_dir>/<expname>/test_images_<scene>/``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from scade_tpu_torch.data import image_io
from scade_tpu_torch.eval.lpips import LPIPSAlex
from scade_tpu_torch.ops.losses import img2mse, mse2psnr
from scade_tpu_torch.ops.metrics import compute_rmse, ssim, to8b, to16b
from scade_tpu_torch.render.renderer import SceneVars, render_image
from scade_tpu_torch.utils.logging import MeanTracker


def render_images_with_metrics(
    count: Optional[int],
    indices,
    images,
    depths,
    valid_depths,
    poses,
    H: int,
    W: int,
    intrinsics,
    scene: SceneVars,
    rc,
    near: float,
    far: float,
    chunk: int = 16384,
    lpips_fn: Optional[LPIPSAlex] = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = True,
):
    """Render ``count`` views drawn with ``rng.choice`` from ``indices``
    (None: all of them, in order) and average PSNR/SSIM/LPIPS/depth RMSE
    (reference :304-394). images, depths, valid_depths, poses, intrinsics are
    host arrays indexed by the entries of ``indices``. Returns (MeanTracker,
    dict of stacked HWC numpy results)."""
    if count is None:
        count = len(indices)
        img_i = np.asarray(indices)
    else:
        rng = rng or np.random.default_rng()
        img_i = rng.choice(np.asarray(indices), size=count, replace=False)

    dev = torch.device(rc.device)
    lpips_fn = lpips_fn or LPIPSAlex().to(dev)
    has_fine = rc.nerf_fine is not None

    res = {
        "rgbs": np.empty((count, H, W, 3), np.float32),
        "target_rgbs": np.empty((count, H, W, 3), np.float32),
        "depths": np.empty((count, H, W, 1), np.float32),
        "target_depths": np.empty((count, H, W, 1), np.float32),
        "target_valid_depths": np.empty((count, H, W), bool),
    }
    if has_fine:
        res["rgbs0"] = np.empty((count, H, W, 3), np.float32)
        res["depths0"] = np.empty((count, H, W, 1), np.float32)

    mean_metrics = MeanTracker()
    mean_depth_metrics = MeanTracker()
    for n, img_idx in enumerate(img_i):
        target_np = np.asarray(images[img_idx])
        target_depth = np.asarray(depths[img_idx])
        target_valid = np.asarray(valid_depths[img_idx]).astype(bool)
        target = torch.from_numpy(target_np).to(dev)

        # only the maps read below: the per-sample leaves (~192 floats a ray
        # each) would otherwise pile up over the chunks
        out = render_image(
            scene, rc, H, W, intrinsics[img_idx], poses[img_idx], near, far, chunk=chunk,
            outputs=("rgb_map", "depth_map", "rgb0", "depth0") if has_fine
            else ("rgb_map", "depth_map"),
        )
        rgb, depth = out["rgb_map"], out["depth_map"]

        if target_valid.any():
            depth_rmse = float(compute_rmse(
                depth, torch.from_numpy(target_depth[..., 0]).to(dev),
                mask=torch.from_numpy(target_valid).to(dev)))
            if np.isfinite(depth_rmse):
                mean_depth_metrics.add({"depth_rmse": depth_rmse})

        img_loss = img2mse(rgb, target)
        psnr = float(mse2psnr(img_loss))
        rgb_c = torch.clamp(rgb, 0.0, 1.0)
        ssim_val = float(ssim(rgb_c, target))
        lpips_val = lpips_fn(rgb_c, target)

        res["rgbs"][n] = rgb_c.cpu().numpy()
        res["target_rgbs"][n] = target_np
        res["depths"][n] = (depth.cpu().numpy() / far)[..., None]
        res["target_depths"][n] = target_depth[..., :1] / far
        res["target_valid_depths"][n] = target_valid

        # lpips always has its column (NaN without weights), as the
        # reference's metrics.txt does (reference :371,384)
        metrics = {"img_loss": float(img_loss), "psnr": psnr, "ssim": ssim_val,
                   "lpips": lpips_val}
        if has_fine:
            img_loss0 = img2mse(out["rgb0"], target)
            metrics["img_loss0"] = float(img_loss0)
            metrics["psnr0"] = float(mse2psnr(img_loss0))
            res["rgbs0"][n] = torch.clamp(out["rgb0"], 0, 1).cpu().numpy()
            res["depths0"][n] = (out["depth0"].cpu().numpy() / far)[..., None]
        mean_metrics.add(metrics)
        if verbose:
            print(f"Render image {n + 1}/{count}  PSNR: {psnr:.2f}")

    all_mean = MeanTracker()
    all_mean.add({**mean_metrics.as_dict(), **mean_depth_metrics.as_dict()})
    return all_mean, res


def write_images_with_metrics(
    images: dict,
    mean_metrics: MeanTracker,
    far: float,
    ckpt_dir: str,
    expname: str,
    scene_id: str,
    with_test_time_optimization: bool = False,
):
    """<ckpt_dir>/<expname>/test_images_<scene>/{n_rgb.jpg, n_d.png (16-bit),
    metrics.txt} (reference :396-409). Without cv2 there is no JPEG encoder:
    the renders go to n_rgb.png instead, and one line says so."""
    result_dir = os.path.join(
        ckpt_dir, expname,
        "test_images_" + ("with_optimization_" if with_test_time_optimization else "") + scene_id,
    )
    os.makedirs(result_dir, exist_ok=True)
    jpeg = image_io.jpeg_available()
    if not jpeg:
        print(f"no cv2: writing the test renders as {{n}}_rgb.png in {result_dir}, not .jpg")
    for n, (rgb, depth) in enumerate(zip(images["rgbs"], images["depths"])):
        if jpeg:
            image_io.write_rgb_jpg(os.path.join(result_dir, f"{n}_rgb.jpg"), to8b(rgb))
        else:
            image_io.write_png8(os.path.join(result_dir, f"{n}_rgb.png"), to8b(rgb))
        image_io.write_png16(os.path.join(result_dir, f"{n}_d.png"), to16b(depth)[..., 0])

    with open(os.path.join(result_dir, "metrics.txt"), "w") as f:
        mean_metrics.print(f)
    mean_metrics.print()
    return result_dir
