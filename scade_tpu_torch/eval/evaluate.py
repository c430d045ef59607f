"""Rendering views with metrics, the video task and test-time camera-latent
optimization.

The reference's eval pipeline (run_scade_scannet.py:236-409), as the JAX
package's ``scade_tpu/eval/evaluate.py`` runs it: a deterministic render of
each view on ``rc.device``, PSNR/SSIM/depth RMSE computed there, LPIPS where
its weights exist (NaN otherwise), and the results under
``<ckpt_dir>/<expname>/test_images_<scene>/``; the video frames of
[rgb | depth | depth std] encoded to ``<expname>/<name>.mp4`` (or ``.avi``);
and ``test_opt``'s per-image camera latent fitted with Adam. Under a process
group (``ranks``) every rank renders its share of each view and only rank 0
writes.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from scade_tpu_torch.data import image_io
from scade_tpu_torch.eval.lpips import LPIPSAlex
from scade_tpu_torch.ops.losses import img2mse, mse2psnr
from scade_tpu_torch.ops.metrics import compute_rmse, ssim, to8b, to16b
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.parallel.dist import Ranks
from scade_tpu_torch.render.renderer import SceneVars, render_image, render_rays
from scade_tpu_torch.train.step import AdamState, adam_feed, adam_update
from scade_tpu_torch.utils.logging import MeanTracker
from scade_tpu_torch.utils.video import write_mjpeg_avi


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
    embedded_cams=None,
    ranks: Optional[Ranks] = None,
):
    """Render ``count`` views drawn with ``rng.choice`` from ``indices``
    (None: all of them, in order) and average PSNR/SSIM/LPIPS/depth RMSE
    (reference :304-394). images, depths, valid_depths, poses, intrinsics are
    host arrays indexed by the entries of ``indices``. ``embedded_cams``: one
    camera latent per entry of ``indices`` (test_opt), each view rendered
    with its own. ``ranks``: render each view sharded over the process
    group (every rank calls this with the same arguments). Returns
    (MeanTracker, dict of stacked HWC numpy results)."""
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

        if embedded_cams is not None:
            # the latent of the image at this position of ``indices``, not of
            # the loop's n: a random subset (count) stays aligned
            # (scade_tpu/eval/evaluate.py:81-90)
            cam_pos = int(np.asarray(indices).tolist().index(int(img_idx)))
            scene = scene._replace(embedded_cam=torch.as_tensor(
                np.asarray(embedded_cams[cam_pos]), dtype=torch.float32, device=dev))

        # only the maps read below: the per-sample leaves (~192 floats a ray
        # each) would otherwise pile up over the chunks
        out = render_image(
            scene, rc, H, W, intrinsics[img_idx], poses[img_idx], near, far, chunk=chunk,
            outputs=("rgb_map", "depth_map", "rgb0", "depth0") if has_fine
            else ("rgb_map", "depth_map"), ranks=ranks,
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


def video_frame(out: dict, far: float, cv2) -> np.ndarray:
    """One BGR uint8 video frame from a view's render: [rgb | TURBO(depth /
    far) | VIRIDIS(depth std)] side by side (reference :236-264). ``out``
    holds host arrays: rgb_map (H, W, 3), depth_map (H, W), and z_vals and
    weights (H, W, S), from which the depth's std is taken as the JAX
    package does (scade_tpu/eval/evaluate.py:226-240)."""
    frame = cv2.cvtColor(to8b(out["rgb_map"]), cv2.COLOR_RGB2BGR)
    depth = out["depth_map"]
    depth_frame = cv2.applyColorMap(to8b(depth / far), cv2.COLORMAP_TURBO)
    depth_var = np.sum((out["z_vals"] - depth[..., None]) ** 2 * out["weights"], -1)
    depth_std = np.sqrt(np.clip(depth_var, 0.0, 1.0))
    std_frame = cv2.applyColorMap(to8b(depth_std), cv2.COLORMAP_VIRIDIS)
    return np.concatenate((frame, depth_frame, std_frame), 1)


def render_video(
    poses,
    H: int,
    W: int,
    intrinsics,
    filename: str,
    ckpt_dir: str,
    expname: str,
    scene: SceneVars,
    rc,
    near: float,
    far: float,
    chunk: int = 16384,
    fps: int = 25,
    every: int = 3,
    ranks: Optional[Ranks] = None,
):
    """The video task (reference :236-264): every ``every``-th pose rendered
    cropped to 16:9, one ``video_frame`` each, written as
    ``<expname>/video_<filename>/<pose>.jpg`` and encoded to
    ``<expname>/<filename>.mp4`` by ffmpeg's concat demuxer (CRF 23), else by
    imageio, else as an MJPEG AVI (``<filename>.avi``) — the JAX package's
    order. Needs cv2 (color maps, JPEG). Under ``ranks`` every rank renders
    its share of each frame and only rank 0 touches the filesystem. Returns
    the video's path on rank 0 (the frame directory where nothing could
    encode), else None."""
    import cv2

    primary = ranks is None or ranks.primary
    video_dir = os.path.join(ckpt_dir, expname, "video_" + filename)
    if primary:
        if os.path.exists(video_dir):
            shutil.rmtree(video_dir)
        os.makedirs(video_dir, exist_ok=True)

    max_depth_in_video = 0.0
    for img_idx in range(0, len(poses), every):
        out = render_image(scene, rc, H, W, intrinsics[img_idx], poses[img_idx], near, far,
                           chunk=chunk, with_5_9=True,
                           outputs=("rgb_map", "depth_map", "z_vals", "weights"), ranks=ranks)
        if not primary:
            continue
        # the two (H, W', 192) leaves are ~99 MB each at 468x624: copied once
        out = {k: v.cpu().numpy() for k, v in out.items()}
        max_depth_in_video = max(max_depth_in_video, float(out["depth_map"].max()))
        cv2.imwrite(os.path.join(video_dir, f"{img_idx}.jpg"), video_frame(out, far, cv2))

    if not primary:
        return None
    video_file = encode_video(video_dir, os.path.join(ckpt_dir, expname, filename), fps, cv2)
    print(f"Maximal depth in video: {max_depth_in_video}")
    return video_file


def encode_video(video_dir: str, stem: str, fps: int, cv2) -> str:
    """The frames ``video_dir/<n>.jpg`` in the order of n, as ``stem.mp4``
    (ffmpeg, else imageio) or ``stem.avi`` (MJPEG). The reference's ffmpeg
    call reads '%d.jpg' (which stops at the first gap in the pose indices)
    and passes fps as the CRF; the concat demuxer and CRF 23 are the JAX
    package's fix (PARITY.md). Returns the file, or ``video_dir`` when no
    encoder could write one."""
    video_file = stem + ".mp4"
    names = sorted((f for f in os.listdir(video_dir) if f.endswith(".jpg")),
                   key=lambda f: int(f.split(".")[0]))
    if shutil.which("ffmpeg") is not None:
        list_path = os.path.join(video_dir, "frames.txt")
        with open(list_path, "w") as fp:
            for f in names:
                fp.write(f"file '{os.path.abspath(os.path.join(video_dir, f))}'\n")
        subprocess.call(["ffmpeg", "-y", "-r", str(fps), "-f", "concat", "-safe", "0",
                         "-i", list_path, "-c:v", "libx264", "-profile:v", "high", "-crf", "23",
                         "-pix_fmt", "yuv420p", video_file])
        return video_file
    try:
        import imageio.v2 as imageio

        with imageio.get_writer(video_file, fps=fps) as w:
            for f in names:
                w.append_data(imageio.imread(os.path.join(video_dir, f)))
        return video_file
    except (ImportError, ValueError, RuntimeError, OSError):
        pass  # no mp4 backend: an MJPEG AVI from the frames' own JPEG bytes
    try:
        jpegs = []
        for f in names:
            with open(os.path.join(video_dir, f), "rb") as fp:
                jpegs.append(fp.read())
        first = cv2.imread(os.path.join(video_dir, names[0]))
        video_file = write_mjpeg_avi(stem + ".avi", jpegs, (first.shape[1], first.shape[0]),
                                     fps=fps)
        print(f"no mp4 encoder: wrote MJPEG AVI {video_file}")
        return video_file
    except (OSError, IndexError, AttributeError) as exc:
        print(f"video encode unavailable ({exc}); frames left in {video_dir}")
        return video_dir


def optimize_camera_embedding(
    image, pose, H: int, W: int, intrinsic, scene: SceneVars, rc, near: float, far: float,
    input_ch_cam: int, n_rand: int = 1024, steps: int = 100, lr: float = 0.5,
) -> np.ndarray:
    """test_opt: one image's camera latent fitted by ``steps`` steps of Adam
    (optax's arithmetic, ``train/step.py::adam_update``) at ``lr`` from zero,
    each on ``2 * n_rand`` of its pixels drawn by ``np.random.default_rng(0)``
    without replacement, as the JAX package draws them (reference :266-302,
    broken upstream; scade_tpu/eval/evaluate.py:304-362). Returns the best
    latent as a host array: a step's PSNR is scored from its loss before the
    update, the latent kept is the one after it, and a NaN PSNR never wins.
    The best is tracked on the device, with no host read per step."""
    dev = torch.device(rc.device)
    rc_t = rc.test_mode()
    rays_o, rays_d = get_rays(H, W, torch.as_tensor(intrinsic, dtype=torch.float32, device=dev),
                              torch.as_tensor(pose, dtype=torch.float32, device=dev))
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    target = torch.as_tensor(np.asarray(image, np.float32).reshape(-1, 3), device=dev)

    emb = torch.zeros((input_ch_cam,), device=dev, requires_grad=True)
    opt = AdamState.zeros_like([emb])
    best_emb = emb.detach().clone()
    best_psnr = torch.tensor(-np.inf, device=dev)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        idx = torch.from_numpy(rng.choice(H * W, size=2 * n_rand, replace=False)).to(dev)
        out = render_rays(scene._replace(embedded_cam=emb), rc_t, rays_o[idx], rays_d[idx],
                          near, far)
        loss = img2mse(out["rgb_map"], target[idx])
        (grad,) = torch.autograd.grad(loss, [emb])
        adam_update([emb], [grad], opt, adam_feed(lr, opt.count + 1, dev))
        psnr = mse2psnr(loss.detach())
        take = psnr > best_psnr  # False for a NaN psnr
        best_emb = torch.where(take, emb.detach(), best_emb)
        best_psnr = torch.where(take, psnr, best_psnr)
    return best_emb.cpu().numpy()
