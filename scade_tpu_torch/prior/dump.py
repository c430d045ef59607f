"""Hypothesis dump: the bridge from the cIMLE prior to the SCADE NeRF.

For each training image of a scene, draw K z-codes, run the prior on the
card, resize each depth map to the raw resolution, align it to the sparse
SfM depth with a deg-1 polyfit, and save
``<scene>/train/leres_cimle/<dump_dir>/<img_id>_<k>.npy`` (reference:
ambiguity_aware_prior/tools/output_depth_hypothesis_scannet.py:374-574),
the files ``scade_tpu_torch.data.scene`` reads. The counterpart of
``scade_tpu/prior/dump.py`` and ``tools/output_depth_hypothesis_scannet.py``:

    python -m scade_tpu_torch.prior.dump --scene_dir <scene> \\
        --ckpt prior.pth --mean_var mean_var_adain.npy --dump_dir dump_cimle

The checkpoint is a reference-format ``.pth``/``.tar``; a flax msgpack from
the JAX package goes through ``tools/export_prior_to_torch.py`` first.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from scade_tpu_torch.prior.data import FinetuneDataset
from scade_tpu_torch.prior.metrics import recover_metric_depth

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, "none": None}
PRECISIONS = ("highest", "high", "bfloat16", "tensorfloat32", "ambient")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """cuDNN and cuBLAS TF32 for f32 convolutions and products inside the
    block, restored after it: ``highest`` turns TF32 off, ``ambient`` leaves
    torch's setting, any other value turns it on (torch has no bf16-pass
    mode for f32 convolutions)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if precision != "ambient":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = (
            precision != "highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def build_prior(ckpt: str, backbone: str = "resnext101_32x8d", d_latent: int = 32,
                version: str = "v2", small: bool = False, device="cuda"):
    """The encoder-side cIMLE model with a reference-format checkpoint loaded
    strictly, on ``device``, in eval mode."""
    from scade_tpu_torch.prior.convert import load_prior_checkpoint
    from scade_tpu_torch.prior.model import DepthModelCIMLE, backbone_config

    if not ckpt.endswith((".pth", ".tar")):
        sys.exit(f"{ckpt}: the port reads .pth/.tar checkpoints; convert a flax msgpack "
                 "with tools/export_prior_to_torch.py first")
    cfg = backbone_config(backbone, d_latent=d_latent)
    if small:
        cfg = cfg.with_small()
    model = DepthModelCIMLE(cfg, version)
    model.load_state_dict(load_prior_checkpoint(ckpt), strict=True)
    return model.to(device).eval()


def infer(model, shifts: Dict[str, torch.Tensor], rgb: torch.Tensor, z: torch.Tensor
          ) -> np.ndarray:
    """One z set: the (1, 3, S, S) image repeated for each of z's rows →
    (len(z), S, S) float32 depth logits on the host."""
    with torch.inference_mode():
        depth = model(rgb.expand(z.shape[0], -1, -1, -1), z.to(rgb.dtype), shifts)
        return depth[:, 0].float().cpu().numpy()


def write_view(hyps, sfm_depth: np.ndarray, raw_size, out_dir: str, img_id: str,
               sfm_mask_threshold: float, default_scale: float, default_shift: float,
               previews: Optional[dict] = None) -> None:
    """The host side of one view: each hypothesis resized to the raw
    resolution (cv2 INTER_LINEAR), aligned to the SfM depth (float64
    polyfit) and saved as ``<img_id>_<k>.npy``; with ``previews`` (``rgb``,
    ``focal``) also a turbo-colored PNG and a colored point cloud each."""
    import cv2

    H_raw, W_raw = raw_size
    for k_i, hyp in enumerate(hyps):
        hyp_raw = cv2.resize(hyp.astype(np.float32), (W_raw, H_raw),
                             interpolation=cv2.INTER_LINEAR)
        aligned, _, _ = recover_metric_depth(hyp_raw, sfm_depth, mask_threshold=sfm_mask_threshold,
                                             default_scale=default_scale,
                                             default_shift=default_shift)
        np.save(os.path.join(out_dir, f"{img_id}_{k_i}.npy"), aligned.astype(np.float32))
        if previews is not None:
            from scade_tpu_torch.prior.pointcloud import reconstruct_depth

            prev = aligned - aligned.min()
            prev = (prev / (prev.max() + 1e-8) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(out_dir, f"{img_id}_{k_i}_preview.png"),
                        cv2.applyColorMap(prev, cv2.COLORMAP_TURBO))
            reconstruct_depth(aligned, previews["rgb"], out_dir, f"{img_id}_{k_i}_pcd",
                              focal=previews["focal"])


def z_draws(mini_batch_size: int, d_latent: int, seed: int, device,
            z_source: Optional[Callable] = None) -> Callable[[], torch.Tensor]:
    """A function that returns the next (mini_batch_size, d_latent) z set:
    ``z_source(mini_batch_size, d_latent)`` where given, else a draw from one
    generator on ``device`` seeded with ``seed`` (the same seed and device
    give the same draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw():
        if z_source is not None:
            z = np.array(z_source(mini_batch_size, d_latent), np.float32)
            return torch.from_numpy(z).to(device)
        return torch.randn((mini_batch_size, d_latent), generator=gen, device=device)

    return draw


def dump_depth_hypotheses(
    model,
    shifts: Dict[str, torch.Tensor],
    scene_dir: str,
    dump_dir: str,
    d_latent: int = 32,
    num_hypothesis: int = 20,
    mini_batch_size: int = 20,
    dataset_name: str = "scannet",
    sfm_mask_threshold: float = 0.1,
    default_scale: float = 0.5,
    default_shift: float = 0.0,
    seed: int = 0,
    save_previews: bool = False,
    sfm_scaling_factor: float = 1000.0,
    sfm_far_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    image_size: int = 448,
    z_source: Optional[Callable] = None,
) -> str:
    """Write K aligned hypothesis ``.npy`` files per train image; returns the
    output directory. ``model`` runs on the device its parameters are on;
    ``compute_dtype`` casts it (in place) and the shifts once, and the
    activations follow. ``image_size`` is the square crop the prior runs at.
    ``z_source(mini_batch_size, d_latent)``, where given, supplies each z
    set in place of the seeded generator."""
    import cv2  # the hypothesis resize needs it

    device = next(model.parameters()).device
    ds = FinetuneDataset(os.path.join(scene_dir, "train"), dataset_name,
                         crop_size=(image_size, image_size))
    out_dir = os.path.join(scene_dir, "train", "leres_cimle", dump_dir)
    os.makedirs(out_dir, exist_ok=True)
    dtype = torch.float32
    if compute_dtype is not None:
        dtype = compute_dtype
        model.to(dtype)
    shifts = {k: v.to(device, dtype) for k, v in shifts.items()}
    draw = z_draws(mini_batch_size, d_latent, seed, device, z_source)
    # ceil: enough sets to cover num_hypothesis; the overshoot is trimmed
    num_sets = -(-num_hypothesis // mini_batch_size)

    for idx in range(len(ds)):
        ex = ds[idx]
        img_id = os.path.basename(ex.rgb_path).split(".")[0]
        sfm_depth = ds.load_sfm_depth(idx) * (1000.0 / sfm_scaling_factor)
        if sfm_far_clip is not None:
            # wild scenes drop SfM points beyond the far plane
            sfm_depth = np.where(sfm_depth > sfm_far_clip, 0.0, sfm_depth)
        rgb = torch.from_numpy(np.ascontiguousarray(ex.rgb.transpose(2, 0, 1)))[None]
        rgb = rgb.to(device, dtype)
        hyps = np.concatenate([infer(model, shifts, rgb, draw()) for _ in range(num_sets)])
        previews = None
        if save_previews:
            previews = {"rgb": cv2.imread(ex.rgb_path)[:, :, ::-1], "focal": ex.focal_length}
        write_view(hyps[:num_hypothesis], sfm_depth, ex.raw_size, out_dir, img_id,
                   sfm_mask_threshold, default_scale, default_shift, previews)
        print(f"dumped {num_hypothesis} hypotheses for {img_id} ({idx + 1}/{len(ds)})")
    return out_dir


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The flags the dump and the demo share: the model, its checkpoint, the
    z draws, the crop, the precision and the device."""
    ap.add_argument("--ckpt", required=True,
                    help="prior checkpoint: a reference-format .pth/.tar holding "
                         "model_state_dict, state_dict or a bare state_dict (a flax msgpack "
                         "goes through tools/export_prior_to_torch.py first)")
    ap.add_argument("--mean_var", required=True, help="mean_var_adain.npy")
    ap.add_argument("--d_latent", type=int, default=32)
    ap.add_argument("--version", default="v2", choices=["v2", "v3"],
                    help="encoder cIMLE AdaIn flavor")
    ap.add_argument("--backbone", default="resnext101_32x8d")
    ap.add_argument("--num_hypothesis", type=int, default=20)
    ap.add_argument("--mini_batch_size", type=int, default=20,
                    help="z-draws per forward pass (the reference runs 4 sets of 5)")
    ap.add_argument("--seed_num", type=int, default=0)
    ap.add_argument("--small_model", action="store_true")
    ap.add_argument("--image_size", type=int, default=448)
    ap.add_argument("--precision", default="bfloat16", choices=list(PRECISIONS),
                    help="TF32 for f32 convolutions and products (cuDNN/cuBLAS): 'highest' "
                         "turns it off, 'ambient' leaves torch's setting, any other value "
                         "turns it on; torch has no bf16-pass mode for f32 convolutions")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Dump K cIMLE depth hypotheses per train image "
                                             "of a scene.")
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--dump_dir", default="dump_cimle")
    ap.add_argument("--dataset_name", default="scannet")
    ap.add_argument("--sfm_mask_threshold", type=float, default=0.1)
    ap.add_argument("--sfm_scaling_factor", type=float, default=1000.0,
                    help="SfM depth png units per meter")
    ap.add_argument("--sfm_far_clip", type=float, default=None,
                    help="drop SfM points beyond this depth (wild scenes)")
    ap.add_argument("--default_scale", type=float, default=0.5)
    ap.add_argument("--default_shift", type=float, default=0.0)
    ap.add_argument("--save_previews", action="store_true")
    ap.add_argument("--compute_dtype", default="bfloat16", choices=list(COMPUTE_DTYPES),
                    help="run the whole forward (parameters and activations) in this dtype; "
                         "'float32' and 'none' keep f32, where --precision applies")
    add_model_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from scade_tpu_torch.prior.model import load_mean_var_adain
    from scade_tpu_torch.train.loop import check_device

    device = check_device(args.device)
    model = build_prior(args.ckpt, args.backbone, args.d_latent, args.version, args.small_model,
                        device)
    print(f"loaded {args.ckpt}")
    with matmul_precision(args.precision):
        out = dump_depth_hypotheses(
            model, load_mean_var_adain(args.mean_var), args.scene_dir, args.dump_dir,
            d_latent=args.d_latent, num_hypothesis=args.num_hypothesis,
            mini_batch_size=args.mini_batch_size, dataset_name=args.dataset_name,
            sfm_mask_threshold=args.sfm_mask_threshold, default_scale=args.default_scale,
            default_shift=args.default_shift, seed=args.seed_num,
            save_previews=args.save_previews, sfm_scaling_factor=args.sfm_scaling_factor,
            sfm_far_clip=args.sfm_far_clip, compute_dtype=COMPUTE_DTYPES[args.compute_dtype],
            image_size=args.image_size)
    print(f"hypotheses written to {out}")
    return out


if __name__ == "__main__":
    main()
