"""SCADE on ScanNet through the PyTorch port: the reference runner's CLI for
the tasks ``train`` and ``test`` (reference: run_scade_scannet.py:1207-1291).

    python -m scade_tpu_torch train --data_dir <dir> --scene_id scene0758_00 \\
        --cimle_dir dump_1102_scene0758_sfmaligned_indv --ckpt_dir ckpts
    python -m scade_tpu_torch test --expname <exp> ...

Runs on the card (``--device cuda``, the default) unless ``--device cpu`` is
given; without a CUDA device, ``cuda`` raises. ``test_opt`` and ``video``
(ROADMAP Queue 1 item 8) and the wild runner (item 9) are not ported yet.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time


def main(variant: str = "scannet", argv=None):
    """Runs one task. Returns the final TrainState for ``train`` and
    (MeanTracker, result directory) for ``test``."""
    from scade_tpu_torch.utils.config import parse_args

    if variant != "scannet":
        sys.exit(f"variant {variant!r}: the wild runner is not ported to scade_tpu_torch yet "
                 "(ROADMAP Queue 1 item 9)")
    args = parse_args(variant=variant, argv=argv)
    if args.task in ("test_opt", "video"):
        sys.exit(f'task "{args.task}" is not ported to scade_tpu_torch yet '
                 "(ROADMAP Queue 1 item 8)")
    if args.task not in ("train", "test"):
        sys.exit(f"unknown task {args.task}")

    if args.task == "train" and args.expname is None:
        stamp = datetime.datetime.fromtimestamp(time.time()).strftime("%Y%m%d_%H%M%S")
        args.expname = f"{stamp}_{args.scene_id}"
    if args.task != "train" and args.expname is None:
        sys.exit(f'--expname is required for task "{args.task}"')

    from scade_tpu_torch.train.loop import check_device

    check_device(args.device)
    if args.task == "train":
        run_dir = os.path.join(args.ckpt_dir, args.expname)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "args.json"), "w") as af:
            json.dump(vars(args), af, indent=4)

    print("\n".join(f"{k}={v}" for k, v in vars(args).items()))

    from scade_tpu_torch.data.scene import load_scene_scannet

    scene = load_scene_scannet(os.path.join(args.data_dir, args.scene_id), args.cimle_dir,
                               args.num_hypothesis, args.train_jsonfile)

    if args.task == "train":
        from scade_tpu_torch.train.loop import train_nerf

        return train_nerf(scene, args)

    # ---- test: newest checkpoint, the test split with GT depths ----------
    import numpy as np
    import torch

    from scade_tpu_torch.eval.evaluate import (
        render_images_with_metrics,
        write_images_with_metrics,
    )
    from scade_tpu_torch.render.renderer import SceneVars
    from scade_tpu_torch.train.loop import args_to_configs, compute_scene_bounds
    from scade_tpu_torch.utils.ckpt import find_checkpoints, load_params_from_checkpoint

    rc, _ = args_to_configs(args)
    ckpts = find_checkpoints(args.ckpt_dir, args.expname)
    if not ckpts:
        sys.exit(f"no checkpoints found in {args.ckpt_dir}/{args.expname}")
    print(f"Loading checkpoint {ckpts[-1]}")
    models, _, _ = load_params_from_checkpoint(ckpts[-1], rc)

    device = torch.device(rc.device)
    bb_center, bb_scale = compute_scene_bounds(scene, device)
    sv = SceneVars(
        models["coarse"], models["fine"],
        torch.as_tensor(bb_center, dtype=torch.float32, device=device),
        torch.tensor(bb_scale, dtype=torch.float32, device=device),
        torch.zeros((args.input_ch_cam,), device=device),
    )
    i_test = scene.i_test
    if scene.gt_depths is not None:
        depths, valid = scene.gt_depths[i_test], scene.gt_valid_depths[i_test]
    else:
        depths, valid = scene.depths[i_test], scene.valid_depths[i_test]
    mean_metrics, images_test = render_images_with_metrics(
        None, np.arange(len(i_test)), scene.images[i_test], depths, valid, scene.poses[i_test],
        scene.H, scene.W, scene.intrinsics[i_test], sv, rc, scene.near, scene.far,
        chunk=args.chunk // 2,
    )
    result_dir = write_images_with_metrics(images_test, mean_metrics, scene.far, args.ckpt_dir,
                                           args.expname, args.scene_id)
    return mean_metrics, result_dir


if __name__ == "__main__":
    main("scannet")
