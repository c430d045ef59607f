"""SCADE through the PyTorch port: the reference runners' CLI, tasks
``train``, ``test``, ``test_opt`` and ``video`` (reference:
run_scade_scannet.py:1207-1291), for ScanNet scenes and, with the wild
variant (``python -m scade_tpu_torch.wild``), In-the-Wild / Tanks&Temples
scenes.

    python -m scade_tpu_torch train --data_dir <dir> --scene_id scene0758_00 \\
        --cimle_dir dump_1102_scene0758_sfmaligned_indv --ckpt_dir ckpts
    python -m scade_tpu_torch test|test_opt|video --expname <exp> ...
    torchrun --nproc_per_node N -m scade_tpu_torch train --multihost --expname <exp> ...

Runs on the card (``--device cuda``, the default) unless ``--device cpu`` is
given; without a CUDA device, ``cuda`` raises. ``--multihost`` runs one
process per card over a ``torch.distributed`` group (``parallel/dist.py``):
every rank trains on its block of each step's rays and renders its share of
every view, and only rank 0 writes. ``test_opt`` runs on rank 0 alone.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time

TASKS = ("train", "test", "test_opt", "video")


def main(variant: str = "scannet", argv=None):
    """Runs one task. Returns the final TrainState for ``train``, (MeanTracker,
    result directory) for ``test`` and ``test_opt``, the video's path for
    ``video``; None on a rank that writes nothing."""
    from scade_tpu_torch.utils.config import parse_args

    if variant not in ("scannet", "wild"):
        sys.exit(f"unknown variant {variant!r}")
    args = parse_args(variant=variant, argv=argv)
    if args.task not in TASKS:
        sys.exit(f"unknown task {args.task}")
    if args.multihost and args.task == "train" and args.expname is None:
        # names from each host's clock could differ and scatter one run
        sys.exit("--expname is required for multihost training")
    if args.task == "train" and args.expname is None:
        stamp = datetime.datetime.fromtimestamp(time.time()).strftime("%Y%m%d_%H%M%S")
        args.expname = f"{stamp}_{args.scene_id}"
    if args.task != "train" and args.expname is None:
        sys.exit(f'--expname is required for task "{args.task}"')

    from scade_tpu_torch.parallel import dist
    from scade_tpu_torch.train.loop import check_device

    check_device(args.device)
    ranks = None
    if args.multihost:
        ranks, device, backend = dist.init_from_env(args.device)
        print(f"multihost: rank {ranks.rank}/{ranks.world} on {device}, {backend}")
    try:
        return _run(variant, args, ranks)
    finally:
        dist.destroy()


def _run(variant: str, args, ranks):
    from scade_tpu_torch.parallel import dist

    primary = ranks is None or ranks.primary
    if args.task == "train" and primary:
        run_dir = os.path.join(args.ckpt_dir, args.expname)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "args.json"), "w") as af:
            json.dump(vars(args), af, indent=4)

    print("\n".join(f"{k}={v}" for k, v in vars(args).items()))

    from scade_tpu_torch.data.scene import load_scene_processed, load_scene_scannet

    scene_dir = os.path.join(args.data_dir, args.scene_id)
    load = load_scene_scannet if variant == "scannet" else load_scene_processed
    # rank 0 reads the hypothesis files and writes their blob before the
    # other ranks read it
    with dist.primary_first():
        scene = load(scene_dir, args.cimle_dir, args.num_hypothesis, args.train_jsonfile)
    print(f"hypotheses loaded: {scene.hypothesis_load}")
    if variant == "wild":
        # the wild runner masks the RGB loss wherever a pixel mask exists
        args.mask_rgb = bool(args.mask_edges or args.mask_corners)

    if args.task == "train":
        from scade_tpu_torch.train.loop import train_nerf

        return train_nerf(scene, args, ranks)

    if args.task == "test_opt" and not primary:
        # the latent fit is one device's program with host-side control
        # flow; other ranks would repeat it and race on its files
        print(f"process {ranks.rank}: test_opt runs on process 0 only; exiting")
        return None
    return _evaluate(scene, args, None if args.task == "test_opt" else ranks)


def _evaluate(scene, args, ranks):
    """test / test_opt / video from the newest checkpoint
    (run_scade_scannet.py:130-210)."""
    import numpy as np
    import torch

    from scade_tpu_torch.eval.evaluate import (
        optimize_camera_embedding,
        render_images_with_metrics,
        render_video,
        write_images_with_metrics,
    )
    from scade_tpu_torch.render.renderer import SceneVars
    from scade_tpu_torch.train.loop import args_to_configs, compute_scene_bounds
    from scade_tpu_torch.utils.ckpt import find_checkpoints, load_params_from_checkpoint

    primary = ranks is None or ranks.primary
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
    if ranks is not None:
        print(f"Rendering sharded over {ranks.world} ranks")

    if args.task == "video":
        i_video = scene.i_video
        return render_video(scene.poses[i_video], scene.H, scene.W, scene.intrinsics[i_video],
                            "0", args.ckpt_dir, args.expname, sv, rc, scene.near, scene.far,
                            chunk=args.chunk // 2, ranks=ranks)

    # test / test_opt: the test split, scored against GT depth where it exists
    i_test = scene.i_test
    if scene.gt_depths is not None:
        depths, valid = scene.gt_depths[i_test], scene.gt_valid_depths[i_test]
    else:
        depths, valid = scene.depths[i_test], scene.valid_depths[i_test]
    with_opt = args.task == "test_opt"
    embedded_cams = None
    if with_opt and args.input_ch_cam > 0:
        # each test image's own latent (reference :266-302), then its render
        latent_dir = os.path.join(args.ckpt_dir, args.expname,
                                  "test_latent_codes_" + args.scene_id)
        os.makedirs(latent_dir, exist_ok=True)
        embedded_cams = []
        for k, idx in enumerate(i_test):
            emb = optimize_camera_embedding(
                scene.images[idx], scene.poses[idx], scene.H, scene.W, scene.intrinsics[idx],
                sv, rc, scene.near, scene.far, args.input_ch_cam, n_rand=args.N_rand)
            np.savetxt(os.path.join(latent_dir, f"{k}.txt"), emb)
            embedded_cams.append(emb)

    mean_metrics, images_test = render_images_with_metrics(
        None, np.arange(len(i_test)), scene.images[i_test], depths, valid, scene.poses[i_test],
        scene.H, scene.W, scene.intrinsics[i_test], sv, rc, scene.near, scene.far,
        chunk=args.chunk // 2, verbose=primary, embedded_cams=embedded_cams, ranks=ranks,
    )
    if not primary:
        return None
    result_dir = write_images_with_metrics(images_test, mean_metrics, scene.far, args.ckpt_dir,
                                           args.expname, args.scene_id,
                                           with_test_time_optimization=with_opt)
    return mean_metrics, result_dir


if __name__ == "__main__":
    main("scannet")
