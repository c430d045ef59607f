"""Demo hypothesis dump: the cIMLE prior on a folder of raw images, with no
scene json and no SfM alignment; K depth hypotheses and a turbo preview per
image (reference: ambiguity_aware_prior/tools/output_depth_hypothesis_demo.py;
the counterpart of ``tools/output_depth_hypothesis_demo.py``):

    python -m scade_tpu_torch.prior.demo --image_dir imgs/ \\
        --ckpt prior.pth --mean_var mean_var_adain.npy --out_dir demo_dump

The forward runs in f32 (``--precision`` sets TF32), on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from scade_tpu_torch.prior import dump


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="Dump K cIMLE depth hypotheses per image of a "
                                             "folder, unaligned.")
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--out_dir", default="demo_dump")
    dump.add_model_flags(ap)
    args = ap.parse_args(argv)

    import cv2

    from scade_tpu_torch.prior.data import normalize_rgb
    from scade_tpu_torch.prior.model import load_mean_var_adain
    from scade_tpu_torch.train.loop import check_device

    device = check_device(args.device)
    model = dump.build_prior(args.ckpt, args.backbone, args.d_latent, args.version,
                             args.small_model, device)
    shifts = load_mean_var_adain(args.mean_var, device)
    os.makedirs(args.out_dir, exist_ok=True)
    draw = dump.z_draws(args.mini_batch_size, args.d_latent, args.seed_num, device)
    num_sets = -(-args.num_hypothesis // args.mini_batch_size)
    S = args.image_size

    names = sorted(f for f in os.listdir(args.image_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    with dump.matmul_precision(args.precision):
        for name in names:
            img_id = name.split(".")[0]
            rgb = cv2.imread(os.path.join(args.image_dir, name))[:, :, ::-1]
            H_raw, W_raw = rgb.shape[:2]
            x = normalize_rgb(cv2.resize(rgb, (S, S))).transpose(2, 0, 1)[None]
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            hyps = np.concatenate([dump.infer(model, shifts, x, draw()) for _ in range(num_sets)])
            for k_i, d in enumerate(hyps[:args.num_hypothesis]):
                d_raw = cv2.resize(d, (W_raw, H_raw))
                np.save(os.path.join(args.out_dir, f"{img_id}_{k_i}.npy"), d_raw)
                prev = d_raw - d_raw.min()
                prev = (prev / (prev.max() + 1e-8) * 255).astype(np.uint8)
                cv2.imwrite(os.path.join(args.out_dir, f"{img_id}_{k_i}_preview.png"),
                            cv2.applyColorMap(prev, cv2.COLORMAP_TURBO))
            print(f"{img_id}: {min(len(hyps), args.num_hypothesis)} hypotheses")
    return args.out_dir


if __name__ == "__main__":
    main()
