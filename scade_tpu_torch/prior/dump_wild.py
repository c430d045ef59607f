"""Hypothesis dump for In-the-Wild / Tanks&Temples scenes (reference:
ambiguity_aware_prior/tools/output_depth_hypothesis_wild.py; the counterpart
of ``tools/output_depth_hypothesis_wild.py``). It is ``prior.dump`` with
per-scene defaults: depth files in ``train/depth`` (``--dataset_name
processed``), the alignment mask threshold 0.5, and the SfM depth's units
and far clip from ``transforms_train.json`` (``depth_scaling_factor``,
``far``), each only where the user did not pass the flag:

    python -m scade_tpu_torch.prior.dump_wild --scene_dir <scene> \\
        --ckpt prior.pth --mean_var mean_var_adain.npy --dump_dir dump_cimle
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from scade_tpu_torch.prior import dump


def main(argv=None) -> str:
    argv = list(sys.argv[1:] if argv is None else argv)

    def have(flag):
        # both spellings, '--flag value' and '--flag=value': argparse lets a
        # later occurrence win, so a default must never follow the user's
        return any(a == flag or a.startswith(flag + "=") for a in argv)

    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--scene_dir", required=True)
    known, _ = peek.parse_known_args(argv)
    with open(os.path.join(known.scene_dir, "transforms_train.json")) as fp:
        meta = json.load(fp)
    # values are thunks: a scene json may lack the key, which must not fail
    # when the user passed the flag
    for flag, value in (("--dataset_name", lambda: "processed"),
                        ("--sfm_mask_threshold", lambda: "0.5"),
                        ("--sfm_scaling_factor", lambda: meta["depth_scaling_factor"]),
                        ("--sfm_far_clip", lambda: meta["far"])):
        if not have(flag):
            argv.extend([flag, str(value())])
    return dump.main(argv)


if __name__ == "__main__":
    main()
