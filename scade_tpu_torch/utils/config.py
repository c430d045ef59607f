"""The CLI flag set of the reference runners, without configargparse: plain
argparse plus a reader for configargparse's ``key = value`` file format
(``--config file``, spliced before the command line so the command line wins).

It is the JAX package's flag set (``scade_tpu/utils/config.py``) for both
variants, with three differences:

- ``--use_fused`` defaults to true: the CUDA kernels are the port's main path
  on the card. On the CPU the renderer runs their plain versions whatever the
  flag says.
- ``--device {cuda,cpu}`` (default ``cuda``) names where the run goes. It
  takes the place of the JAX CLI's ``SCADE_PLATFORM`` environment variable.
  Without a CUDA device, ``cuda`` raises; nothing falls back to the CPU.
- ``--multihost`` starts a ``torch.distributed`` process group, one
  process per card (``parallel/dist.py``), from torchrun's environment or
  the JAX CLI's ``SCADE_COORDINATOR``/``SCADE_NUM_PROCESSES``/
  ``SCADE_PROCESS_ID``, where the JAX CLI joins one mesh over all processes.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _read_config_file(path: str, parser: Optional[argparse.ArgumentParser] = None) -> List[str]:
    """configargparse-style file → argv fragments. Lines are ``key = value``
    (or ``key: value``); booleans true/false; comments with ``#``.

    A boolean line respects the target action's arity: a store_true flag takes
    no value (bare ``--key``), while a ``type=_bool`` option needs one."""
    zero_arg = set()
    if parser is not None:
        for action in parser._actions:
            if action.nargs == 0:  # store_true / store_false / count
                zero_arg.update(o.lstrip("-") for o in action.option_strings)
    argv: List[str] = []
    with open(path, "r") as fp:
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            for sep in ("=", ":"):
                if sep in line:
                    key, value = line.split(sep, 1)
                    break
            else:
                key, value = line, "true"
            key, value = key.strip(), value.strip().strip("'\"")
            if value.lower() in ("true", "false") and (parser is None or key in zero_arg):
                if value.lower() == "true":
                    argv.append(f"--{key}")
            else:
                argv.extend([f"--{key}", value])
    return argv


def build_parser(variant: str = "scannet") -> argparse.ArgumentParser:
    """The reference flag set. variant: 'scannet' | 'wild' (the wild runner
    differs in the scaleshift_lr default, the default scene and mask_edges)."""
    p = argparse.ArgumentParser()
    # which runner built the args: the wild runner's TB root branches on it
    p.set_defaults(variant=variant)
    p.add_argument("task", type=str, help='one of: "train", "test", "test_opt", "video"')
    p.add_argument("--config", type=str, default=None, help="config file path")
    p.add_argument("--expname", type=str, default=None)

    # network
    p.add_argument("--netdepth", type=int, default=8)
    p.add_argument("--netwidth", type=int, default=256)
    p.add_argument("--netdepth_fine", type=int, default=8)
    p.add_argument("--netwidth_fine", type=int, default=256)
    p.add_argument("--N_rand", type=int, default=32 * 32)

    # schedule
    p.add_argument("--num_iterations", type=int, default=500000)
    p.add_argument("--lrate", type=float, default=5e-4)
    p.add_argument("--decay_step", type=int, default=400000)
    p.add_argument("--decay_rate", type=float, default=0.1)

    p.add_argument("--chunk", type=int, default=1024 * 32)
    p.add_argument("--netchunk_per_gpu", type=int, default=1024 * 64 * 4)
    p.add_argument("--no_reload", action="store_true")

    # rendering
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=128)
    p.add_argument("--perturb", type=float, default=1.0)
    p.add_argument("--use_viewdirs", action="store_true", default=True)
    p.add_argument("--i_embed", type=int, default=0)
    p.add_argument("--multires", type=int, default=9)
    p.add_argument("--multires_views", type=int, default=0)
    p.add_argument("--raw_noise_std", type=float, default=0.0)
    p.add_argument("--lindisp", action="store_true", default=False)

    # logging / saving
    p.add_argument("--i_print", type=int, default=100)
    p.add_argument("--i_img", type=int, default=20000)
    p.add_argument("--i_weights", type=int, default=100000)
    p.add_argument("--ckpt_dir", type=str, default="")

    # data
    default_scene = "scene0758_00" if variant == "scannet" else "kitchen"
    p.add_argument("--scene_id", type=str, default=default_scene)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--train_jsonfile", type=str, default="transforms_train.json")
    p.add_argument("--cimle_dir", type=str, default="dump_0826_pretrained_dd_scene0710_train/")
    p.add_argument("--num_hypothesis", type=int, default=20)
    p.add_argument("--space_carving_weight", type=float, default=0.007)
    p.add_argument("--warm_start_nerf", type=int, default=0)

    ss_lr_default = 1e-7 if variant == "scannet" else 1e-5
    p.add_argument("--scaleshift_lr", type=float, default=ss_lr_default)
    p.add_argument("--scale_init", type=float, default=1.0)
    p.add_argument("--shift_init", type=float, default=0.0)
    p.add_argument("--freeze_ss", type=int, default=400000)

    p.add_argument("--is_joint", type=_bool, default=False)
    p.add_argument("--pixel_sampling", type=str, default="stratified",
                   choices=["stratified", "choice", "iid"],
                   help="per-step ray-pixel selection: 'choice' is the reference's "
                        "no-replacement law, 'stratified' one pixel per stratum of "
                        "H*W/N_rand pixels (the same per-pixel marginals), 'iid' "
                        "with replacement")
    p.add_argument("--norm_p", type=int, default=2)
    p.add_argument("--space_carving_threshold", type=float, default=0.0)
    p.add_argument("--mask_corners", type=_bool, default=False)
    if variant == "wild":
        p.add_argument("--mask_edges", type=_bool, default=False)

    p.add_argument("--load_pretrained", type=_bool, default=False)
    p.add_argument("--pretrained_dir", type=str,
                   default="pretrained_models/scannet/scene758_scade/")

    p.add_argument("--input_ch_cam", type=int, default=0)
    p.add_argument("--opt_ch_cam", action="store_true", default=False)
    p.add_argument("--ch_cam_lr", type=float, default=1e-4)

    # not in the reference
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="MLP matmul dtype; bfloat16 runs K1 on the bf16 tensor cores")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel over a torch.distributed process group, one process a "
                        "card: launch with torchrun, or set SCADE_COORDINATOR (host:port), "
                        "SCADE_NUM_PROCESSES and SCADE_PROCESS_ID")
    p.add_argument("--use_fused", type=_bool, default=True,
                   help="run PE+MLP and the inverse-CDF lookups through the CUDA kernels")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the run goes; cuda raises when there is no CUDA device")
    return p


def _bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def parse_args(variant: str = "scannet", argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser(variant)
    # --config may appear anywhere, as '--config path' or '--config=path';
    # its contents go before every command-line flag so the command line wins
    cfg_path = None
    for i, tok in enumerate(argv):
        if tok == "--config":
            if i + 1 >= len(argv):
                parser.error("argument --config: expected one argument")
            cfg_path = argv[i + 1]
            rest = argv[:i] + argv[i + 2:]
            break
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
            rest = argv[:i] + argv[i + 1:]
            break
    if cfg_path is not None:
        # re-append --config so args.config records the file used
        argv = _read_config_file(cfg_path, parser) + rest + ["--config", cfg_path]
    return parser.parse_args(argv)
