#!/usr/bin/env python3
"""How far the port's test_opt latent fit and the JAX package's drift apart.

    JAX_PLATFORMS=cpu python3 tools/test_opt_divergence.py

Replays tests/test_torch_cli_tasks.py::test_test_opt_with_latent_matches_jax
on the CPU in a temporary directory: the 32x48 synthetic scene, the port's
CLI trains 4 steps with --input_ch_cam 4, then both CLIs fit the test
view's camera latent (100 Adam steps at lr 0.5) on that checkpoint, and the
JAX CLI fits it once more with XLA_FLAGS=--xla_backend_optimization_level=0
(the same function, other rounding). Prints one JSON line: the latent after
each step of both fits (their largest distance per step), the final
latents, and the final distances port-JAX and JAX-JAX(-O0). Run from the
root of a tree; it measures that tree's ``scade_tpu_torch``.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = os.getcwd()
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import jax  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from run_scade_scannet import main as jax_main  # noqa: E402
from scade_tpu_torch import cli  # noqa: E402
from scade_tpu_torch.eval import evaluate  # noqa: E402
from test_torch_cli_tasks import SMALL, copy_run  # noqa: E402


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    root = Path(tempfile.mkdtemp(prefix="test_opt_divergence_"))
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synthetic_scene.py"),
                    str(root / "scene"), "--H", "32", "--W", "48", "--K", "2", "--n_train", "2",
                    "--n_val", "1", "--n_test", "1", "--n_video", "4"],
                   check=True, capture_output=True)
    os.chdir(root)

    def common(expname):
        return ["--data_dir", str(root), "--scene_id", "scene", "--ckpt_dir", str(root / "ckpt"),
                "--expname", expname, *SMALL, "--input_ch_cam", "4"]

    cli.main("scannet", ["train", *common("port"), "--device", "cpu", "--num_iterations", "4",
                         "--i_weights", "4", "--i_img", "1000000", "--i_print", "1000000"])
    copy_run(root, "port", "jax")
    copy_run(root, "port", "jax_O0")

    steps = {"jax": [], "port": []}
    apply_updates = optax.apply_updates

    def recorded(params, updates):  # the JAX fit's latent after each step
        new = apply_updates(params, updates)
        jax.debug.callback(lambda v: steps["jax"].append(np.asarray(v).tolist()), new)
        return new

    optax.apply_updates = recorded
    jax_main("scannet", ["test_opt", *common("jax")])
    optax.apply_updates = apply_updates
    adam_update = evaluate.adam_update

    def recorded_port(params, grads, opt, lr):
        adam_update(params, grads, opt, lr)
        steps["port"].append(params[0].detach().tolist())

    evaluate.adam_update = recorded_port
    cli.main("scannet", ["test_opt", *common("port"), "--device", "cpu"])
    code = ("import sys; sys.path.insert(0, %r); import jax; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "from run_scade_scannet import main; main('scannet', %r)"
            % (REPO, ["test_opt", *common("jax_O0")]))
    subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, cwd=root,
                   env=dict(os.environ, XLA_FLAGS="--xla_backend_optimization_level=0"))
    final = {name: np.loadtxt(root / "ckpt" / name / "test_latent_codes_scene" / "0.txt")
             for name in ("port", "jax", "jax_O0")}
    per_step = np.abs(np.array(steps["port"]) - np.array(steps["jax"])).max(-1)
    print(json.dumps(dict(
        step_distance_port_jax=per_step.tolist(),
        final={k: v.tolist() for k, v in final.items()},
        final_distance_port_jax=float(np.abs(final["port"] - final["jax"]).max()),
        final_distance_jax_jax_O0=float(np.abs(final["jax"] - final["jax_O0"]).max()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
