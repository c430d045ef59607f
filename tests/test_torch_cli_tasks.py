"""The port's CLI tasks test_opt and video, and the wild runner, against the
JAX CLIs on one 32x48 synthetic scene (2 train, 1 val, 1 test and 4 video
poses), on checkpoints both packages read.

The small config of tests/test_torch_cli.py, with the same tolerances for
two CLIs scoring one checkpoint: psnr 1e-3 dB, ssim 1e-5, the rest rtol
1e-4 (the renders differ only by f32 sums in another order). Latents fitted
by test_opt's 100 Adam steps at lr 0.5 are held to atol 0.05: both packages
draw the same pixels and agree to 1e-4 over the first steps
(tests/test_torch_eval_tasks.py), but the best of 100 candidates can fall on
another step where two steps' PSNRs nearly tie.
"""

import json
import math
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from scade_tpu_torch import cli, wild
from scade_tpu_torch.train import loop

SMALL = ["--N_samples", "8", "--N_importance", "16", "--multires", "4", "--N_rand", "64",
         "--chunk", "2048", "--num_hypothesis", "2", "--cimle_dir", "dump"]
METRIC_TOL = {"psnr": dict(rtol=0, atol=1e-3), "ssim": dict(rtol=0, atol=1e-5),
              "psnr0": dict(rtol=0, atol=1e-3)}
DEFAULT_TOL = dict(rtol=1e-4, atol=0)
LATENT_ATOL = 0.05


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One CPU thread: the suite runs beside other workers (see
    tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The scene, and a JAX CLI run of 4 steps with a .tar at 4."""
    root = tmp_path_factory.mktemp("tasks")
    subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..", "tools",
                                      "make_synthetic_scene.py"),
         str(root / "scene"), "--H", "32", "--W", "48", "--K", "2", "--n_train", "2",
         "--n_val", "1", "--n_test", "1", "--n_video", "4"],
        check=True, capture_output=True)
    from run_scade_scannet import main as jax_main

    cwd = os.getcwd()
    os.chdir(root)
    try:
        jax_main("scannet", ["train", *common(root, "jax"), "--num_iterations", "4",
                             "--i_weights", "4", "--i_img", "1000000", "--i_print", "1000000"])
    finally:
        os.chdir(cwd)
    return root


def common(root, expname):
    return ["--data_dir", str(root), "--scene_id", "scene", "--ckpt_dir", str(root / "ckpt"),
            "--expname", expname, *SMALL]


def read_metrics(path):
    return {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().splitlines())}


def assert_metrics_match(got, ref):
    assert list(got) == list(ref)
    for key, value in ref.items():
        if math.isnan(value):
            assert math.isnan(got[key]), key
            continue
        np.testing.assert_allclose(got[key], value, err_msg=key,
                                   **METRIC_TOL.get(key, DEFAULT_TOL))


def copy_run(root, src, dst):
    shutil.copytree(root / "ckpt" / src, root / "ckpt" / dst)
    for name in os.listdir(root / "ckpt" / dst):
        if name.startswith(("test_images", "test_latent", "video")):
            shutil.rmtree(root / "ckpt" / dst / name)


def test_test_opt_without_latent_matches_jax(work, monkeypatch):
    """With no camera latent, test_opt renders as test does, into its own
    directory."""
    from run_scade_scannet import main as jax_main

    monkeypatch.chdir(work)
    copy_run(work, "jax", "opt_jax")
    copy_run(work, "jax", "opt_port")
    jax_main("scannet", ["test_opt", *common(work, "opt_jax")])
    mean, result_dir = cli.main("scannet", ["test_opt", *common(work, "opt_port"),
                                            "--device", "cpu"])
    assert result_dir.endswith("test_images_with_optimization_scene")
    ref = read_metrics(work / "ckpt" / "opt_jax" / "test_images_with_optimization_scene"
                       / "metrics.txt")
    assert_metrics_match(read_metrics(os.path.join(result_dir, "metrics.txt")), ref)
    assert not os.path.exists(work / "ckpt" / "opt_port" / "test_latent_codes_scene")


def test_test_opt_with_latent_matches_jax(work, monkeypatch):
    """--input_ch_cam 4: the port trains the checkpoint, and both CLIs fit
    the test view's latent on it and score the view with it."""
    from run_scade_scannet import main as jax_main

    monkeypatch.chdir(work)
    cam = ["--input_ch_cam", "4"]
    cli.main("scannet", ["train", *common(work, "cam"), *cam, "--device", "cpu",
                         "--num_iterations", "4", "--i_weights", "4", "--i_img", "1000000",
                         "--i_print", "1000000"])
    copy_run(work, "cam", "cam_jax")
    jax_main("scannet", ["test_opt", *common(work, "cam_jax"), *cam])
    cli.main("scannet", ["test_opt", *common(work, "cam"), *cam, "--device", "cpu"])
    ours = np.loadtxt(work / "ckpt" / "cam" / "test_latent_codes_scene" / "0.txt")
    theirs = np.loadtxt(work / "ckpt" / "cam_jax" / "test_latent_codes_scene" / "0.txt")
    assert ours.shape == theirs.shape == (4,) and np.isfinite(ours).all()
    assert np.abs(ours).max() > 0.1  # the fit moved the latent
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=LATENT_ATOL)
    metrics = read_metrics(work / "ckpt" / "cam" / "test_images_with_optimization_scene"
                           / "metrics.txt")
    ref = read_metrics(work / "ckpt" / "cam_jax" / "test_images_with_optimization_scene"
                       / "metrics.txt")
    assert math.isfinite(metrics["psnr"])
    np.testing.assert_allclose(metrics["psnr"], ref["psnr"], rtol=0, atol=0.05)


def test_video_task_writes_a_decodable_video(work, monkeypatch):
    monkeypatch.chdir(work)
    copy_run(work, "jax", "video")
    path = cli.main("scannet", ["video", *common(work, "video"), "--device", "cpu"])
    frames = sorted(os.listdir(work / "ckpt" / "video" / "video_0"))
    assert [f for f in frames if f.endswith(".jpg")] == ["0.jpg", "3.jpg"]
    assert os.path.basename(path) in ("0.mp4", "0.avi")
    cap = cv2.VideoCapture(path)
    n = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        assert img.shape == (32, 3 * (int(32 / 9.0 * 16.0 / 3.0) // 2 * 2), 3)
        n += 1
    assert n == 2


def test_wild_test_matches_the_jax_wild_cli(work, monkeypatch):
    """A JAX wild checkpoint scored by both wild CLIs: the scene loads as a
    processed scene (no GT depth: depth is scored against the depth files)."""
    from run_scade_wild import main_wild as jax_wild

    monkeypatch.chdir(work)
    jax_wild(["train", *common(work, "wild_jax"), "--mask_edges", "true", "--num_iterations",
              "2", "--i_weights", "2", "--i_img", "1000000", "--i_print", "1000000"])
    copy_run(work, "wild_jax", "wild_port")
    jax_wild(["test", *common(work, "wild_jax")])
    wild.main_wild(["test", *common(work, "wild_port"), "--device", "cpu"])
    ref = read_metrics(work / "ckpt" / "wild_jax" / "test_images_scene" / "metrics.txt")
    got = read_metrics(work / "ckpt" / "wild_port" / "test_images_scene" / "metrics.txt")
    assert "depth_rmse" in got
    assert_metrics_match(got, ref)


def test_wild_trains_end_to_end(work, monkeypatch):
    monkeypatch.chdir(work)
    seen = {}
    train_nerf = loop.train_nerf

    def spy(scene, args, ranks=None):
        seen.update(mask_rgb=args.mask_rgb, mask_edges=args.mask_edges,
                    scaleshift_lr=args.scaleshift_lr, gt=scene.gt_depths)
        return train_nerf(scene, args, ranks)

    monkeypatch.setattr(loop, "train_nerf", spy)
    state = wild.main_wild(["train", *common(work, "wild_train"), "--device", "cpu",
                            "--mask_edges", "true", "--num_iterations", "4", "--i_weights", "4",
                            "--i_print", "2", "--i_img", "1000000"])
    assert seen == dict(mask_rgb=True, mask_edges=True, scaleshift_lr=1e-5, gt=None)
    assert state.step == 4
    scalars = work / "runs_prior_corrected" / "wild_train" / "scalars.jsonl"
    lines = [json.loads(x) for x in scalars.read_text().splitlines()]
    assert {x["step"] for x in lines} == {2, 4}
    assert all(math.isfinite(v) for x in lines for v in x.get("values", {}).values())
    assert not (work / "runs" / "wild_train").exists()
    m = read_metrics(work / "ckpt" / "wild_train" / "test_images_scene" / "metrics.txt")
    assert math.isfinite(m["psnr"])
