"""The slice as a whole: the port's train/test CLI against the JAX package's
on one 32x48 synthetic scene, checkpoints crossing both ways, and the port's
own train, resume and device behaviour.

The small config of the JAX CLI tests: 8+16 samples, multires 4, N_rand 64,
chunk 2048 (8x256 networks). Tolerances of the two CLIs' test metrics on the
same checkpoint: psnr 1e-3 dB, ssim 1e-5, img_loss / depth_rmse (and the
coarse img_loss0 / psnr0) rtol 1e-4: the renders differ only by f32 sums in
another order (the inverse CDF from random weights agrees to rtol 1e-4,
tests/test_torch_ops.py). Checkpoints and the resume are exact.
"""

import json
import math
import os
import pickle
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scade_tpu.models.nerf import params_to_torch_state_dict
from scade_tpu.utils import ckpt as jckpt
from scade_tpu_torch import cli
from scade_tpu_torch.render.renderer import make_render_config
from scade_tpu_torch.train.step import TrainConfig, create_train_state
from scade_tpu_torch.utils import ckpt

SMALL = ["--N_samples", "8", "--N_importance", "16", "--multires", "4", "--N_rand", "64",
         "--chunk", "2048", "--num_hypothesis", "2", "--cimle_dir", "dump"]
METRIC_TOL = {"psnr": dict(rtol=0, atol=1e-3), "ssim": dict(rtol=0, atol=1e-5),
              "psnr0": dict(rtol=0, atol=1e-3)}
DEFAULT_TOL = dict(rtol=1e-4, atol=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port runs on one CPU thread here: the suite runs beside other
    workers, and torch's thread pool slows down many times over on
    oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The scene, and a JAX CLI run of 6 steps with a .tar every 2."""
    root = tmp_path_factory.mktemp("cli")
    subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..", "tools",
                                      "make_synthetic_scene.py"),
         str(root / "scene"), "--H", "32", "--W", "48", "--K", "2", "--n_train", "2",
         "--n_val", "1", "--n_test", "1", "--n_video", "0"],
        check=True, capture_output=True)
    from run_scade_scannet import main as jax_main

    cwd = os.getcwd()
    os.chdir(root)  # the TB root is relative to the working directory
    try:
        jax_main("scannet", ["train", *common(root, "jax"), "--num_iterations", "6",
                             "--i_weights", "2", "--i_img", "1000000", "--i_print", "1000000"])
    finally:
        os.chdir(cwd)
    return root


def common(root, expname):
    return ["--data_dir", str(root), "--scene_id", "scene", "--ckpt_dir", str(root / "ckpt"),
            "--expname", expname, *SMALL]


def read_metrics(path):
    out = {}
    for line in open(path).read().splitlines():
        key, value = line.split(": ")
        out[key] = float(value)
    return out


def port(root, task, expname, *extra):
    return cli.main("scannet", [task, *common(root, expname), "--device", "cpu", *extra])


def copy_run(root, expname, newest):
    """A copy of the JAX run whose newest .tar is step ``newest``."""
    dst = root / "ckpt" / expname
    shutil.copytree(root / "ckpt" / "jax", dst)
    for name in os.listdir(dst):
        if name.endswith(".tar") and int(name[:-4]) > newest:
            os.remove(dst / name)
        if name.startswith("test_images"):
            shutil.rmtree(dst / name)
    return dst


def test_same_checkpoint_both_clis(work, monkeypatch):
    from run_scade_scannet import main as jax_main

    monkeypatch.chdir(work)
    copy_run(work, "t_jax", 4)
    copy_run(work, "t_port", 4)
    jax_main("scannet", ["test", *common(work, "t_jax")])
    port(work, "test", "t_port")
    ref = read_metrics(work / "ckpt" / "t_jax" / "test_images_scene" / "metrics.txt")
    got = read_metrics(work / "ckpt" / "t_port" / "test_images_scene" / "metrics.txt")
    assert list(got) == list(ref) == ["img_loss", "psnr", "ssim", "lpips", "img_loss0", "psnr0",
                                      "depth_rmse"]
    assert math.isnan(got.pop("lpips")) and math.isnan(ref.pop("lpips"))
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, err_msg=key,
                                   **METRIC_TOL.get(key, DEFAULT_TOL))
    assert sorted(os.listdir(work / "ckpt" / "t_port" / "test_images_scene")) == \
        ["0_d.png", "0_rgb.jpg", "metrics.txt"]


def port_state(rc, n_images=3):
    return create_train_state(1, rc, TrainConfig(n_rand=64), n_images=n_images)


def small_rc():
    return make_render_config(multires=4, n_samples=8, n_importance=16, device="cpu")


def test_checkpoints_cross_both_ways(work, tmp_path):
    import scade_tpu.render.renderer as jrenderer

    rc = small_rc()
    # the JAX package's .tar after 6 steps, into the port, moments included
    jax_tar = str(work / "ckpt" / "jax" / "000006.tar")
    state = ckpt.restore_train_state(jax_tar, port_state(rc), rc)
    raw = jckpt.load_checkpoint_raw(jax_tar)
    assert state.step == 6 and state.opt.count == 6 and state.ss_opt.count == 6
    for model, key in ((state.model_coarse, "network_fn_state_dict"),
                       (state.model_fine, "network_fine_state_dict")):
        for name, t in model.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), raw[key]["module." + name])
    np.testing.assert_array_equal(state.scales.detach().numpy(), raw["depth_scales"])
    np.testing.assert_array_equal(state.shifts.detach().numpy(), raw["depth_shifts"])
    adam, sched = raw["scade_tpu"]["opt_state"]
    assert int(adam.count) == int(sched.count) == 6
    names = [(w, n) for w in ("coarse", "fine") for n, _ in state.model_coarse.named_parameters()]
    for moments, jtree in ((state.opt.mu, adam.mu), (state.opt.nu, adam.nu)):
        ref = {w: params_to_torch_state_dict(jax.tree.map(np.asarray, jtree[w]), prefix="")
               for w in ("coarse", "fine")}
        assert len(moments) == len(names)
        for (w, n), t in zip(names, moments):
            np.testing.assert_array_equal(t.numpy(), ref[w][n], err_msg=f"{w}.{n}")
    ss_adam = raw["scade_tpu"]["ss_opt_state"][0]
    assert int(ss_adam.count) == 6
    for moments, jtree in ((state.ss_opt.mu, ss_adam.mu), (state.ss_opt.nu, ss_adam.nu)):
        np.testing.assert_array_equal(moments[0].numpy(), np.asarray(jtree["scales"]))
        np.testing.assert_array_equal(moments[1].numpy(), np.asarray(jtree["shifts"]))

    # the port's .tar, into the JAX package
    path = str(tmp_path / "000006.tar")
    ckpt.save_checkpoint(path, state)
    params, step, _ = jckpt.load_params_from_checkpoint(path, jrenderer.make_render_config(
        multires=4, n_samples=8, n_importance=16))
    assert step == 6
    for model, w in ((state.model_coarse, "coarse"), (state.model_fine, "fine")):
        ref = params_to_torch_state_dict(jax.tree.map(np.asarray, params[w]), prefix="")
        assert ref.keys() == model.state_dict().keys()
        for name, t in model.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), ref[name])

    # and back into the port: everything exact
    again = ckpt.restore_train_state(path, port_state(rc), rc)
    for a, b in zip(again.opt.mu + again.opt.nu + again.ss_opt.mu + again.ss_opt.nu,
                    state.opt.mu + state.opt.nu + state.ss_opt.mu + state.ss_opt.nu):
        assert torch.equal(a, b)
    assert (again.opt.count, again.ss_opt.count, again.step) == (6, 6, 6)


def test_reference_schema_and_drifted_optimizer(work, tmp_path):
    rc = small_rc()
    state = ckpt.restore_train_state(str(work / "ckpt" / "jax" / "000006.tar"),
                                     port_state(rc), rc)
    state.step = 37
    path = str(tmp_path / "000037.tar")
    ckpt.save_checkpoint(path, state)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"global_step", "network_fn_state_dict", "network_fine_state_dict",
                        "optimizer_state_dict", "depth_shifts", "depth_scales",
                        "scade_tpu_torch"}
    assert all(k.startswith("module.") for k in raw["network_fn_state_dict"])

    # a reference .tar (no optimizer state): fresh moments, counts at global_step
    ref_path = str(tmp_path / "ref.tar")
    torch.save({k: v for k, v in raw.items() if k != "scade_tpu_torch"}, ref_path)
    ref = ckpt.restore_train_state(ref_path, port_state(rc), rc)
    assert (ref.step, ref.opt.count, ref.ss_opt.count) == (37, 37, 37)
    assert all(not t.any() for t in ref.opt.mu + ref.opt.nu + ref.ss_opt.mu + ref.ss_opt.nu)
    assert torch.equal(ref.scales, state.scales)

    # one optimizer's entries drifted: that one alone reinitializes
    raw["scade_tpu_torch"]["ss_opt"]["mu"].pop("shifts")
    drift_path = str(tmp_path / "drift.tar")
    torch.save(raw, drift_path)
    drifted = ckpt.restore_train_state(drift_path, port_state(rc), rc)
    assert drifted.opt.count == 6 and drifted.ss_opt.count == 37
    assert all(torch.equal(a, b) for a, b in zip(drifted.opt.mu, state.opt.mu))
    assert all(not t.any() for t in drifted.ss_opt.mu + drifted.ss_opt.nu)

    # a class that no checkpoint holds is refused, not built
    bad_path = str(tmp_path / "bad.tar")
    torch.save({**raw, "extra": ForeignClass()}, bad_path)
    with pytest.raises(pickle.UnpicklingError, match="ForeignClass"):
        ckpt.load_checkpoint_raw(bad_path)


class ForeignClass:
    pass


def test_port_trains_end_to_end(work, monkeypatch):
    monkeypatch.chdir(work)
    state = port(work, "train", "p20", "--num_iterations", "20", "--i_weights", "10",
                 "--i_print", "10", "--i_img", "10")
    run = work / "ckpt" / "p20"
    assert sorted(n for n in os.listdir(run) if n.endswith(".tar")) == ["000010.tar", "000020.tar"]
    assert json.loads((run / "args.json").read_text())["device"] == "cpu"
    assert state.step == 20 and state.opt.count == 20
    for name, t in state.model_fine.state_dict().items():
        assert torch.equal(t, torch.load(run / "000020.tar")["network_fine_state_dict"]
                           ["module." + name])
    lines = [json.loads(x) for x in (work / "runs" / "p20" / "scalars.jsonl").read_text()
             .splitlines()]
    tags = {(x["tag"], tuple(x.get("values", {}))) for x in lines}
    for tag in ("mse", "psnr", "mse0", "psnr0", "space_carving_loss", "depth_scale_mean",
                "depth_shift_mean"):
        assert (tag, ("train",)) in tags, tag
    for tag in ("mse", "psnr", "mse0", "psnr0"):
        assert (tag, ("val",)) in tags, tag
    for tag in ("ssim", "lpips", "depth_rmse"):
        assert (tag, ()) in tags, tag
    assert {x["step"] for x in lines} == {10, 20}
    m = read_metrics(run / "test_images_scene" / "metrics.txt")
    assert all(math.isfinite(m[k]) for k in ("psnr", "ssim", "depth_rmse"))


def test_resume_is_bit_equal_to_a_straight_run(work, monkeypatch):
    monkeypatch.chdir(work)
    flags = ["--i_img", "1000000", "--i_print", "1000000"]
    port(work, "train", "straight", "--num_iterations", "24", "--i_weights", "24", *flags)
    port(work, "train", "resumed", "--num_iterations", "12", "--i_weights", "12", *flags)
    port(work, "train", "resumed", "--num_iterations", "24", "--i_weights", "12", *flags)
    a = torch.load(work / "ckpt" / "straight" / "000024.tar")
    b = torch.load(work / "ckpt" / "resumed" / "000024.tar")

    def leaves(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, x

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys() and a["global_step"] == 24
    for key, value in la.items():
        if torch.is_tensor(value):
            assert torch.equal(value, lb[key]), key
        else:
            assert value == lb[key], key


def test_warm_start_takes_weights_and_scales_only(work, monkeypatch):
    """--load_pretrained from the JAX run: its weights and scales/shifts,
    step 0 and fresh Adams (a run of 0 steps returns the state as loaded)."""
    monkeypatch.chdir(work)
    state = port(work, "train", "warm", "--num_iterations", "0", "--load_pretrained", "true",
                 "--pretrained_dir", str(work / "ckpt" / "jax"))
    raw = jckpt.load_checkpoint_raw(str(work / "ckpt" / "jax" / "000006.tar"))
    for name, t in state.model_fine.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), raw["network_fine_state_dict"]["module." + name])
    np.testing.assert_array_equal(state.scales.detach().numpy(), raw["depth_scales"])
    assert (state.step, state.opt.count, state.ss_opt.count) == (0, 0, 0)
    assert all(not t.any() for t in state.opt.mu + state.opt.nu)


def test_device_and_unported_tasks(work):
    """Without a card, --device cuda raises before anything is written; a
    task other than train needs --expname; an unknown task exits. Every
    task of both runners is ported (tests/test_torch_cli_tasks.py)."""
    for variant in ("scannet", "wild"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(variant, ["train", *common(work, "cuda"), "--device", "cuda"])
    assert not os.path.exists(work / "ckpt" / "cuda")
    for task in ("test", "test_opt", "video"):
        with pytest.raises(SystemExit, match="expname is required"):
            cli.main("scannet", [task, "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown task"):
        cli.main("scannet", ["render", *common(work, "x"), "--device", "cpu"])
