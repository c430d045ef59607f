"""The port's hypothesis dump (scade_tpu_torch.prior.dump, dump_wild, demo)
against scade_tpu.prior.dump on the CPU.

Scene: ``tools/make_synthetic_scene.py --H 48 --W 64 --K 2 --n_train 2``;
the prior runs at a 64×64 crop. Model: the small prior
(``PriorConfig(d_latent=8).with_small()``) with the JAX package's
``init_prior(PRNGKey(0))`` weights, written to a ``.pth`` in the reference's
names as tools/export_prior_to_torch.py writes it, and seeded non-zero AdaIn
shifts in a ``mean_var_adain.npy``. K=3 hypotheses in z sets of 2, so the
ceil of sets and the trim both run. Where the port is held to the JAX dump
it is fed the JAX dump's own z sequence (``PRNGKey(seed)``, split per set,
``normal(k, (mb, d))``) through ``z_source``.

Tolerance: each hypothesis file within 1e-4 × max|JAX file| (measured: at
most 4e-7 relative; the f32 forwards differ by sums in other orders, and
the float64 polyfit carries that over). bf16 against f32: 5% mean relative
difference, the bound tests/test_prior.py holds the JAX bf16 dump to.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.prior import dump as jdump
from scade_tpu.prior import model as jmodel
from scade_tpu.prior.translate import params_to_torch_state_dict
from scade_tpu_torch.data.scene import load_scene_scannet
from scade_tpu_torch.prior import demo, dump, dump_wild
from scade_tpu_torch.prior.data import FinetuneDataset
from scade_tpu_torch.prior.model import encoder_adain_dims, load_mean_var_adain

D_LATENT, K, MB, CROP = 8, 3, 2, 64
JSMALL = jmodel.PriorConfig(d_latent=D_LATENT).with_small()
REL_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("prior_dump")
    scene = str(root / "scene")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synthetic_scene.py"), scene,
                    "--H", "48", "--W", "64", "--K", "2", "--n_train", "2", "--n_val", "0",
                    "--n_test", "1", "--n_video", "0"], check=True, capture_output=True)
    jm, variables = jmodel.init_prior(jax.random.PRNGKey(0), JSMALL, image_size=(32, 32))
    rng = np.random.default_rng(0)
    shifts = {}
    for i, d in enumerate(encoder_adain_dims(JSMALL)):
        shifts[f"mean{i}"] = (0.1 * rng.standard_normal((1, d))).astype(np.float32)
        shifts[f"var{i}"] = rng.uniform(0.0, 0.2, (1, d)).astype(np.float32)
    mean_var = str(root / "mean_var_adain.npy")
    np.save(mean_var, shifts)
    sd = params_to_torch_state_dict(variables["params"], variables["batch_stats"], JSMALL)
    ckpt = str(root / "prior.pth")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               ckpt)
    return types.SimpleNamespace(root=root, scene=scene, jm=jm, variables=variables, ckpt=ckpt,
                                 mean_var=mean_var,
                                 jshifts={k: jnp.asarray(v[0]) for k, v in shifts.items()})


def jax_z_source(seed):
    """The JAX dump's z draws, set after set."""
    key = [jax.random.PRNGKey(seed)]

    def draw(mb, d):
        key[0], k = jax.random.split(key[0])
        return np.asarray(jax.random.normal(k, (mb, d), jnp.float32))

    return draw


def jax_dump(work, scene, dump_dir, **kwargs):
    return jdump.dump_depth_hypotheses(work.jm, work.variables, work.jshifts, scene, dump_dir,
                                       d_latent=D_LATENT, num_hypothesis=K, mini_batch_size=MB,
                                       image_size=CROP, **kwargs)


def model_flags(work, device="cpu"):
    return ["--ckpt", work.ckpt, "--mean_var", work.mean_var, "--d_latent", str(D_LATENT),
            "--num_hypothesis", str(K), "--mini_batch_size", str(MB), "--small_model",
            "--image_size", str(CROP), "--device", device]


def npy_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


def assert_same_dump(port_dir, jax_dir):
    names = npy_files(jax_dir)
    assert names == npy_files(port_dir) == [f"{i}_{k}.npy" for i in range(2) for k in range(K)]
    for name in names:
        ref, got = np.load(os.path.join(jax_dir, name)), np.load(os.path.join(port_dir, name))
        assert got.dtype == np.float32 and got.shape == ref.shape == (48, 64)
        err = np.abs(got - ref).max()
        assert err <= REL_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_dump_matches_jax(work):
    ref_dir = jax_dump(work, work.scene, "jax_scannet")
    model = dump.build_prior(work.ckpt, d_latent=D_LATENT, small=True, device="cpu")
    out = dump.dump_depth_hypotheses(model, load_mean_var_adain(work.mean_var), work.scene,
                                     "port_scannet", d_latent=D_LATENT, num_hypothesis=K,
                                     mini_batch_size=MB, image_size=CROP,
                                     z_source=jax_z_source(0))
    assert out == os.path.join(work.scene, "train", "leres_cimle", "port_scannet")
    assert_same_dump(out, ref_dir)


def test_wild_dump_matches_jax(work, monkeypatch):
    """``dump_wild`` on a "processed" scene whose json sets the SfM units and
    a far plane that drops part of the SfM points: the port's entry point
    (defaults spliced in from the json) against the JAX dump given the same
    values."""
    scene = str(work.root / "wild_scene")
    shutil.copytree(work.scene, scene)
    path = os.path.join(scene, "transforms_train.json")
    with open(path) as f:
        meta = json.load(f)
    meta.update(far=6.5, depth_scaling_factor=800.0)
    with open(path, "w") as f:
        json.dump(meta, f)
    sfm = FinetuneDataset(os.path.join(scene, "train"), "processed").load_sfm_depth(0) * 1.25
    valid = sfm[sfm > 0.5]
    assert 0 < (valid > 6.5).mean() < 1, "the far clip must drop some SfM points, not all"

    ref_dir = jax_dump(work, scene, "jax_wild", dataset_name="processed", sfm_mask_threshold=0.5,
                       sfm_scaling_factor=800.0, sfm_far_clip=6.5)
    seen = {}

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return orig(*args, z_source=jax_z_source(0), **kwargs)

    orig = dump.dump_depth_hypotheses
    monkeypatch.setattr(dump, "dump_depth_hypotheses", spy)
    out = dump_wild.main(["--scene_dir", scene, "--dump_dir", "port_wild", "--compute_dtype",
                          "none", "--precision", "highest", *model_flags(work)])
    assert (seen["dataset_name"], seen["sfm_mask_threshold"], seen["sfm_scaling_factor"],
            seen["sfm_far_clip"]) == ("processed", 0.5, 800.0, 6.5)
    assert_same_dump(out, ref_dir)


def test_wild_user_flags_win(tmp_path, monkeypatch):
    """Both spellings of a user's flag win over the json's default, and a
    json without the key is fine when the user passed the flag."""
    (tmp_path / "transforms_train.json").write_text(json.dumps({"far": 7.0}))
    seen = []
    monkeypatch.setattr(dump, "main", lambda argv: seen.append(argv))
    dump_wild.main(["--scene_dir", str(tmp_path), "--sfm_mask_threshold=0.3",
                    "--sfm_scaling_factor", "250"])
    args = dump.parse_args([*seen[0], "--ckpt", "p.pth", "--mean_var", "m.npy"])
    assert (args.dataset_name, args.sfm_mask_threshold, args.sfm_scaling_factor,
            args.sfm_far_clip) == ("processed", 0.3, 250.0, 7.0)


def test_dump_main_bf16_and_previews_load_as_a_scene(work):
    """``python -m scade_tpu_torch.prior.dump`` as a user runs it, on the
    CPU: bf16 (the default) and f32 with the same seed; the files load as the
    scene's hypotheses and bf16 tracks f32."""
    common = ["--scene_dir", work.scene, *model_flags(work), "--seed_num", "3"]
    out16 = dump.main([*common, "--dump_dir", "main_bf16", "--save_previews"])
    out32 = dump.main([*common, "--dump_dir", "main_f32", "--compute_dtype", "float32"])
    for name in npy_files(out32):
        a, b = np.load(os.path.join(out32, name)), np.load(os.path.join(out16, name))
        assert np.isfinite(b).all()
        assert np.abs(a - b).mean() / np.abs(a).mean() < 0.05, name
    files = os.listdir(out16)
    assert sorted(f for f in files if f.endswith("_preview.png")) == [
        f"{i}_{k}_preview.png" for i in range(2) for k in range(K)]
    assert sum(f.endswith("_pcd.ply") for f in files) == 2 * K
    for d in ("main_bf16", "main_f32"):
        scene = load_scene_scannet(work.scene, d, num_hypothesis=K)
        assert scene.depth_hypothesis.shape == (2, K, 48, 64, 1)
        assert np.isfinite(scene.depth_hypothesis).all()


def test_demo_main_writes_unaligned_hypotheses(work):
    """The raw-folder variant over the scene's images (2 train, 1 test):
    K per image, resized back to the raw size, previews beside them; the
    train views' files load as hypotheses."""
    out_dir = os.path.join(work.scene, "train", "leres_cimle", "demo")
    demo.main(["--image_dir", os.path.join(work.scene, "train", "rgb"), "--out_dir", out_dir,
               *model_flags(work)])
    assert npy_files(out_dir) == [f"{i}_{k}.npy" for i in range(3) for k in range(K)]
    assert sum(f.endswith("_preview.png") for f in os.listdir(out_dir)) == 3 * K
    scene = load_scene_scannet(work.scene, "demo", num_hypothesis=K)
    assert scene.depth_hypothesis.shape == (2, K, 48, 64, 1)
    assert np.isfinite(scene.depth_hypothesis).all()


def test_entry_points_refuse_cuda_without_a_card(work):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    flags = model_flags(work, device="cuda")
    for entry, argv in ((dump.main, ["--scene_dir", work.scene, *flags]),
                        (dump_wild.main, ["--scene_dir", work.scene, *flags]),
                        (demo.main, ["--image_dir", work.scene, *flags])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(argv)


def test_msgpack_checkpoint_points_to_the_export_tool(work):
    with pytest.raises(SystemExit, match="export_prior_to_torch"):
        dump.build_prior(str(work.root / "prior.msgpack"), device="cpu")


@pytest.mark.parametrize("precision,tf32", [("highest", False), ("high", True),
                                            ("bfloat16", True), ("tensorfloat32", True),
                                            ("ambient", None)])
def test_precision_owns_tf32_and_restores_it(precision, tf32):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for before in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = before
            with dump.matmul_precision(precision):
                want = before if tf32 is None else tf32
                assert torch.backends.cudnn.allow_tf32 is want
                assert torch.backends.cuda.matmul.allow_tf32 is want
            assert torch.backends.cudnn.allow_tf32 is before
            assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_z_draws_are_seeded_and_source_wins():
    a = dump.z_draws(4, 3, seed=5, device="cpu")
    b = dump.z_draws(4, 3, seed=5, device="cpu")
    first, second = a(), a()
    assert first.shape == (4, 3) and not torch.equal(first, second)
    assert torch.equal(b(), first) and torch.equal(b(), second)
    src = dump.z_draws(2, 3, seed=5, device="cpu", z_source=lambda mb, d: np.full((mb, d), 1.5))
    assert torch.equal(src(), torch.full((2, 3), 1.5))


def test_metrics_and_point_clouds_match_jax(tmp_path):
    """The port's numpy copies: the metrics on the same data and draws, the
    alignment with and without SfM points, and the preview PLY byte for byte."""
    from scade_tpu.prior import metrics as jmetrics
    from scade_tpu.prior import pointcloud as jpointcloud
    from scade_tpu_torch.prior import metrics, pointcloud

    rng = np.random.default_rng(7)
    gt = rng.uniform(0.5, 5.0, (48, 64))
    gt[:4] = 0.0
    pred = gt * 0.8 + 0.3 + 0.05 * rng.standard_normal(gt.shape)
    invalid = rng.uniform(size=gt.shape) < 0.1
    assert metrics.evaluate_rel_err(pred, gt, invalid, rng=np.random.default_rng(1)) == \
        jmetrics.evaluate_rel_err(pred, gt, invalid, rng=np.random.default_rng(1))
    for target in (gt, np.zeros_like(gt)):
        ours, theirs = (m.recover_metric_depth(pred, target, 0.5) for m in (metrics, jmetrics))
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1:] == theirs[1:]
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    a = pointcloud.reconstruct_depth(gt, rgb, str(tmp_path / "port"), "pcd", focal=50.0)
    b = jpointcloud.reconstruct_depth(gt, rgb, str(tmp_path / "jax"), "pcd", focal=50.0)
    assert open(a, "rb").read() == open(b, "rb").read()
