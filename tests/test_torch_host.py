"""The port's host modules against the JAX package's: flags, scene loaders,
the PNG codec, metrics, LPIPS, metrics.txt and the scalar log.

Tolerances: loaders, the codec and the flag set are exact; ``ssim`` and
``compute_rmse`` 1e-6 (f32 windowed sums in another order); LPIPS 1e-5
(f32 convolutions in another order over 11x11x3 to 3x3x384 windows).
"""

import json
import os
import shutil
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.data import scene as jscene
from scade_tpu.ops import metrics as jmetrics
from scade_tpu.utils import config as jconfig
from scade_tpu.utils import logging as jlogging
from scade_tpu_torch import cli
from scade_tpu_torch.data import image_io
from scade_tpu_torch.data import scene as pscene
from scade_tpu_torch.eval.evaluate import write_images_with_metrics
from scade_tpu_torch.eval.lpips import LPIPSAlex
from scade_tpu_torch.ops import metrics
from scade_tpu_torch.utils import config
from scade_tpu_torch.utils.logging import MeanTracker, Writer

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
# the port's three stated differences from the JAX flag set
PORT_ONLY = {"device"}
PORT_DEFAULTS = {"use_fused": True}


def make_scene(path, **kw):
    args = dict(H=32, W=48, K=2, n_train=2, n_val=1, n_test=1, n_video=1)
    args.update(kw)
    cmd = [sys.executable, os.path.join(TOOLS, "make_synthetic_scene.py"), str(path)]
    for k, v in args.items():
        cmd += [f"--{k}", str(v)]
    subprocess.run(cmd, check=True, capture_output=True)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A 32x48 scene, K=2, every split, with scale/shift inits."""
    path = tmp_path_factory.mktemp("host") / "scene"
    make_scene(path)
    ss_dir = path / "train" / "scale_shift_inits" / "ss"
    ss_dir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name in ("0", "1"):
        for suffix in ("_gtinit.npy", "_sfminit.npy"):
            np.save(ss_dir / (name + suffix), rng.uniform(0.5, 2.0, 2))
    return path


# ---- flags -----------------------------------------------------------------


def _bool_behaviour(fn):
    return [fn(v) for v in ("true", "True", "1", "yes", "false", "0", "no", True, False)]


@pytest.mark.parametrize("variant", ["scannet", "wild"])
def test_parser_has_the_jax_flag_set(variant):
    ours = {a.dest: a for a in config.build_parser(variant)._actions}
    theirs = {a.dest: a for a in jconfig.build_parser(variant)._actions}
    assert set(ours) - set(theirs) == PORT_ONLY and set(theirs) <= set(ours)
    for dest, ref in theirs.items():
        got = ours[dest]
        assert got.option_strings == ref.option_strings, dest
        assert got.nargs == ref.nargs and got.choices == ref.choices, dest
        assert type(got) is type(ref), dest
        assert got.default == PORT_DEFAULTS.get(dest, ref.default), dest
        if ref.type in (None, int, float, str):
            assert got.type is ref.type, dest
        else:
            assert _bool_behaviour(got.type) == _bool_behaviour(ref.type), dest
    assert ours["device"].default == "cuda" and ours["device"].choices == ["cuda", "cpu"]
    for key in ("variant",):
        assert config.build_parser(variant).get_default(key) == variant


@pytest.mark.parametrize("variant", ["scannet", "wild"])
def test_config_file_splicing_gives_equal_namespaces(tmp_path, variant):
    cfg = tmp_path / "exp.txt"
    cfg.write_text("# comment\nN_rand = 512\nlrate: 1e-3\nexpname = from_file\n"
                   "lindisp = true\nno_reload = false\nis_joint = true\n"
                   "mask_corners = true\nload_pretrained = false\n")
    for argv in (["train", "--config", str(cfg)],
                 ["--config", str(cfg), "test", "--N_rand", "256"],
                 ["train", f"--config={cfg}", "--lrate", "2e-4", "--is_joint", "false"],
                 ["train"]):
        ours = vars(config.parse_args(variant, argv))
        theirs = vars(jconfig.parse_args(variant, argv))
        assert ours.pop("device") == "cuda"
        assert ours.pop("use_fused") is True and theirs.pop("use_fused") is False
        assert ours == theirs, argv


def test_multihost_raises():
    """--multihost parses (parallel/dist.py starts the process group); a
    multihost train without --expname exits, as the JAX CLI does, since each
    host's clock would name the run differently."""
    assert config.parse_args("scannet", ["train", "--multihost"]).multihost
    with pytest.raises(SystemExit, match="expname is required for multihost"):
        cli.main("scannet", ["train", "--multihost", "--device", "cpu"])


# ---- scene loaders ---------------------------------------------------------


def assert_scenes_equal(a, b):
    for field in ("images", "depths", "valid_depths", "poses", "intrinsics", "gt_depths",
                  "gt_valid_depths", "depth_hypothesis", "scales_init", "shifts_init"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.H, a.W, a.near, a.far, a.filenames) == (b.H, b.W, b.near, b.far, b.filenames)
    assert len(a.i_split) == len(b.i_split) == 4
    for x, y in zip(a.i_split, b.i_split):
        np.testing.assert_array_equal(x, y)


LOADERS = {
    "load_scene": lambda m, d: m.load_scene(d),
    "load_scene_scannet": lambda m, d: m.load_scene_scannet(d, "dump", 2, init_scales=True,
                                                            scales_dir="ss", gt_init=True),
    "load_scene_nogt": lambda m, d: m.load_scene_nogt(d),
    "load_scene_processed": lambda m, d: m.load_scene_processed(d, "dump", 2, init_scales=True,
                                                                scales_dir="ss"),
}


@pytest.mark.parametrize("loader", list(LOADERS))
def test_loaders_match_jax(scene_dir, tmp_path, loader):
    work = tmp_path / "scene"
    shutil.copytree(scene_dir, work)
    ours = LOADERS[loader](pscene, str(work))
    # the port packs the hypotheses into the JAX package's blob cache, which
    # scade_tpu then reads as it is (tests/test_torch_native_cache.py)
    dump = work / "train" / "leres_cimle" / "dump"
    cached = sorted(n for n in os.listdir(dump) if n.startswith(".scade_hyp_cache"))
    has_hyps = ours.depth_hypothesis is not None
    assert cached == ([".scade_hyp_cache.blob", ".scade_hyp_cache.blob.json"] if has_hyps else [])
    assert (ours.hypothesis_load or "").startswith("npy:") == has_hyps
    stamps = [(dump / n).stat().st_mtime_ns for n in cached]
    theirs = LOADERS[loader](jscene, str(work))
    assert [(dump / n).stat().st_mtime_ns for n in cached] == stamps
    assert_scenes_equal(ours, theirs)
    if loader == "load_scene_scannet":
        assert ours.depth_hypothesis.shape == (2, 2, 32, 48, 1)
        assert ours.depth_hypothesis.min() >= ours.near and ours.depth_hypothesis.max() <= ours.far
        assert ours.scales_init.shape == (2,) and ours.i_video.tolist() == [4]


def test_custom_train_json_and_missing_splits(scene_dir, tmp_path):
    """The train split reads --train_jsonfile and checks that file's existence
    (the JAX loader's fix); a missing split is an empty index range."""
    work = tmp_path / "scene"
    shutil.copytree(scene_dir, work)
    os.rename(work / "transforms_train.json", work / "custom.json")
    os.remove(work / "transforms_video.json")
    ours = pscene.load_scene_scannet(str(work), "dump", 2, train_json="custom.json")
    theirs = jscene.load_scene_scannet(str(work), "dump", 2, train_json="custom.json")
    assert_scenes_equal(ours, theirs)
    assert len(ours.i_video) == 0 and len(ours.i_train) == 2


def test_png_scene_loads_the_same_without_cv2(scene_dir, tmp_path, monkeypatch):
    """A scene with PNG images (what chip_smoke.py writes) loads to the same
    arrays through cv2 and through the port's own codec."""
    work = tmp_path / "scene"
    shutil.copytree(scene_dir, work)
    for split in ("train", "val", "test", "video"):
        meta = json.loads((work / f"transforms_{split}.json").read_text())
        for frame in meta["frames"]:
            jpg = work / frame["file_path"]
            frame["file_path"] = frame["file_path"].replace(".jpg", ".png")
            cv2.imwrite(str(work / frame["file_path"]), cv2.imread(str(jpg)))
        (work / f"transforms_{split}.json").write_text(json.dumps(meta))
    with_cv2 = pscene.load_scene_scannet(str(work), "dump", 2)
    monkeypatch.setattr(image_io, "cv2", None)
    without = pscene.load_scene_scannet(str(work), "dump", 2)
    assert_scenes_equal(with_cv2, without)
    assert_scenes_equal(without, jscene.load_scene_scannet(str(work), "dump", 2))
    with pytest.raises(RuntimeError, match="0.jpg"):
        image_io.read_image(str(work / "train" / "rgb" / "0.jpg"))


# ---- the PNG codec ---------------------------------------------------------

FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


def codec_images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:23, :37]
    return {
        "rgb8": rng.integers(0, 256, (23, 37, 3), dtype=np.uint8),
        "rgba8": rng.integers(0, 256, (23, 37, 4), dtype=np.uint8),
        "gray8": rng.integers(0, 256, (23, 37), dtype=np.uint8),
        "depth16": rng.integers(0, 65536, (23, 37), dtype=np.uint16),
        "smooth16": (yy * 1500 + xx * 17).astype(np.uint16),
    }


@pytest.mark.parametrize("filt", FILTERS)
def test_codec_reads_cv2_pngs_exactly(tmp_path, monkeypatch, filt):
    for name, img in codec_images().items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")])
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        with monkeypatch.context() as m:
            m.setattr(image_io, "cv2", None)
            got = image_io._imread_unchanged(path)
            rgb = image_io.read_image(path) if img.ndim == 3 else None
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
        if rgb is not None:
            np.testing.assert_array_equal(rgb, image_io.read_image(path), err_msg=name)


def test_cv2_reads_codec_pngs_exactly(tmp_path, monkeypatch):
    monkeypatch.setattr(image_io, "cv2", None)
    for name, img in codec_images().items():
        path = str(tmp_path / f"{name}.png")
        image_io.png_encode(path, img)
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if got.ndim == 3:
            got = got[..., [2, 1, 0, 3][: got.shape[-1]]]  # BGR(A) → RGB(A)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img, err_msg=name)
    rgb = codec_images()["rgb8"]
    image_io.write_png8(str(tmp_path / "w8.png"), rgb)
    image_io.write_png16(str(tmp_path / "w16.png"), codec_images()["depth16"])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "w8.png"))[..., ::-1], rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "w16.png"), cv2.IMREAD_UNCHANGED),
                                  codec_images()["depth16"])
    with pytest.raises(RuntimeError, match="out.jpg"):
        image_io.write_rgb_jpg(str(tmp_path / "out.jpg"), rgb)


def test_writers_agree_across_routes(tmp_path, monkeypatch):
    imgs = codec_images()
    image_io.write_png8(str(tmp_path / "cv.png"), imgs["rgb8"])
    image_io.write_png16(str(tmp_path / "cv16.png"), imgs["depth16"])
    monkeypatch.setattr(image_io, "cv2", None)
    image_io.write_png8(str(tmp_path / "own.png"), imgs["rgb8"])
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "cv.png")),
                                  image_io.read_image(str(tmp_path / "own.png")))
    np.testing.assert_array_equal(image_io.read_depth_png(str(tmp_path / "cv16.png")),
                                  imgs["depth16"])


# ---- metrics ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 48, 3), (117, 90, 3), (40, 40)])
def test_ssim_and_rmse_match_jax(shape):
    rng = np.random.default_rng(1)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    got = float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - ref) <= 1e-6
    mask = rng.uniform(size=shape[:2]) > 0.3
    d0, d1 = a[..., 0] * 5, b[..., 0] * 5
    for m in (None, mask):
        got = float(metrics.compute_rmse(torch.from_numpy(d0), torch.from_numpy(d1),
                                         None if m is None else torch.from_numpy(m)))
        ref = float(jmetrics.compute_rmse(jnp.asarray(d0), jnp.asarray(d1),
                                          None if m is None else jnp.asarray(m)))
        assert abs(got - ref) <= 1e-6
    x = rng.uniform(-0.2, 1.2, size=(8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(metrics.to8b(x), jmetrics.to8b(x))
    np.testing.assert_array_equal(metrics.to16b(x), jmetrics.to16b(x))
    assert metrics.psnr_from_mse is metrics.mse2psnr


# ---- LPIPS -----------------------------------------------------------------


def synthetic_lpips_weights(path):
    """The synthetic weights of tests/test_eval.py: LPIPS(alex)'s shapes."""
    rng = np.random.default_rng(0)
    chans = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]
    data = {}
    for i, (o, c, k) in enumerate(chans):
        data[f"conv{i}_w"] = (rng.standard_normal((o, c, k, k)) * 0.05).astype(np.float32)
        data[f"conv{i}_b"] = np.zeros((o,), np.float32)
        data[f"lin{i}_w"] = np.abs(rng.standard_normal((o,))).astype(np.float32) * 0.1
    np.savez(path, **data)


def test_lpips_matches_jax_and_is_nan_without_weights(tmp_path, monkeypatch):
    from scade_tpu.eval.lpips_jax import LPIPSAlex as JLPIPSAlex

    monkeypatch.setenv("SCADE_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert not LPIPSAlex().ok and np.isnan(LPIPSAlex()(np.zeros((16, 16, 3)),
                                                       np.ones((16, 16, 3))))
    synthetic_lpips_weights(tmp_path / "lpips.npz")
    monkeypatch.setenv("SCADE_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    ours, theirs = LPIPSAlex(), JLPIPSAlex()
    assert ours.ok
    rng = np.random.default_rng(2)
    img0 = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
    for img1 in (img0, 1.0 - img0, np.clip(img0 + 0.1, 0, 1)):
        assert abs(ours(img0, img1) - theirs(img0, img1)) <= 1e-5
    assert ours(img0, img0) == pytest.approx(0.0, abs=1e-6)


# ---- metrics.txt and the scalar log ----------------------------------------


def test_mean_tracker_prints_the_jax_text(tmp_path):
    rows = [{"img_loss": 0.0123, "psnr": 19.1, "ssim": 0.5, "lpips": float("nan")},
            {"img_loss": 0.0234, "psnr": 16.3, "ssim": 0.25, "lpips": float("nan")}]
    ours, theirs = MeanTracker(), jlogging.MeanTracker()
    for r in rows:
        ours.add(r)
        theirs.add(r)
    ours.add({"depth_rmse": 1.5}, weight=0.5)
    theirs.add({"depth_rmse": 1.5}, weight=0.5)
    for tracker, name in ((ours, "a.txt"), (theirs, "b.txt")):
        with open(tmp_path / name, "w") as f:
            tracker.print(f)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    assert ours.as_dict().keys() == theirs.as_dict().keys() and ours.has("depth_rmse")


def test_results_without_cv2_are_png(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(image_io, "cv2", None)
    rng = np.random.default_rng(4)
    images = {"rgbs": rng.uniform(size=(2, 8, 12, 3)).astype(np.float32),
              "depths": rng.uniform(size=(2, 8, 12, 1)).astype(np.float32)}
    tracker = MeanTracker()
    tracker.add({"psnr": 20.0, "lpips": float("nan")})
    out = write_images_with_metrics(images, tracker, 6.0, str(tmp_path), "exp", "scene")
    assert out == str(tmp_path / "exp" / "test_images_scene")
    assert sorted(os.listdir(out)) == ["0_d.png", "0_rgb.png", "1_d.png", "1_rgb.png",
                                       "metrics.txt"]
    assert "no cv2" in capsys.readouterr().out
    np.testing.assert_array_equal(image_io.read_depth_png(os.path.join(out, "1_d.png")),
                                  metrics.to16b(images["depths"][1])[..., 0])
    assert (tmp_path / "exp" / "test_images_scene" / "metrics.txt").read_text() == \
        "psnr: 20.0\nlpips: nan\n"


def test_writer_without_tensorboard_writes_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = Writer(str(tmp_path / "run"))
    assert tb._tb is None
    tb.add_scalars("psnr", {"train": 20.5}, 10)
    tb.add_scalar("ssim", 0.5, 10)
    tb.add_image("val_image", np.zeros((4, 4, 3)), 10)
    tb.close()
    assert os.listdir(tmp_path / "run") == ["scalars.jsonl"]
    lines = [json.loads(x) for x in (tmp_path / "run" / "scalars.jsonl").read_text().splitlines()]
    assert lines == [{"tag": "psnr", "values": {"train": 20.5}, "step": 10},
                     {"tag": "ssim", "value": 0.5, "step": 10}]
