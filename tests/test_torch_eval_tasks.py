"""The port's eval tasks and their helpers against scade_tpu on the CPU:
``ndc_rays``, ``dataset_sampling``, the MJPEG AVI writer, per-image camera
latents in ``render_images_with_metrics``, ``optimize_camera_embedding`` and
``render_video``'s frames.

Same weights on both sides (JAX params carried into the port's state_dict).
Tolerances:
- ndc_rays: atol 1e-6 (elementwise f32 arithmetic in one order on both sides);
- dataset_sampling: exact (the same numpy code and generator);
- optimize_camera_embedding at 3 Adam steps: rtol 1e-4, atol 1e-5. The
  renders agree to ~1e-6 (tests/test_torch_render.py), and Adam's first
  steps move each latent entry by about lr whatever the gradient's size;
- render_video's frames before JPEG encoding: at least 99.9% of the uint8
  values equal and none off by more than 1. The maps agree to ~1e-6, so a
  value differs only where depth/far or the depth's std lies on a rounding
  boundary of to8b.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.data import dataset_sampling as jsampling
from scade_tpu.eval import evaluate as jevaluate
from scade_tpu.models.nerf import nerf_init, params_to_torch_state_dict
from scade_tpu.ops import rays as jrays
from scade_tpu.render import renderer as jrenderer
from scade_tpu_torch.data import dataset_sampling
from scade_tpu_torch.eval import evaluate
from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.ops.rays import ndc_rays
from scade_tpu_torch.render import renderer
from scade_tpu_torch.utils.video import encode_frames_bgr, write_mjpeg_avi

SMALL = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_scenes(input_ch_cam=0, seed=0):
    """The JAX package's and the port's SceneVars on the same weights."""
    jrc = jrenderer.make_render_config(**SMALL, input_ch_cam=input_ch_cam)
    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    pc, pf = nerf_init(kc, jrc.nerf_coarse), nerf_init(kf, jrc.nerf_fine)
    jscene = jrenderer.SceneVars(pc, pf, jnp.zeros((3,)), jnp.float32(0.5),
                                 jnp.zeros((input_ch_cam,), jnp.float32))
    rc = renderer.make_render_config(**SMALL, input_ch_cam=input_ch_cam, device="cpu")

    def load(cfg, params):
        model = NeRF(cfg)
        sd = params_to_torch_state_dict(jax.tree.map(np.asarray, params))
        model.load_state_dict({k.removeprefix("module."): torch.from_numpy(np.array(v))
                               for k, v in sd.items()}, strict=True)
        return model

    scene = renderer.SceneVars(load(rc.nerf_coarse, pc), load(rc.nerf_fine, pf), torch.zeros(3),
                               torch.tensor(0.5), torch.zeros(input_ch_cam))
    return jrc, jscene, rc, scene


def test_ndc_rays_matches_jax():
    rng = np.random.default_rng(0)
    ro = (rng.normal(size=(64, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5  # looking down -z, as the reference's cameras do
    H, W, focal, near = 48, 64, 40.0, 1.0
    o, d = ndc_rays(H, W, focal, near, torch.from_numpy(ro), torch.from_numpy(rd))
    jo, jd = jrays.ndc_rays(H, W, focal, near, jnp.asarray(ro), jnp.asarray(rd))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("count,at_least", [(10, 3), (100, 7), (7, 10), (64, 64), (1000, 33)])
def test_dataset_sampling_matches_jax(count, at_least):
    assert (dataset_sampling.compute_samples_per_subset(count, at_least)
            == jsampling.compute_samples_per_subset(count, at_least))
    ours = dataset_sampling.create_random_subsets(range(count), at_least,
                                                  np.random.default_rng(count))
    theirs = jsampling.create_random_subsets(range(count), at_least, np.random.default_rng(count))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(ours).tolist()) == list(range(count))
    assert all(len(x) >= min(at_least, count) for x in ours)


def test_mjpeg_avi_roundtrip(tmp_path):
    frames = []
    for i in range(6):
        f = np.zeros((48, 64, 3), np.uint8)
        f[:, : (i + 1) * 10] = (255, 128, 0)
        frames.append(f)
    path = str(tmp_path / "clip.avi")
    write_mjpeg_avi(path, encode_frames_bgr(frames), (64, 48), fps=5)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == 5.0
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 6.0
    n = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        assert img.shape == (48, 64, 3)
        assert img[0, 5, 0] > 200  # frame n paints its first (n+1)*10 columns
        if (n + 1) * 10 < 60:
            assert img[0, 62, 0] < 50, (n, img[0, 62])
        n += 1
    assert n == 6


def test_mjpeg_avi_odd_dimensions(tmp_path):
    frames = [np.full((33, 47, 3), 77, np.uint8) for _ in range(2)]
    path = str(tmp_path / "odd.avi")
    write_mjpeg_avi(path, encode_frames_bgr(frames), (47, 33), fps=3)
    cap = cv2.VideoCapture(path)
    ok, img = cap.read()
    assert ok and img.shape == (33, 47, 3)
    assert abs(int(img[10, 10, 1]) - 77) < 5


def test_embedded_cams_align_on_random_subset():
    """With count < len(indices) the views come in a random order; each must
    still render with the latent at its position in ``indices``."""
    _, _, rc, scene = both_scenes(input_ch_cam=4)
    H = W = 8
    n_img = 3
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (n_img, H, W, 3)).astype(np.float32)
    common = dict(indices=np.arange(n_img), images=images,
                  depths=np.ones((n_img, H, W, 1), np.float32),
                  valid_depths=np.ones((n_img, H, W), bool),
                  poses=np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1)), H=H, W=W,
                  intrinsics=np.tile(np.array([8.0, 8.0, 4.0, 4.0], np.float32), (n_img, 1)),
                  scene=scene, rc=rc, near=0.1, far=8.0, chunk=256, verbose=False,
                  embedded_cams=np.linspace(-1.0, 1.0, n_img * 4).astype(np.float32)
                  .reshape(n_img, 4))
    _, full = evaluate.render_images_with_metrics(None, **common)
    # the poses are equal, so only the latents tell the views' renders apart
    assert not np.array_equal(full["rgbs"][0], full["rgbs"][1])
    _, sub = evaluate.render_images_with_metrics(2, rng=np.random.default_rng(7), **common)
    for k in range(2):
        i = [i for i in range(n_img) if np.array_equal(full["target_rgbs"][i],
                                                       sub["target_rgbs"][k])]
        assert len(i) == 1
        np.testing.assert_array_equal(sub["rgbs"][k], full["rgbs"][i[0]])


def test_optimize_camera_embedding_matches_jax():
    jrc, jscene, rc, scene = both_scenes(input_ch_cam=4, seed=3)
    H, W = 8, 12
    image = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    intr = np.array([10.0, 10.0, 6.0, 4.0], np.float32)
    ours = evaluate.optimize_camera_embedding(image, pose, H, W, intr, scene, rc, 0.1, 8.0,
                                              input_ch_cam=4, n_rand=16, steps=3)
    theirs = np.asarray(jevaluate.optimize_camera_embedding(
        image, pose, H, W, intr, jscene, jrc, 0.1, 8.0, input_ch_cam=4, n_rand=16, steps=3))
    assert ours.shape == (4,) and ours.dtype == np.float32
    assert np.abs(theirs).max() > 0.1  # the latent moved
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def capture_frames(monkeypatch):
    """Records every frame cv2.imwrite is given (and still writes it)."""
    frames = {}
    write = cv2.imwrite

    def imwrite(path, img, *args):
        frames[os.path.basename(path)] = img.copy()
        return write(path, img, *args)

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return frames


def test_render_video_frames_match_jax(tmp_path, monkeypatch):
    jrc, jscene, rc, scene = both_scenes(seed=5)
    H, W, n = 18, 24, 4
    poses = np.stack([np.array([[1, 0, 0, 0.1 * k], [0, 1, 0, 0], [0, 0, 1, 0.5], [0, 0, 0, 1]],
                               np.float32) for k in range(n)])
    intr = np.tile(np.array([20.0, 20.0, 12.0, 9.0], np.float32), (n, 1))
    frames = capture_frames(monkeypatch)
    theirs = jevaluate.render_video(poses, H, W, intr, "0", str(tmp_path), "jax", jscene, jrc,
                                    0.5, 6.0, chunk=256)
    jax_frames = dict(frames)
    frames.clear()
    ours = evaluate.render_video(poses, H, W, intr, "0", str(tmp_path), "port", scene, rc,
                                 0.5, 6.0, chunk=256)
    assert sorted(frames) == sorted(jax_frames) == ["0.jpg", "3.jpg"]
    w_out = int(H / 9.0 * 16.0 / 3.0) // 2 * 2
    for name, ref in jax_frames.items():
        got = frames[name]
        assert got.shape == ref.shape == (H, 3 * w_out, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1, name
        assert (diff == 0).mean() >= 0.999, name
    # the same encoder chain picks the same container, and it decodes to the frames
    assert os.path.splitext(ours)[1] == os.path.splitext(theirs)[1]
    cap = cv2.VideoCapture(ours)
    n_read = 0
    while cap.read()[0]:
        n_read += 1
    assert n_read == 2
