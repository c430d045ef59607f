"""The port's profiling hooks and depth-completion data helpers against the
JAX package's on the CPU: ``utils/profiling.py``, ``data/error_sources.py``
and ``data/scannet_dataset.py``.

The error sources are fed the JAX package's own ``jax.random`` draws; the
datasets read one corpus in the reference layout
(tests/test_taskonomy_dataset.py's: JPEG rgb, 16-bit depth, COLMAP
keypoints in SQLite) with the same numpy seeds.

Tolerances: none but one. Drop masks, datasets' examples and the helpers'
outputs are equal bit for bit; the quadratic noise within 1e-6 relative
(XLA may fuse a·d² + b·d + c into FMAs; measured equal here).
"""

import json
import math
import os
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from scade_tpu.data import error_sources as jerr
from scade_tpu.data import scannet_dataset as jsd
from scade_tpu_torch import data as pdata
from scade_tpu_torch.data import error_sources as perr
from scade_tpu_torch.data import scannet_dataset as psd
from scade_tpu_torch.utils import profiling as pprof


def test_trace_annotate_and_nan_debugging(tmp_path):
    with pprof.trace(str(tmp_path)):
        with pprof.span("prior_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / pprof.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "prior_step" for e in events)

    x = torch.zeros(3, requires_grad=True)
    pprof.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        pprof.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------------------
# error sources
# ---------------------------------------------------------------------------


def depth_case(seed, sparse):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.2, 6.0, (12, 16)).astype(np.float32)
    valid = rng.uniform(size=(12, 16)) < (0.05 if sparse else 0.97)
    depth[~valid] = rng.uniform(7, 9, (~valid).sum())  # invalid pixels keep their value
    return depth, valid


@pytest.mark.parametrize("sparse,p", [(False, 0.3), (False, 0.998), (True, 0.3), (False, 0.0)])
def test_add_missing_depth_on_jax_draws(sparse, p):
    depth, valid = depth_case(5, sparse)
    key = jax.random.PRNGKey(6)
    ref_d, ref_v = jerr.add_missing_depth(key, jnp.asarray(depth), jnp.asarray(valid), p=p,
                                          invalid_depth_value=-1.0)
    u = torch.from_numpy(np.array(jax.random.uniform(key, depth.shape)))
    got_d, got_v = perr.add_missing_depth(torch.from_numpy(depth), torch.from_numpy(valid), p=p,
                                          invalid_depth_value=-1.0, u=u)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    assert got_d.dtype == torch.float32
    if sparse or p == 0.0:
        assert torch.equal(got_v, torch.from_numpy(valid))  # a no-op
    own_d, own_v = pdata.add_missing_depth(torch.from_numpy(depth), torch.from_numpy(valid), p=p,
                                           generator=torch.Generator().manual_seed(0))
    assert not (own_v & ~torch.from_numpy(valid)).any()


def test_add_quadratic_depth_noise_on_jax_draws():
    depth, valid = depth_case(7, False)
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jerr.add_quadratic_depth_noise(key, jnp.asarray(depth), jnp.asarray(valid)))
    noise = torch.from_numpy(np.array(jax.random.normal(key, depth.shape)))
    got = perr.add_quadratic_depth_noise(torch.from_numpy(depth), torch.from_numpy(valid),
                                         noise=noise).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[~valid], depth[~valid])
    own = pdata.add_quadratic_depth_noise(torch.from_numpy(depth), torch.from_numpy(valid),
                                          generator=torch.Generator().manual_seed(1))
    assert (own >= 0).all() and not torch.equal(own, torch.from_numpy(depth))


# ---------------------------------------------------------------------------
# scannet_dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_taskonomy_dataset.py's layout; one rgb at 968×1296 for the
    padding path, one rgb with no database entry."""
    root = tmp_path_factory.mktemp("depth_completion")
    ds_dir = root / "taskonomy"
    (ds_dir / "annotations").mkdir(parents=True)
    for sub in ("color", "depth"):
        (root / "imgs" / "scene" / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    db = str(root / "features.db")
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE images (name TEXT, image_id INTEGER)")
    con.execute("CREATE TABLE keypoints (image_id INTEGER, data BLOB)")
    annos, depth_files, rgb_files = [], [], []
    for i, (h, w) in enumerate([(48, 64), (968, 1296), (48, 64), (48, 64)]):
        rgb = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "imgs/scene/color" / f"{i}.jpg"), rgb[:, :, ::-1])
        dh, dw = (480, 640) if h == 968 else (h, w)
        depth = rng.integers(200, 26000, (dh, dw), dtype=np.uint16)
        depth[:2] = 0
        cv2.imwrite(str(root / "imgs/scene/depth" / f"{i}.png"), depth)
        annos.append({"rgb_path": f"imgs/scene/color/{i}.jpg",
                      "depth_path": f"imgs/scene/depth/{i}.png"})
        rgb_files.append(str(root / "imgs/scene/color" / f"{i}.jpg"))
        depth_files.append(str(root / "imgs/scene/depth" / f"{i}.png"))
        if i == 3:
            continue  # no database entry: zero sparse depth
        con.execute("INSERT INTO images VALUES (?, ?)", (f"scene/color/{i}.jpg", i + 1))
        kp = np.zeros((300, 6), np.float32)
        kp[:, 0] = rng.uniform(0, w, 300)
        kp[:, 1] = rng.uniform(0, h, 300)
        con.execute("INSERT INTO keypoints VALUES (?, ?)", (i + 1, kp.tobytes()))
    con.commit()
    con.close()
    with open(ds_dir / "annotations" / "train_annotations.json", "w") as f:
        json.dump(annos, f)
    return dict(ds_dir=str(ds_dir), db=db, rgb=rgb_files, depth=depth_files)


def assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def test_helpers_match_jax(corpus, tmp_path):
    d_ref, v_ref = jsd.read_depth(corpus["depth"][0])
    d, v = psd.read_depth(corpus["depth"][0])
    assert np.array_equal(d, d_ref) and np.array_equal(v, v_ref) and d.dtype == d_ref.dtype
    assert psd.read_depth(str(tmp_path / "missing.png")) == (None, None)
    x = np.linspace(0, 1, 17)
    for name in ("convert_depth_completion_scaling_to_m", "convert_m_to_depth_completion_scaling",
                 "convert_depth_completion_scaling_to_m_taskonomy",
                 "convert_m_to_depth_completion_scaling_taskonomy"):
        assert np.array_equal(getattr(psd, name)(x), getattr(jsd, name)(x)), name
    for got, ref in zip(psd.get_pretrained_normalize(), jsd.get_pretrained_normalize()):
        for k in ref:
            for g, r in zip(got[k], ref[k]):
                assert np.array_equal(g, r) and g.dtype == r.dtype
    rng = np.random.default_rng(9)
    dd = rng.uniform(0, 1, (2, 12, 16))
    vv = rng.uniform(size=(2, 12, 16)) < 0.2
    for size in ((24, 32), (7, 9), (12, 16)):
        got = psd.resize_sparse_depth(dd, vv, size)
        assert all(np.array_equal(g, r) for g, r in zip(got, jsd.resize_sparse_depth(dd, vv, size)))
    for scale, pad in (((1.0, 1.0), 0), ((0.5, 0.5), 2)):
        got = psd.sample_depth_at_image_features(d, v, corpus["db"], 1, scale, pad)
        ref = jsd.sample_depth_at_image_features(d, v, corpus["db"], 1, scale, pad)
        assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    assert all(not a.any() for a in psd.sample_depth_at_image_features(d, v, corpus["db"], 99))
    got = psd._add_missing_depth_np(np.random.default_rng(3), d, v, 0.9)
    ref = jsd._add_missing_depth_np(np.random.default_rng(3), d, v, 0.9)
    assert all(np.array_equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("opts", [
    dict(missing_depth_percent=0.0),
    dict(random_rot=5, horizontal_flip=True, color_jitter=0.3, depth_noise=True),
], ids=["plain", "augmented"])
def test_taskonomy_dataset_matches_jax(corpus, opts):
    j = jsd.TaskonomyDataset(corpus["ds_dir"], "train", corpus["db"], load_size=(24, 32),
                             rng=np.random.default_rng(11), **opts)
    p = psd.TaskonomyDataset(corpus["ds_dir"], "train", corpus["db"], load_size=(24, 32),
                             rng=np.random.default_rng(11), **opts)
    assert len(p) == len(j) == 4
    for i in range(4):
        assert_same(p[i], j[i])
    assert p[1]["found"] and p[0]["valid_depth"].any() and not p[3]["valid_depth"].any()


def test_scannet_dataset_matches_jax(corpus):
    args = (corpus["rgb"][:1] + corpus["rgb"][2:3], corpus["depth"][:1] + corpus["depth"][2:3])
    for db in (None, corpus["db"]):
        kw = dict(feature_db=db, db_ids=[1, 3]) if db else {}
        j, p = jsd.ScanNetDataset(*args, **kw), psd.ScanNetDataset(*args, **kw)
        for i in range(2):
            assert_same(p[i], j[i])
    assert math.isclose(float(p[0]["rgbd"][..., 3].max()), float(j[0]["rgbd"][..., 3].max()))
    missing = psd.ScanNetDataset(corpus["rgb"][:1], [os.path.join(corpus["ds_dir"], "no.png")])
    with pytest.raises(FileNotFoundError):
        missing[0]
