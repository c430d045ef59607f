"""The port's native scene cache (``scade_tpu_torch/data/native_cache.py``,
built from ``native/scene_cache.cc``) and the hypothesis blob cache of
``data/scene.py``, against ``np.load`` and against scade_tpu's loader: every
array here must be bit-equal, whichever path read or wrote it."""

import json
import os
import shutil

import numpy as np
import pytest

from scade_tpu.data import native_cache as jnative
from scade_tpu.data import scene as jscene
from scade_tpu_torch.data import native_cache
from scade_tpu_torch.data import scene as pscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_dump(base, n_img=2, K=3, H=6, W=7, seed=0):
    """A dump directory of K hypothesis maps per image, and its file names."""
    rng = np.random.default_rng(seed)
    leres = base / "train" / "leres_cimle" / "dump"
    leres.mkdir(parents=True)
    for i in range(n_img):
        for k in range(K):
            np.save(leres / f"{i}_{k}.npy", rng.uniform(0.0, 10.0, (H, W)).astype(np.float32))
    return leres, [f"train/rgb/{i}.jpg" for i in range(n_img)]


def test_library_builds_into_the_package():
    lib = native_cache.load()
    if shutil.which("g++") is None:
        assert lib is None  # the numpy path is the one that runs
        return
    assert lib is not None
    path = native_cache.library_path()
    assert path.exists() and path.parent == native_cache.BUILD
    assert os.path.relpath(path, REPO).startswith(os.path.join("scade_tpu_torch", "_build"))
    assert native_cache.SOURCE == native_cache.Path(REPO, "native", "scene_cache.cc")


def test_native_arrays_bitwise_equal_np_load(tmp_path):
    leres, _ = write_dump(tmp_path, n_img=3, K=4, H=5, W=9)
    paths = sorted(str(p) for p in leres.glob("*.npy"))
    arrays, how = native_cache.load_npy_batch(paths)
    assert how == ("native" if shutil.which("g++") else "numpy")
    for p, a in zip(paths, arrays):
        np.testing.assert_array_equal(a, np.load(p).ravel())
        assert a.dtype == np.float32


@pytest.mark.parametrize("writer", ["native", "numpy"])
@pytest.mark.parametrize("reader", ["native", "numpy", "scade_tpu"])
def test_blob_formats_cross(tmp_path, monkeypatch, writer, reader):
    """A blob from either path of the port reads back equal through either
    path and through scade_tpu's reader; one from scade_tpu reads in the
    port."""
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(n).astype(np.float32) for n in (5, 1, 12)]
    blob = str(tmp_path / "x.blob")
    with monkeypatch.context() as m:
        if writer == "numpy":
            m.setattr(native_cache, "load", lambda: None)
        assert native_cache.write_blob(blob, arrays) in ("native", "numpy")
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    with monkeypatch.context() as m:
        if reader == "numpy":
            m.setattr(native_cache, "load", lambda: None)
        back = (jnative.read_blob(blob) if reader == "scade_tpu"
                else native_cache.read_blob(blob)[0])
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)

    jblob = str(tmp_path / "j.blob")
    jnative.write_blob(jblob, arrays)
    for a, b in zip(arrays, native_cache.read_blob(jblob)[0]):
        np.testing.assert_array_equal(a, b)


def test_bad_blob_raises(tmp_path):
    bad = tmp_path / "bad.blob"
    bad.write_bytes(b"NOTABLOB" + b"\0" * 16)
    with pytest.raises(OSError):
        native_cache.read_blob(str(bad))


def hyps(module, base, fnames, K):
    out = module._load_hypotheses(str(base), "dump", fnames, [0, 1], K, 0.5, 8.0)
    return out if isinstance(out, tuple) else (out, None)


def test_hypothesis_blob_crosses_packages(tmp_path):
    """The port writes the blob and its sidecar; scade_tpu reads that blob
    (and leaves it as it is); and the reverse."""
    K = 3
    leres, fnames = write_dump(tmp_path / "a", K=K)
    ours, how = hyps(pscene, tmp_path / "a", fnames, K)
    blob = leres / ".scade_hyp_cache.blob"
    assert how.startswith("npy:") and blob.exists()
    meta = json.loads((leres / ".scade_hyp_cache.blob.json").read_text())
    assert meta["shape"] == [6, 7] and len(meta["files"]) == 2 * K
    stamp = blob.stat().st_mtime_ns
    theirs, _ = hyps(jscene, tmp_path / "a", fnames, K)
    np.testing.assert_array_equal(ours, theirs)
    assert blob.stat().st_mtime_ns == stamp  # read, not rewritten

    leres_b, _ = write_dump(tmp_path / "b", K=K)
    theirs_b, _ = hyps(jscene, tmp_path / "b", fnames, K)
    ours_b, how_b = hyps(pscene, tmp_path / "b", fnames, K)
    assert how_b.startswith("blob:")
    np.testing.assert_array_equal(ours_b, theirs_b)
    assert ours_b.shape == (2, K, 6, 7, 1) and ours_b.min() >= 0.5 and ours_b.max() <= 8.0


def test_stale_sidecar_forces_a_reload(tmp_path):
    K = 2
    leres, fnames = write_dump(tmp_path, K=K)
    first, how1 = hyps(pscene, tmp_path, fnames, K)
    second, how2 = hyps(pscene, tmp_path, fnames, K)
    assert how1.startswith("npy:") and how2.startswith("blob:")
    np.testing.assert_array_equal(first, second)
    # a file changes (new content, so a new mtime and size): the blob is stale
    np.save(leres / "1_1.npy", np.full((6, 7), 3.0, np.float32))
    os.utime(leres / "1_1.npy", ns=(1, 1))
    third, how3 = hyps(pscene, tmp_path, fnames, K)
    assert how3.startswith("npy:")
    np.testing.assert_array_equal(third[1, 1], np.full((6, 7, 1), 3.0, np.float32))
    np.testing.assert_array_equal(third[0], first[0])
    fourth, how4 = hyps(pscene, tmp_path, fnames, K)
    assert how4.startswith("blob:")
    np.testing.assert_array_equal(fourth, third)
    # a corrupt blob with a matching sidecar: read the files again
    (leres / ".scade_hyp_cache.blob").write_bytes(b"garbage")
    fifth, how5 = hyps(pscene, tmp_path, fnames, K)
    assert how5.startswith("npy:")
    np.testing.assert_array_equal(fifth, third)


def test_numpy_path_without_the_library(tmp_path, monkeypatch):
    """Without g++ the loader takes numpy's path, with the same arrays and the
    same cache."""
    K = 2
    _, fnames = write_dump(tmp_path, K=K)
    monkeypatch.setattr(native_cache.shutil, "which", lambda name: None)
    monkeypatch.setattr(native_cache, "_loaded", {})
    assert native_cache.load() is None
    plain, how = hyps(pscene, tmp_path, fnames, K)
    assert how == "npy:numpy"
    again, how2 = hyps(pscene, tmp_path, fnames, K)
    assert how2 == "blob:numpy"
    np.testing.assert_array_equal(plain, again)
    monkeypatch.undo()
    via_lib, how3 = hyps(pscene, tmp_path, fnames, K)
    assert how3 == ("blob:native" if shutil.which("g++") else "blob:numpy")
    np.testing.assert_array_equal(via_lib, plain)
