"""Host-side scene IO: transforms_*.json scenes and cIMLE depth hypotheses.

The reference's on-disk contracts (reference: data/load_scene.py), as the JAX
package's ``scade_tpu/data/scene.py`` reads them:
``transforms_{train,val,test,video}.json`` with per-frame ``file_path``,
``depth_file_path``, ``transform_matrix``, ``fx/fy/cx/cy``; top-level
``near``/``far``/``depth_scaling_factor`` in the train split; GT depth through
the ``rgb → target_depth`` filename swap; hypothesis dumps at
``<scene>/train/leres_cimle/<cimle_dir>/<img_id>_<k>.npy``.

Everything here is numpy on the host; the train loop moves the arrays to the
device once. Hypotheses are read in parallel by the native scene cache
(``data/native_cache.py``) and packed into ``.scade_hyp_cache.blob`` beside
the dump, with a ``.json`` sidecar of each file's (mtime_ns, size): the JAX
package's cache format, so either package reads the other's blob.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from scade_tpu_torch.data import native_cache
from scade_tpu_torch.data.image_io import read_depth_png, read_image

SPLITS = ("train", "val", "test", "video")


@dataclasses.dataclass
class Scene:
    """A loaded scene: the reference's 13-tuple as named fields."""

    images: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    depths: np.ndarray  # (N, H, W, 1) float32 meters
    valid_depths: np.ndarray  # (N, H, W) bool
    poses: np.ndarray  # (N, 4, 4) float32 camera-to-world
    H: int
    W: int
    intrinsics: np.ndarray  # (N, 4) float32 (fx, fy, cx, cy)
    near: float
    far: float
    i_split: List[np.ndarray]  # [i_train, i_val, i_test, i_video]
    gt_depths: Optional[np.ndarray]  # (N, H, W, 1) or None
    gt_valid_depths: Optional[np.ndarray]  # (N, H, W) or None
    depth_hypothesis: Optional[np.ndarray]  # (N_train, K, H, W, 1) or None
    filenames: List[str] = dataclasses.field(default_factory=list)
    scales_init: Optional[np.ndarray] = None
    shifts_init: Optional[np.ndarray] = None
    # how the hypotheses were read: "npy" (the .npy files) or "blob" (the
    # cache), then ":native" or ":numpy"; None without hypotheses
    hypothesis_load: Optional[str] = None

    @property
    def i_train(self):
        return self.i_split[0]

    @property
    def i_val(self):
        return self.i_split[1]

    @property
    def i_test(self):
        return self.i_split[2]

    @property
    def i_video(self):
        return self.i_split[3]


def read_files(basedir: str, rgb_file: str, depth_file: str):
    """RGB(A) image / 255 and the raw depth as float64 (data/load_scene.py:16-26)."""
    img = read_image(os.path.join(basedir, rgb_file))
    depth = read_depth_png(os.path.join(basedir, depth_file))
    return img, depth.astype(np.float64)


def load_ground_truth_depth(basedir, train_filenames, image_size, depth_scaling_factor):
    """GT depth through the rgb → target_depth filename swap; zeros and an
    all-invalid mask where the file is missing (data/load_scene.py:72-91)."""
    H, W = image_size
    gt_depths, gt_valid_depths = [], []
    for filename in train_filenames:
        filename = filename.replace("rgb", "target_depth").replace(".jpg", ".png")
        path = os.path.join(basedir, filename)
        if os.path.exists(path):
            gt = read_depth_png(path).astype(np.float64)
            valid = gt > 0.5
            gt = (gt / depth_scaling_factor).astype(np.float32)
        else:
            gt = np.zeros((H, W), dtype=np.float32)
            valid = np.zeros((H, W), dtype=bool)
        gt_depths.append(gt[..., None])
        gt_valid_depths.append(valid)
    return np.stack(gt_depths, 0), np.stack(gt_valid_depths, 0)


def _load_splits(basedir: str, train_json: str, depth_ext_png: bool = False):
    """Shared frame-loading core of all loaders."""
    all_imgs, all_depths, all_valid = [], [], []
    all_poses, all_intr = [], []
    counts = [0]
    filenames = []
    near = far = depth_scaling_factor = None
    H = W = None

    for s in SPLITS:
        # the train split reads the (possibly custom) --train_jsonfile, and its
        # existence is checked on that file
        split_json = os.path.join(basedir, train_json if s == "train" else f"transforms_{s}.json")
        if not os.path.exists(split_json):
            counts.append(counts[-1])
            continue
        with open(split_json, "r") as fp:
            meta = json.load(fp)
        if s == "train":
            near = float(meta["near"])
            far = float(meta["far"])
            depth_scaling_factor = float(meta["depth_scaling_factor"])

        poses, intrinsics = [], []
        imgs, depths, valids = [], [], []
        for frame in meta["frames"]:
            if len(frame["file_path"]) != 0 or len(frame["depth_file_path"]) != 0:
                depth_path = frame["depth_file_path"]
                if depth_ext_png:
                    depth_path = depth_path.split(".")[0] + ".png"
                img, depth = read_files(basedir, frame["file_path"], depth_path)
                if depth.ndim == 2:
                    depth = depth[..., None]
                valid = depth[:, :, 0] > 0.5  # 0 marks invalid depth
                depth = (depth / depth_scaling_factor).astype(np.float32)
                filenames.append(frame["file_path"])
                imgs.append(img)
                depths.append(depth)
                valids.append(valid)
                H, W = img.shape[:2]
            poses.append(np.array(frame["transform_matrix"]))
            intrinsics.append(np.array((frame["fx"], frame["fy"], frame["cx"], frame["cy"])))

        counts.append(counts[-1] + len(poses))
        if imgs:
            all_imgs.append(np.array(imgs))
            all_depths.append(np.array(depths))
            all_valid.append(np.array(valids))
        if poses:  # a split may have zero frames
            all_poses.append(np.array(poses).astype(np.float32))
            all_intr.append(np.array(intrinsics).astype(np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(len(SPLITS))]
    return (
        np.concatenate(all_imgs, 0),
        np.concatenate(all_depths, 0),
        np.concatenate(all_valid, 0),
        np.concatenate(all_poses, 0),
        np.concatenate(all_intr, 0),
        H, W, near, far, depth_scaling_factor, i_split, filenames,
    )


def _image_id(filename: str) -> str:
    return filename.split("/")[-1].split(".")[0]


def _stat_sig(path: str):
    st = os.stat(path)
    return int(st.st_mtime_ns), int(st.st_size)


def _load_hypotheses(basedir, cimle_dir, filenames, i_train, num_hypothesis, near,
                     far) -> Tuple[np.ndarray, str]:
    """The cIMLE hypothesis dumps, clipped to [near, far]
    (data/load_scene.py:316-349): (N_train, K, H, W, 1) float32, and how
    they were read (see Scene.hypothesis_load).

    The files are read in parallel through the native library, and packed
    into a blob with a sidecar that lists each file's (mtime_ns, size), as
    the JAX loader does (scade_tpu/data/scene.py:208-274): a later load whose
    files all match the sidecar reads the blob, one sequential read; any
    changed file makes the blob stale, and the files are read again. A dump
    directory that cannot be written to is read without the cache."""
    leres_dir = os.path.join(basedir, "train", "leres_cimle", cimle_dir)
    paths = [os.path.join(leres_dir, f"{_image_id(filenames[idx])}_{j}.npy")
             for idx in i_train for j in range(num_hypothesis)]
    if not paths:
        return np.zeros((0, num_hypothesis, 0, 0, 1), np.float32), "npy:numpy"
    H, W = np.load(paths[0], mmap_mode="r").shape

    blob = os.path.join(leres_dir, ".scade_hyp_cache.blob")
    meta_path = blob + ".json"
    meta = {"files": [[os.path.basename(p), *_stat_sig(p)] for p in paths], "shape": [H, W]}
    flats = None
    if os.path.exists(blob) and os.path.exists(meta_path):
        try:
            with open(meta_path) as fp:
                if json.load(fp) == meta:
                    flats, how = native_cache.read_blob(blob)
                    how = "blob:" + how
        except (OSError, ValueError):
            flats = None  # a corrupt cache: read the files
    if flats is None:
        flats, how = native_cache.load_npy_batch(paths)
        how = "npy:" + how
        try:
            native_cache.write_blob(blob, flats)
            with open(meta_path + ".tmp", "w") as fp:
                json.dump(meta, fp)
            os.replace(meta_path + ".tmp", meta_path)
        except OSError:
            pass  # a read-only dump directory: later loads read the files again
    all_hyp = np.stack(flats, 0).reshape(len(i_train), num_hypothesis, H, W, 1)
    return np.clip(all_hyp, near, far), how


def _load_scale_shift_init(basedir, scales_dir, filenames, i_train, gt_init):
    scale_shift_dir = os.path.join(basedir, "train", "scale_shift_inits", scales_dir)
    suffix = "_gtinit.npy" if gt_init else "_sfminit.npy"
    scales, shifts = [], []
    for idx in i_train:
        ss = np.load(os.path.join(scale_shift_dir, _image_id(filenames[idx]) + suffix))
        ss = ss.astype(np.float32)
        scales.append(ss[0])
        shifts.append(ss[1])
    return np.array(scales), np.array(shifts)


def load_scene(basedir, train_json="transforms_train.json") -> Scene:
    """Plain scene with GT depth, no hypotheses (data/load_scene.py:93-165)."""
    imgs, depths, valid, poses, intr, H, W, near, far, dsf, i_split, fnames = (
        _load_splits(basedir, train_json)
    )
    gt_d, gt_v = load_ground_truth_depth(basedir, fnames, (H, W), dsf)
    return Scene(imgs, depths, valid, poses, H, W, intr, near, far, i_split,
                 gt_d, gt_v, None, fnames)


def load_scene_scannet(basedir, cimle_dir, num_hypothesis=20, train_json="transforms_train.json",
                       init_scales=False, scales_dir=None, gt_init=False) -> Scene:
    """ScanNet scene: GT depth + cIMLE hypotheses (data/load_scene.py:243-383)."""
    imgs, depths, valid, poses, intr, H, W, near, far, dsf, i_split, fnames = (
        _load_splits(basedir, train_json)
    )
    gt_d, gt_v = load_ground_truth_depth(basedir, fnames, (H, W), dsf)
    hyp, how = _load_hypotheses(basedir, cimle_dir, fnames, i_split[0], num_hypothesis, near,
                                far)
    scene = Scene(imgs, depths, valid, poses, H, W, intr, near, far, i_split,
                  gt_d, gt_v, hyp, fnames, hypothesis_load=how)
    if init_scales:
        scene.scales_init, scene.shifts_init = _load_scale_shift_init(
            basedir, scales_dir, fnames, i_split[0], gt_init)
    return scene


def load_scene_nogt(basedir, train_json="transforms_train.json") -> Scene:
    """Depth files forced to .png, no GT depth, no hypotheses
    (data/load_scene.py:167-240)."""
    imgs, depths, valid, poses, intr, H, W, near, far, dsf, i_split, fnames = (
        _load_splits(basedir, train_json, depth_ext_png=True)
    )
    return Scene(imgs, depths, valid, poses, H, W, intr, near, far, i_split,
                 None, None, None, fnames)


def load_scene_processed(basedir, cimle_dir, num_hypothesis=20,
                         train_json="transforms_train.json", init_scales=False,
                         scales_dir=None, gt_init=False) -> Scene:
    """In-the-Wild / TnT scene: hypotheses, no GT depth, depth files forced to
    .png (data/load_scene.py:386-532)."""
    imgs, depths, valid, poses, intr, H, W, near, far, dsf, i_split, fnames = (
        _load_splits(basedir, train_json, depth_ext_png=True)
    )
    hyp, how = _load_hypotheses(basedir, cimle_dir, fnames, i_split[0], num_hypothesis, near,
                                far)
    scene = Scene(imgs, depths, valid, poses, H, W, intr, near, far, i_split,
                  None, None, hyp, fnames, hypothesis_load=how)
    if init_scales:
        scene.scales_init, scene.shifts_init = _load_scale_shift_init(
            basedir, scales_dir, fnames, i_split[0], gt_init)
    return scene
