"""Colored point clouds of the hypothesis dump's previews (``--save_previews``).

The port's copy of ``scade_tpu/prior/pointcloud.py``'s writer (reference:
ambiguity_aware_prior/tools/utils.py:70-160: save_point_cloud,
reconstruct_depth, reconstruct_depth_intrinsics), numpy only, with a
self-contained PLY writer in place of plyfile.
"""

from __future__ import annotations

import os

import numpy as np


def save_point_cloud(points: np.ndarray, rgb: np.ndarray, filename: str,
                     binary: bool = True) -> None:
    """Write an (N, 3) float point cloud with (N, 3) uint8/float colors to PLY."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb).reshape(-1, 3)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * (255.0 if rgb.max() <= 1.0 else 1.0), 0, 255).astype(np.uint8)
    n = points.shape[0]
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary else "format ascii 1.0\n")
        + f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    if binary:
        with open(filename, "wb") as f:
            f.write(header.encode())
            rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = points.T
            rec["r"], rec["g"], rec["b"] = rgb.T
            f.write(rec.tobytes())
    else:
        with open(filename, "w") as f:
            f.write(header)
            for p, c in zip(points, rgb):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def depth_to_pcd_intrinsics(depth: np.ndarray, intrinsic) -> np.ndarray:
    """Back-project (H, W) depth with (fx, fy, cx, cy) to (H·W, 3) camera-frame points."""
    fx, fy, cx, cy = [float(v) for v in intrinsic]
    H, W = depth.shape
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return np.stack([x, y, depth], -1).reshape(-1, 3).astype(np.float32)


def reconstruct_depth_intrinsics(depth, rgb, out_dir: str, pcd_name: str,
                                 intrinsic, scale: float = 1.0) -> str:
    """Depth + rgb → colored ``<out_dir>/<pcd_name>.ply``."""
    depth = np.array(np.squeeze(depth), np.float64)
    rgb = np.squeeze(rgb)
    depth[depth < 1e-8] = 0
    depth = depth * scale
    pcd = depth_to_pcd_intrinsics(depth, intrinsic)
    path = os.path.join(out_dir, pcd_name + ".ply")
    save_point_cloud(pcd, rgb.reshape(-1, 3), path)
    return path


def reconstruct_depth(depth, rgb, out_dir: str, pcd_name: str, focal: float,
                      scale: float = 1.0) -> str:
    """Focal-length variant: principal point at the image center."""
    depth = np.squeeze(np.asarray(depth))
    H, W = depth.shape
    intrinsic = (focal, focal, W / 2.0, H / 2.0)
    return reconstruct_depth_intrinsics(depth, rgb, out_dir, pcd_name, intrinsic, scale)
