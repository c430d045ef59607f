"""Ray generation from camera intrinsics and poses.

Rays pass through pixel centres (+0.5), the y axis is flipped
(``H - (j+0.5) - cy``) and the camera looks down -z. ``intrinsic`` is the
4-vector (fx, fy, cx, cy). The functions work on the full (H, W) grid or on a
gathered (N, 2) list of (row, col) coordinates, which is what the train step
uses.
"""

from __future__ import annotations

import torch


def _dirs_from_pixels(i, j, H, intrinsic):
    """Camera-frame ray directions for pixel columns ``i`` and rows ``j``."""
    fx, fy, cx, cy = intrinsic[0], intrinsic[1], intrinsic[2], intrinsic[3]
    return torch.stack(
        [((i + 0.5) - cx) / fx, (H - (j + 0.5) - cy) / fy, -torch.ones_like(i)],
        dim=-1,
    )


def get_ray_dirs(H: int, W: int, intrinsic, c2w, coords=None) -> torch.Tensor:
    """World-frame ray directions: (H, W, 3) for ``coords=None``, else (N, 3)
    for (N, 2) (row, col) coordinates."""
    if coords is None:
        jj, ii = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=c2w.device),
            torch.arange(W, dtype=torch.float32, device=c2w.device),
            indexing="ij",
        )
    else:
        ii, jj = coords[..., 1], coords[..., 0]
    dirs = _dirs_from_pixels(ii, jj, H, intrinsic)
    # rays_d[k] = sum_l dirs[l] * c2w[k, l], as an f32 sum of products: a
    # matmul could run in TF32 on the card and misproject edge pixels
    return (dirs[..., None, :] * c2w[:3, :3]).sum(dim=-1)


def get_rays(H: int, W: int, intrinsic, c2w, coords=None):
    """(rays_o, rays_d) world-frame origins and directions."""
    rays_d = get_ray_dirs(H, W, intrinsic, c2w, coords)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_at_coords(intrinsic, c2w, coords, H: int):
    """Rays for a gathered (N, 2) list of (row, col) pixel coordinates."""
    return get_rays(H, 0, intrinsic, c2w, coords=coords)


def ndc_rays(H: int, W: int, focal, near, rays_o, rays_d):
    """Shift rays to the near plane and project them to NDC
    (run_nerf_helpers.py:316-333)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
