"""Tensor math for the SCADE pipeline, and the kernels K1 and K2."""

from scade_tpu_torch.ops.embedding import Embedder, get_embedder, positional_encoding
from scade_tpu_torch.ops.losses import compute_space_carving_loss, img2mse, mse2psnr
from scade_tpu_torch.ops.rays import get_ray_dirs, get_rays, get_rays_at_coords, ndc_rays
from scade_tpu_torch.ops.sampling import draw_u, draw_u_sorted, merge_sorted, sample_pdf
from scade_tpu_torch.ops.volume import (
    compute_weights,
    perturb_z_vals,
    raw2outputs,
    stratified_z_vals,
)

__all__ = [
    "Embedder",
    "get_embedder",
    "positional_encoding",
    "compute_space_carving_loss",
    "img2mse",
    "mse2psnr",
    "get_ray_dirs",
    "get_rays",
    "get_rays_at_coords",
    "ndc_rays",
    "draw_u",
    "draw_u_sorted",
    "merge_sorted",
    "sample_pdf",
    "compute_weights",
    "perturb_z_vals",
    "raw2outputs",
    "stratified_z_vals",
]
