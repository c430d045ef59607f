"""Scene loading (transforms_*.json, images, depths, cIMLE hypotheses) and the
depth-completion helpers."""

from scade_tpu_torch.data.dataset_sampling import create_random_subsets
from scade_tpu_torch.data.error_sources import add_missing_depth, add_quadratic_depth_noise
from scade_tpu_torch.data.scannet_dataset import (
    convert_depth_completion_scaling_to_m,
    convert_m_to_depth_completion_scaling,
    get_pretrained_normalize,
    resize_sparse_depth,
)
from scade_tpu_torch.data.scene import (
    Scene,
    load_scene,
    load_scene_nogt,
    load_scene_processed,
    load_scene_scannet,
)

__all__ = [
    "Scene",
    "add_missing_depth",
    "add_quadratic_depth_noise",
    "convert_depth_completion_scaling_to_m",
    "convert_m_to_depth_completion_scaling",
    "create_random_subsets",
    "get_pretrained_normalize",
    "load_scene",
    "load_scene_nogt",
    "load_scene_processed",
    "load_scene_scannet",
    "resize_sparse_depth",
]
