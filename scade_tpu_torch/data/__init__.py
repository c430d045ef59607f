"""Scene loading (transforms_*.json, images, depths, cIMLE hypotheses)."""

from scade_tpu_torch.data.scene import (
    Scene,
    load_scene,
    load_scene_nogt,
    load_scene_processed,
    load_scene_scannet,
)

__all__ = ["Scene", "load_scene", "load_scene_nogt", "load_scene_processed", "load_scene_scannet"]
