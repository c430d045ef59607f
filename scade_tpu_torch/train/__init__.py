from scade_tpu_torch.train.step import (
    SceneTensors,
    TrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
    scene_tensors_from_scene,
    staircase_lr,
)

__all__ = [
    "SceneTensors",
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "scene_tensors_from_scene",
    "staircase_lr",
]
