"""The cIMLE depth prior: inference, the dump and per-scene training
(counterpart of ``scade_tpu/prior/``).

- ``blocks``     — AdaIn, AdaInV2, Bottleneck, BasicBlock, FTB, FFM, AO and
  a BatchNorm2d with flax's train-mode law.
- ``model``      — PriorConfig and the backbone zoo, the encoder- and
  decoder-side cIMLE models (ResNeXt101-32x8d + LeReS decoder) in the
  reference's names, in eval or train mode.
- ``convert``    — the flax → state_dict name map, prefix stripping and
  reference-format checkpoint loading.
- ``data``       — the per-scene FinetuneDataset (OpenCV) and ``collate``.
- ``losses``     — the five-loss criterion (ILNR, MSGIL, ranking-edge, PWN
  edges and planes), its draws apart from its math.
- ``train``      — AdaIn statistics, z-recache, grouped SGD and
  ``python -m scade_tpu_torch.prior.train``, the per-scene trainer.
- ``metrics``    — depth metrics and the SfM polyfit alignment (numpy).
- ``pointcloud`` — PLY point clouds for the dump's previews.
- ``dump``, ``dump_wild``, ``demo`` — ``python -m scade_tpu_torch.prior.dump``
  and its wild and raw-folder variants, which write the
  ``leres_cimle/<dir>/<img>_<k>.npy`` hypotheses the NeRF trains on.
- ``multi_data`` — the multi-corpus reader and sampler of pretraining.
- ``spvcnn``     — the SPVCNN point-cloud classifier and its depth → point
  cloud input functions (``refine_focal``, ``refine_shift``), dead code upstream.
"""

from scade_tpu_torch.prior.spvcnn import (  # noqa: F401
    SPVCNN,
    SPVCNNConfig,
    SparsePoints,
    SparseVoxels,
    init_spvcnn,
)
