"""The cIMLE depth prior's inference path (counterpart of ``scade_tpu/prior/``).

- ``blocks``     — AdaIn, AdaInV2, Bottleneck, BasicBlock, FTB, FFM, AO.
- ``model``      — PriorConfig and the backbone zoo, the encoder-side cIMLE
  model (ResNeXt101-32x8d + LeReS decoder) in the reference's names.
- ``convert``    — the flax → state_dict name map, prefix stripping and
  reference-format checkpoint loading.
- ``data``       — the per-scene FinetuneDataset (OpenCV).
- ``metrics``    — depth metrics and the SfM polyfit alignment (numpy).
- ``pointcloud`` — PLY point clouds for the dump's previews.
- ``dump``, ``dump_wild``, ``demo`` — ``python -m scade_tpu_torch.prior.dump``
  and its wild and raw-folder variants, which write the
  ``leres_cimle/<dir>/<img>_<k>.npy`` hypotheses the NeRF trains on.

Prior training (losses, AdaIn statistics, z-recache, the trainer) is not
ported yet.
"""
