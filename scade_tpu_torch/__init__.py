"""scade_tpu_torch — the PyTorch/CUDA port of scade_tpu for NVIDIA Hopper.

The package mirrors scade_tpu's module layout (``scade_tpu/X/y.py`` is
``scade_tpu_torch/X/y.py``) and imports neither JAX nor scade_tpu:

- ``ops``      — tensor math (positional encoding, rays, volume rendering,
  inverse-CDF sampling, losses) and the two hand-written CUDA kernels,
  ``ops/fused_mlp.py`` (PE + NeRF MLP) and ``ops/fused_sampling.py``
  (CDF build + inverse-CDF lookup), each beside its plain PyTorch version.
- ``models``   — the NeRF MLP as an ``nn.Module`` with the reference's
  parameter names.
- ``render``   — coarse/fine/P_depth rendering of ray batches and images.
- ``train``    — the train step (batch gather, losses, two optax-style Adams)
  and the train loop (cadence, checkpoints, logging, the final test).
- ``data``     — scene loading: transforms_*.json, images, depths, cIMLE
  hypotheses, and a PNG codec for machines without OpenCV.
- ``eval``     — rendering views with PSNR/SSIM/LPIPS/depth RMSE and writing
  the test results.
- ``utils``    — the CLI's flags, ``.tar`` checkpoints, metrics.txt and the
  TensorBoard/JSONL writer.
- ``cli``      — ``python -m scade_tpu_torch train|test``, the reference
  runner's CLI.
- ``convert``  — weights between the JAX params layout and the state_dict.
- ``prior``    — the cIMLE depth prior's inference path: the ResNeXt101
  cIMLE model, its checkpoints, and ``python -m scade_tpu_torch.prior.dump``
  (also ``dump_wild``, ``demo``), which writes the hypotheses ``train`` reads.

Entry points run on ``RenderConfig.device`` (the CLI's ``--device``): ``cuda``
unless the caller asks for the CPU. The
CUDA sources live in ``csrc/`` and are built with nvcc at first use
(``_kernels.py``).
"""

__version__ = "0.1.0"
