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
- ``train``    — the train step: batch gather, losses, two optax-style Adams.
- ``convert``  — weights between the JAX params layout and the state_dict.

Entry points run on ``RenderConfig.device``: ``cuda`` unless the caller
passes ``make_render_config(device="cpu")``. The
CUDA sources live in ``csrc/`` and are built with nvcc at first use
(``_kernels.py``).
"""

__version__ = "0.1.0"
