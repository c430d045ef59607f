"""``python -m scade_tpu_torch train|test ...``: see ``scade_tpu_torch/cli.py``."""

from scade_tpu_torch.cli import main

if __name__ == "__main__":
    main("scannet")
