"""``python -m scade_tpu_torch train|test|test_opt|video ...``: see
``scade_tpu_torch/cli.py``."""

from scade_tpu_torch.cli import main

if __name__ == "__main__":
    main("scannet")
