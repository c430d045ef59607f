"""SCADE on In-the-Wild / Tanks&Temples scenes through the PyTorch port: the
counterpart of ``run_scade_wild.py``.

    python -m scade_tpu_torch.wild train|test|test_opt|video --data_dir <dir> \\
        --scene_id kitchen --cimle_dir <dump> --ckpt_dir ckpts [--mask_edges true]

The ScanNet CLI (``scade_tpu_torch/cli.py``) with the wild runner's
differences (reference: run_scade_wild.py against run_scade_scannet.py):
scenes load through ``load_scene_processed`` (no GT depth, ``.png`` depth
files), ``--mask_edges`` masks a 10 px border, the RGB loss is masked
wherever a pixel mask exists, ``--scaleshift_lr`` defaults to 1e-5, and the
TB scalars go under ``runs_prior_corrected/``.
"""

from scade_tpu_torch.cli import main


def main_wild(argv=None):
    """Console-script entry (``scade-torch-wild``): the wild variant of main()."""
    return main("wild", argv)


if __name__ == "__main__":
    main_wild()
