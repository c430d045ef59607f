"""``python -m scade_tpu_torch.prior.train`` on the CPU, on
``tools/make_synthetic_scene.py``'s scene (--H 48 --W 64, 3 train views) at
the 64 crop with the small prior (``--small_model --d_latent 8``), batches
of 2, 4 z in sets of 2.

Checked: the files (``mean_var_adain.npy`` in the reference's format,
``epoch{N}_step0.pth`` every 8th and the last epoch, ``--loss_jsonl``
records), the strict load of the checkpoint into the port's dump and a dump
from it, and that the JAX package's forward of that checkpoint (through
``translate.params_from_torch_state_dict``) equals the port's within 1e-4 of
its largest magnitude (the bound of tests/test_torch_prior_model.py); the
decoder side; the debug, pretrain, AdaIn-only and check-init paths; a
one-process run of ``--dataset multi`` and of ``--data_parallel``; the
options that are refused.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.prior import model as jmodel
from scade_tpu.prior import translate
from scade_tpu_torch.prior import dump, model, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_LATENT = 8
JSMALL = jmodel.PriorConfig(d_latent=D_LATENT).with_small()
SMALL = model.PriorConfig(d_latent=D_LATENT).with_small()
REL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("prior_train")
    path = str(root / "scene")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synthetic_scene.py"), path,
                    "--H", "48", "--W", "64", "--K", "2", "--n_train", "3", "--n_val", "0",
                    "--n_test", "1", "--n_video", "0"], check=True, capture_output=True)
    return path


def flags(scene, log_dir, *extra):
    return ["--scene_dir", scene, "--log_dir", str(log_dir), "--small_model", "--image_size",
            "64", "--d_latent", str(D_LATENT), "--batchsize", "2", "--num_samples", "4",
            "--mini_batch_size", "2", "--device", "cpu", *extra]


def forwards_agree(state_dict, shifts, cimle_version="enc", version="v2"):
    """The JAX package's forward of ``state_dict`` (through translate)
    against the port's, eval mode, on one seeded image and 2 z."""
    kw = {"dec_version": version} if cimle_version == "dec" else {"version": version}
    params, stats = translate.params_from_torch_state_dict(state_dict, JSMALL, **kw)
    jm = (jmodel.DepthModelCIMLEDec(JSMALL, version) if cimle_version == "dec"
          else jmodel.DepthModelCIMLE(JSMALL, version))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((2, D_LATENT)).astype(np.float32)
    ref = np.asarray(jmodel.prior_apply(jm, {"params": params, "batch_stats": stats},
                                        {k: jnp.asarray(v.numpy()) for k, v in shifts.items()},
                                        jnp.asarray(x), jnp.asarray(z)))
    m = model.build_prior_model(SMALL, version, cimle_version)
    m.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        got = model.prior_apply(m.eval(), shifts, torch.from_numpy(x).permute(0, 3, 1, 2),
                                torch.from_numpy(z)).permute(0, 2, 3, 1).numpy()
    err = np.abs(got - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_trains_writes_its_files_and_dumps_from_them(scene, tmp_path, capsys):
    """Two epochs of the five-loss default: the AdaIn init, a recache, 2
    SGD steps an epoch, a checkpoint at epochs 0 and 1."""
    log = tmp_path / "log"
    jsonl = tmp_path / "losses.jsonl"
    out = train.main(flags(scene, log, "--epochs", "2", "--loss_jsonl", str(jsonl)))
    printed = capsys.readouterr().out
    assert "3 training examples" in printed and "cached z: (3, 8)" in printed
    assert "Epoch 0/2: loss" in printed and "Epoch 1/2: loss" in printed
    assert sorted(os.listdir(log)) == ["epoch0_step0.pth", "epoch1_step0.pth",
                                       "mean_var_adain.npy"]
    mv = np.load(log / "mean_var_adain.npy", allow_pickle=True).item()
    dims = model.encoder_adain_dims(SMALL)
    assert sorted(mv) == sorted(f"{w}{i}" for i in range(4) for w in ("mean", "var"))
    for i, d in enumerate(dims):
        assert mv[f"mean{i}"].shape == mv[f"var{i}"].shape == (d,)
        assert np.isfinite(mv[f"mean{i}"]).all() and (mv[f"var{i}"] >= 0).all()
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert [(r["step"], r["epoch"]) for r in recs] == [(0, 0), (1, 0), (2, 1), (3, 1)]
    keys = {"meanstd-tanh_loss", "msg_normal_loss", "pairwise-normal-regress-edge_loss",
            "pairwise-normal-regress-plane_loss", "ranking-edge_loss", "total_loss"}
    assert all(set(r) == keys | {"step", "epoch"} and np.isfinite(r["total_loss"])
               for r in recs)
    assert out["z"].shape == (3, D_LATENT) and len(out["losses"]) == 2

    ckpt = str(log / "epoch1_step0.pth")
    sd = torch.load(ckpt)["model_state_dict"]
    for k, v in out["model"].state_dict().items():
        assert torch.equal(sd[k], v), k
    dump_dir = dump.main(["--scene_dir", scene, "--ckpt", ckpt, "--mean_var",
                          str(log / "mean_var_adain.npy"), "--small_model", "--image_size", "64",
                          "--d_latent", str(D_LATENT), "--num_hypothesis", "2",
                          "--mini_batch_size", "2", "--compute_dtype", "float32", "--device",
                          "cpu", "--dump_dir", "trained"])
    files = sorted(os.listdir(dump_dir))
    assert len(files) == 3 * 2
    assert all(np.isfinite(np.load(os.path.join(dump_dir, f))).all() for f in files)
    forwards_agree(sd, model.load_mean_var_adain(str(log / "mean_var_adain.npy")))


def test_decoder_side_trains_and_carries_to_jax(scene, tmp_path):
    """``--cimle_version dec --version v4``: decoder AdaIn dims in the
    sidecar, a checkpoint the decoder-side model loads strictly."""
    log = tmp_path / "log"
    out = train.main(flags(scene, log, "--epochs", "1", "--cimle_version", "dec", "--version",
                           "v4", "--loss_mode", "_meanstd-tanh_msgil-normal_"))
    assert isinstance(out["model"], model.DepthModelCIMLEDec)
    mv = np.load(log / "mean_var_adain.npy", allow_pickle=True).item()
    assert [mv[f"mean{i}"].shape[0] for i in range(4)] == list(model.decoder_adain_dims(SMALL))
    sd = torch.load(log / "epoch0_step0.pth")["model_state_dict"]
    forwards_agree(sd, model.load_mean_var_adain(str(log / "mean_var_adain.npy")), "dec", "v4")


def test_debug_mode_with_mlp_pretraining_moves_only_the_style_mlps(scene, tmp_path, capsys):
    """``--debug_mode`` (zero z, no recache) with ``--pretrain_mlp_epochs
    1``: after the one epoch only the AdaIn style MLPs differ from the seeded
    initial weights; BatchNorm still moves its running statistics."""
    log = tmp_path / "log"
    argv = flags(scene, log, "--epochs", "1", "--debug_mode", "--pretrain_mlp_epochs", "1",
                 "--loss_mode", "_meanstd-tanh_msgil-normal_")
    train.main(argv)
    assert "Recaching" not in capsys.readouterr().out
    init = train.build_model(train.parse_args(argv), "cpu").state_dict()
    after = torch.load(log / "epoch0_step0.pth")["model_state_dict"]
    for k, v in init.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert not torch.equal(after[k], v), k
        elif "style_mod" in k:
            assert not torch.equal(after[k], v), k
        else:
            assert torch.equal(after[k], v), k


def test_adain_only_and_check_init(scene, tmp_path):
    import cv2
    import matplotlib

    log = tmp_path / "adain"
    train.main(flags(scene, log, "--only_output_adain_init"))
    assert os.listdir(log) == ["mean_var_adain.npy"]
    log = tmp_path / "check"
    train.main(flags(scene, log, "--check_init"))
    assert sorted(os.listdir(log)) == ["image0-raw.png", "image0_0_0-depth.png",
                                       "image0_0_1-depth.png", "mean_var_adain.npy"]
    for name in ("image0-raw.png", "image0_0_0-depth.png"):
        img = cv2.imread(str(log / name))
        assert img.shape == (64, 64, 3) and img.std() > 0
    x = np.concatenate([np.linspace(0, 1, 1001, dtype=np.float32), np.float32([1.0, 0.0])])
    np.testing.assert_array_equal(train.rainbow(x), matplotlib.colormaps["rainbow"](x)[:, :3])


def test_refused_options(scene, tmp_path, capsys):
    """``--dataset multi`` and ``--data_parallel`` run (in one process,
    ``--data_parallel`` is one rank and trains what the plain run trains);
    what stays refused: multi without a root, ``--device cuda`` without a
    card, a flax msgpack."""
    corpus = str(tmp_path / "corpus")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_prior_corpus.py"), corpus,
                    "--n", "3", "--n_val", "0", "--H", "40", "--W", "48"], check=True,
                   capture_output=True)
    quick = ["--epochs", "1", "--debug_mode", "--loss_mode", "_meanstd-tanh_msgil-normal_"]
    multi = train.main(flags(None, tmp_path / "multi", *quick, "--dataset", "multi",
                             "--dataroot", corpus)[2:])
    assert "3 training examples" in capsys.readouterr().out
    assert multi["order"]["source"] == ["taskonomy"] * 3 and np.isfinite(multi["losses"]).all()
    with pytest.raises(SystemExit, match="requires --dataroot"):
        train.main(flags(None, tmp_path, "--dataset", "multi")[2:])
    plain = train.main(flags(scene, tmp_path / "plain", *quick))
    dp = train.main(flags(scene, tmp_path / "dp", *quick, "--data_parallel"))
    assert "data-parallel over 1 ranks" in capsys.readouterr().out
    a, b = plain["model"].state_dict(), dp["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    argv = flags(scene, tmp_path)
    argv[argv.index("cpu")] = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(argv)
    with pytest.raises(SystemExit, match="export_prior_to_torch"):
        train.main(flags(scene, tmp_path, "--ckpt", "prior.msgpack"))


def test_starts_from_a_checkpoint(scene, tmp_path, capsys):
    """``--ckpt`` of a reference-format .pth: loaded strictly, trained on."""
    m = model.init_weights_(model.DepthModelCIMLE(SMALL), torch.Generator().manual_seed(5))
    path = str(tmp_path / "start.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in m.state_dict().items()}}, path)
    out = train.main(flags(scene, tmp_path / "log", "--epochs", "1", "--ckpt", path,
                           "--loss_mode", "_meanstd-tanh_msgil-normal_"))
    assert f"restored {path}" in capsys.readouterr().out
    assert np.isfinite(out["losses"]).all()
