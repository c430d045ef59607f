"""The baseline prior (``DepthModelBaseline``, its auxi branch, ``ASPP``,
``auxi_criterion`` and the ``auxi`` weight map) against scade_tpu.prior on
the CPU.

Weights are the JAX package's own (``DepthModelBaseline.init`` on
``PriorConfig(d_latent=8).with_small()``, BatchNorm statistics seeded),
carried across by ``convert.baseline_state_dict_from_flax``; inputs from
numpy seeds at the 64 crop (at 32 the 1/32 maps are 1×1 and a train-mode
BatchNorm over 2 values per channel turns rounding noise into ±1).

Tolerances (measured values from one CPU run of this file):
- depth and auxi outputs (f32): 1e-4 × max|JAX output|, the bound of
  tests/test_torch_prior_train.py's train-mode forward (measured: eval
  1.5e-6 depth, 2.4e-6 auxi; train 1.0e-5 depth, 6.8e-5 auxi, whose first
  block normalizes 8 values a channel at the 1/32 scale);
- BatchNorm running statistics after a train-mode forward, the auxi
  blocks' momentum 0.5 included: 1e-4 of each tensor's largest magnitude
  (measured 9.3e-6);
- ASPP alone: 1e-5 of its largest output (measured 4.8e-7), its running
  variance 1e-4 (measured 4.3e-8);
- auxi_criterion on the JAX package's draws: losses 1e-5 relative
  (measured 6.2e-8), gradients 1e-4 of their largest (measured 1.1e-7);
- weights carried across and back: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.prior import blocks as jblocks
from scade_tpu.prior import losses as J
from scade_tpu.prior import model as jmodel
from scade_tpu.prior import translate
from scade_tpu_torch.prior import blocks, convert, model
from scade_tpu_torch.prior import losses as L
from test_torch_prior_losses import jax_ranking_draws, jax_value_and_grad, port_value_and_grad

SMALL = model.PriorConfig(d_latent=8).with_small()
JSMALL = jmodel.PriorConfig(d_latent=8).with_small()
S = 64
REL = 1e-4
AUXI_MODE = "_ranking-edge-auxi_msgil-normal-auxi_meanstd-tanh-auxi_"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_batch_stats(batch_stats, seed=1):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def close_rel(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.fixture(scope="module", params=["v1", "v2"])
def baseline(request):
    v = request.param
    jm = jmodel.DepthModelBaseline(JSMALL, v)
    x = np.random.default_rng(0).standard_normal((2, S, S, 3)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = seeded_batch_stats(jax.tree.map(np.asarray, variables["batch_stats"]))
    jvars = {"params": params, "batch_stats": stats}
    ev = jm.apply(jvars, jnp.asarray(x), train=False)
    tr, mut = jm.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    return dict(version=v, x=x, params=params, stats=stats, eval=ev, train=tr,
                stats_after=jax.tree.map(np.asarray, mut["batch_stats"]))


def port_baseline(case):
    m = model.DepthModelBaseline(SMALL, case["version"])
    m.load_state_dict(convert.baseline_state_dict_from_flax(case["params"], case["stats"], SMALL),
                      strict=True)
    return m


def test_baseline_eval_and_train_match_jax(baseline):
    """Depth logit and auxi disparity in eval mode, then in train mode, and
    every BatchNorm's running statistics after the train-mode forward
    (AuxiBlock's momentum 0.5, the rest 0.9)."""
    m = port_baseline(baseline)
    x = nchw(baseline["x"])
    width = 256 if baseline["version"] == "v1" else 128
    assert m.auxi_modules.auxi_block3.conv2.out_channels == width
    assert m.auxi_modules.auxi_block1.bn1.momentum == 0.5 and m.decoder_modules.outconv \
        .adapt_conv[1].momentum == pytest.approx(0.1)
    with torch.no_grad():
        got = m.eval()(x)
        for g, r, what in zip(got, baseline["eval"], ("depth", "auxi")):
            close_rel(nhwc(g), r, REL, f"eval {what}")
        got = m.train()(x)
    for g, r, what in zip(got, baseline["train"], ("depth", "auxi")):
        close_rel(nhwc(g), r, REL, f"train {what}")
    want = convert.baseline_state_dict_from_flax(baseline["params"], baseline["stats_after"],
                                                 SMALL)
    before = convert.baseline_state_dict_from_flax(baseline["params"], baseline["stats"], SMALL)
    sd = m.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, before[k]), k
            close_rel(sd[k].numpy(), v.numpy(), REL, k)


def test_auxi_weights_round_trip(baseline, tmp_path):
    """flax → state_dict → flax (``translate``'s auxi branch) bit for bit;
    the state_dict under a ``module.`` prefix loads strictly from a .pth."""
    sd = convert.baseline_state_dict_from_flax(baseline["params"], baseline["stats"], SMALL)
    assert any(k.startswith("auxi_modules.auxi_block5.") for k in sd)
    params, stats = translate.params_from_torch_state_dict(sd, JSMALL, adain=False, auxi=True)
    for a, b in ((params, baseline["params"]), (stats, baseline["stats"])):
        la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (_, u), (_, v) in zip(la, lb):
            assert u.dtype == v.dtype and np.array_equal(u, v)
    path = str(tmp_path / "baseline.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    m = model.DepthModelBaseline(SMALL, baseline["version"])
    m.load_state_dict(convert.load_prior_checkpoint(path), strict=True)


def aspp_state(params, stats):
    sd = {}
    for i in range(4):
        conv, bn = params[f"Conv_{i}"], params[f"BatchNorm_{i}"]
        sd[f"atrous_{i}.0.weight"] = torch.from_numpy(np.transpose(conv["kernel"], (3, 2, 0, 1))
                                                      .copy())
        sd[f"atrous_{i}.0.bias"] = torch.from_numpy(np.array(conv["bias"]))
        sd[f"atrous_{i}.2.weight"] = torch.from_numpy(np.array(bn["scale"]))
        sd[f"atrous_{i}.2.bias"] = torch.from_numpy(np.array(bn["bias"]))
        sd[f"atrous_{i}.2.running_mean"] = torch.from_numpy(stats[f"BatchNorm_{i}"]["mean"])
        sd[f"atrous_{i}.2.running_var"] = torch.from_numpy(stats[f"BatchNorm_{i}"]["var"])
        sd[f"atrous_{i}.2.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("train", [False, True])
def test_aspp_matches_jax(train):
    """ASPP at rates 1/6/12/18 on a (2, 12, 20, 24) map, 8 planes a rate."""
    x = np.random.default_rng(4).standard_normal((2, 20, 24, 12)).astype(np.float32)
    ja = jblocks.ASPP(planes=8)
    variables = ja.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = seeded_batch_stats(jax.tree.map(np.asarray, variables["batch_stats"]), seed=5)
    jv = {"params": params, "batch_stats": stats}
    m = blocks.ASPP(12, planes=8)
    m.load_state_dict(aspp_state(params, stats), strict=True)
    m.train(train)
    with torch.no_grad():
        got = nhwc(m(nchw(x)))
    if train:
        ref, mut = ja.apply(jv, jnp.asarray(x), train=True, mutable=["batch_stats"])
        for i in range(4):
            close_rel(m.state_dict()[f"atrous_{i}.2.running_var"].numpy(),
                      mut["batch_stats"][f"BatchNorm_{i}"]["var"], REL, f"var {i}")
    else:
        ref = ja.apply(jv, jnp.asarray(x))
    assert got.shape == (2, 20, 24, 32)
    close_rel(got, ref, 1e-5, "aspp")


def disp_batch(B, H, W, seed):
    rng = np.random.default_rng(seed)
    disp = rng.uniform(0.2, 10.0, (B, H, W, 1)).astype(np.float32)
    disp[:, H // 3:H // 2, W // 4:W // 2] *= 0.3
    disp[:, :3] = -1.0
    rgb = rng.uniform(-2, 2, (B, H, W, 3)).astype(np.float32)
    rgb[:, :, W // 2:, 0] += 2.0
    pred = (disp * rng.uniform(0.5, 1.5, (B, 1, 1, 1))
            + rng.normal(0, 0.3, (B, H, W, 1))).astype(np.float32)
    jb = {"disp": disp, "rgb": rgb, "depth": disp}
    tb = {"disp": nchw(disp), "rgb": nchw(rgb)}
    return jb, tb, pred


def test_auxi_criterion_on_jax_draws():
    """All three auxi losses (ranking-edge on the disparity, MSGIL × 0.5,
    ILNR), the 0.5 weight, the dict's keys, totals and gradient."""
    jb, tb, pred = disp_batch(2, 32, 40, seed=8)
    key = jax.random.PRNGKey(8)
    draws = {"ranking": jax_ranking_draws(key, {"depth": jb["disp"], "rgb": jb["rgb"]})}
    jbatch = {k: jnp.asarray(jb[k]) for k in ("disp", "rgb")}
    ref_dict, _ = J.auxi_criterion(key, jnp.asarray(pred), jbatch, AUXI_MODE)
    ref, ref_g = jax_value_and_grad(lambda p: J.auxi_criterion(key, p, jbatch, AUXI_MODE)[1],
                                    pred)
    got_dict = L.auxi_criterion(nchw(pred), tb, AUXI_MODE, draws)[0]
    got, got_g = port_value_and_grad(lambda p: L.auxi_criterion(p, tb, AUXI_MODE, draws)[1], pred)
    assert sorted(got_dict) == sorted(ref_dict) and len(got_dict) == 4
    for k in ref_dict:
        close_rel(got_dict[k].numpy(), np.asarray(ref_dict[k]), 1e-5, k)
    close_rel(got, ref, 1e-5, "totals")
    close_rel(got_g, ref_g, 1e-4, "grad")
    own = L.draw_auxi_criterion(torch.Generator().manual_seed(0), tb, AUXI_MODE)
    assert own["ranking"][0].shape == draws["ranking"][0].shape


def test_auxi_criterion_without_disp_or_auxi_terms():
    """No ``disp`` in the batch: zeros, as the JAX package; a loss mode
    without ``-auxi_`` terms: an empty dict but its zero total."""
    jb, tb, pred = disp_batch(2, 16, 16, seed=9)
    p = nchw(pred)
    d, total = L.auxi_criterion(p, {"rgb": tb["rgb"]}, AUXI_MODE)
    jd, jtotal = J.auxi_criterion(jax.random.PRNGKey(0), jnp.asarray(pred),
                                  {"rgb": jnp.asarray(jb["rgb"])}, AUXI_MODE)
    assert list(d) == list(jd) == ["total_loss"]
    assert float(d["total_loss"]) == float(jd["total_loss"]) == 0.0
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    d, total = L.auxi_criterion(p, tb, L.DEFAULT_LOSS_MODE)
    assert list(d) == ["total_loss"] and float(d["total_loss"]) == 0.0
    assert not total.any()
