"""scade_tpu_torch.prior's training parts against scade_tpu.prior on the CPU:
the train-mode forward and its BatchNorm update, the decoder-side cIMLE
model and its weight map, the optimizer against optax, the AdaIn statistics,
the z-recache and one whole train step.

Weights are the JAX package's own (``init_prior`` on
``PriorConfig(d_latent=8).with_small()``, BatchNorm statistics seeded),
carried across by ``convert``; inputs from numpy seeds at the 64 crop.

Tolerances (measured values from one CPU run of this file):
- depth (train-mode forward, f32): 1e-4 × max|JAX depth| (measured
  1.7e-5);
- BatchNorm running statistics after a train-mode forward: 1e-4 of each
  tensor's largest magnitude (measured 5.5e-6); the port follows flax's law
  (biased batch variance, momentum 0.9), which torch's own BatchNorm2d would
  miss by the factor n/(n−1) of its unbiased variance (4/3 on a 2×2 map of
  one image: test_flax_batchnorm_law_is_not_torchs);
- weights carried across: bit for bit;
- optimizer steps on given grads: 1e-6 × the largest update plus 2 ulps of
  the weight (measured 2.2 ulps at most, with the clip, whose norm XLA sums
  in f32 and the port in f64: an ulp of the norm scales every update);
- AdaIn tap activations and shifts: 1e-4 relative to each tensor's largest
  magnitude (measured 1.9e-6); the recache's choice of z: equal;
- one train step: loss 1e-5 relative (measured equal); parameters after the
  step within 1e-3 of the largest update (measured 4.7e-4: at B=2 the
  train-mode BatchNorms subtract the mean of nearly uniform incoming
  gradients, and the f32 remainder carries each framework's rounding);
  running statistics as above;
- bf16 under autocast against f32 (the port's compute_dtype; flax instead
  casts the parameters, so JAX's bf16 is not a reference for it): the
  loss within 5% (the forward's bf16 bound, tests/test_prior.py; measured
  1.6e-4), the update's cosine with f32's above 0.9 (measured 0.9945).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scade_tpu.prior import model as jmodel
from scade_tpu.prior import train as jtrain
from scade_tpu.prior import translate
from scade_tpu_torch.prior import convert, model, train

D_LATENT = 8
SMALL = model.PriorConfig(d_latent=D_LATENT).with_small()
JSMALL = jmodel.PriorConfig(d_latent=D_LATENT).with_small()
REL = 1e-4
CHEAP = "_meanstd-tanh_msgil-normal_"
VARIANTS = [("enc", "v2"), ("enc", "v3"), ("dec", "v2"), ("dec", "v3"), ("dec", "v4"),
            ("dec", "v5"), ("dec", "v6")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers."""
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


def jax_prior(cimle_version, version):
    m, variables = jmodel.init_prior(jax.random.PRNGKey(0), JSMALL, image_size=(32, 32),
                                     version=version, cimle_version=cimle_version)
    return m, {"params": variables["params"],
               "batch_stats": seeded_batch_stats(variables["batch_stats"])}


def port_prior(variables, cimle_version, version):
    m = model.build_prior_model(SMALL, version, cimle_version)
    m.load_state_dict(convert.state_dict_from_flax(variables["params"], variables["batch_stats"],
                                                   SMALL, version, cimle_version), strict=True)
    return m


def seeded_shifts(dims, seed=2):
    rng = np.random.default_rng(seed)
    out = {}
    for i, d in enumerate(dims):
        out[f"mean{i}"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
        out[f"var{i}"] = rng.uniform(0.0, 0.2, d).astype(np.float32)
    return out


def shift_dims(cimle_version):
    return (model.decoder_adain_dims(SMALL) if cimle_version == "dec"
            else model.encoder_adain_dims(SMALL))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def batch_np(B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
            "depth": rng.uniform(0.5, 9, (B, S, S, 1)).astype(np.float32),
            "planes": np.zeros((B, S, S), np.int32),
            "focal_length": np.full((B,), 200.0, np.float32),
            "quality_flg": np.full((B,), 2, np.int32)}


def state_of(params, stats, cimle_version, version):
    return convert.state_dict_from_flax(params, stats, SMALL, version, cimle_version)


def close_rel(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("cimle_version,version", VARIANTS)
def test_train_mode_forward_and_bn_update_match_jax(cimle_version, version):
    """prior_apply(train=True): the depth, and every BatchNorm's running
    statistics as flax's mutable batch_stats come back. Also the weight map
    of the variant, bit for bit against translate.params_to_torch_state_dict."""
    jm, variables = jax_prior(cimle_version, version)
    shifts = seeded_shifts(shift_dims(cimle_version))
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    z = np.random.default_rng(4).standard_normal((2, D_LATENT)).astype(np.float32)
    ref, mut = jmodel.prior_apply(jm, variables, {k: jnp.asarray(v) for k, v in shifts.items()},
                                  jnp.asarray(x), jnp.asarray(z), train=True)
    m = port_prior(variables, cimle_version, version).train()
    with torch.no_grad():
        got = model.prior_apply(m, {k: torch.from_numpy(v) for k, v in shifts.items()}, nchw(x),
                                torch.from_numpy(z), train=True)
    close_rel(got.permute(0, 2, 3, 1).numpy(), ref, REL, "depth")
    want = state_of(variables["params"], mut["batch_stats"], cimle_version, version)
    sd = m.state_dict()
    n_bn = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            close_rel(sd[k].numpy(), v.numpy(), REL, k)
            n_bn += 1
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1
    assert n_bn > 0
    theirs = translate.params_to_torch_state_dict(
        variables["params"], variables["batch_stats"], JSMALL, version=version,
        dec_version=version if cimle_version == "dec" else None)
    ours = state_of(variables["params"], variables["batch_stats"], cimle_version, version)
    assert sorted(k for k in ours if not k.endswith("num_batches_tracked")) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_flax_batchnorm_law_is_not_torchs():
    """The train-mode update uses the biased batch variance: on a 2×2 map
    of one image torch's BatchNorm2d would move running_var by 4/3 as much."""
    x = torch.randn(1, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    ours, plain = model.BatchNorm2d(3).train(), torch.nn.BatchNorm2d(3).train()
    y = ours(x)
    torch.testing.assert_close(y, plain(x))
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * var)
    assert not torch.allclose(ours.running_var, plain.running_var)
    assert int(ours.num_batches_tracked) == 1


@pytest.mark.parametrize("cimle_version", ["enc", "dec"])
def test_adain_taps_match_jax(cimle_version):
    """get_adain_init_act: the 4 tap activations, eval mode, zero shifts."""
    jm, variables = jax_prior(cimle_version, "v2")
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    z = np.random.default_rng(6).standard_normal((2, D_LATENT)).astype(np.float32)
    ref = jmodel.get_adain_init_act(jm, variables, jmodel.zero_shifts_for(jm), jnp.asarray(x),
                                    jnp.asarray(z))
    m = port_prior(variables, cimle_version, "v2").eval()
    with torch.no_grad():
        got = model.get_adain_init_act(m, model.zero_shifts_for(m), nchw(x), torch.from_numpy(z))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        close_rel(g.permute(0, 2, 3, 1).numpy(), r, REL)


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def enc_variables():
    return jax_prior("enc", "v2")[1]


def grads_like(params, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
                        params)


def torch_names(params, stats):
    """flax path → torch name of every parameter leaf."""
    out = {}
    for tn, fp, kind in convert.name_map(SMALL):
        leaves = {"conv": (("kernel", "weight"), ("bias", "bias")),
                  "linear": (("kernel", "weight"), ("bias", "bias")),
                  "bn": (("scale", "weight"), ("bias", "bias"))}[kind]
        node = params
        for part in fp.split("."):
            node = node[part]
        for fl, tl in leaves:
            if fl in node:
                out[f"{fp}.{fl}"] = f"{tn}.{tl}"
    return out


def test_param_groups_match_jax(enc_variables):
    names = torch_names(enc_variables["params"], enc_variables["batch_stats"])
    labels = jax.tree_util.tree_map_with_path(lambda p, _: jtrain._param_label(p),
                                              enc_variables["params"])
    flat = {".".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(labels)}
    m = port_prior(enc_variables, "enc", "v2")
    port = {n: train.param_label(n) for n, _ in m.named_parameters()}
    assert sorted(port) == sorted(names.values())
    assert {names[f]: lab for f, lab in flat.items()} == port
    assert set(port.values()) == {"encoder", "decoder", "style"}


# rates 100× the defaults, so that an update is far above an ulp of the weights
LRS = dict(base_lr=0.1, mlp_lr=0.1)
OPT_CASES = {
    # name: (PriorTrainConfig kwargs, fixed_backbone, grad scale, steps)
    "decay_momentum": (LRS, False, 1e-4, 2),
    "clip": (LRS, False, 1e-2, 2),
    "group_lrs": (dict(base_lr=0.2, scale_decoder_lr=0.5, mlp_lr=0.05), False, 1e-4, 2),
    "scheduler": (dict(LRS, use_scheduler=True, warmup_iters=2, lr_milestones=(1, 2)), False,
                  1e-4, 3),
    "fixed_backbone": (LRS, True, 1e-2, 2),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_steps_match_optax(enc_variables, case):
    """Steps of PriorOptimizer on the same grads as the JAX package's
    optax chain: the clip (global norm over all grads; the 1e-2 grads have
    norm ~130, the 1e-4 ones ~1.3), weight decay before momentum over two
    steps, per-group rates, the warmup/milestone schedule (count 0 first),
    and fixed_backbone (only the style MLPs move, encoder and decoder not
    even by decay)."""
    kw, fixed, scale, steps = OPT_CASES[case]
    tc = jtrain.PriorTrainConfig(d_latent=D_LATENT, **kw)
    ptc = train.PriorTrainConfig(**kw)
    params = enc_variables["params"]
    stats = enc_variables["batch_stats"]
    opt = jtrain.make_prior_optimizer(params, tc, fixed_backbone=fixed)
    state = opt.init(params)
    m = port_prior(enc_variables, "enc", "v2")
    popt = train.PriorOptimizer(m, ptc, fixed_backbone=fixed)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    named = dict(m.named_parameters())
    norms = []
    for s in range(steps):
        g = grads_like(params, scale, seed=10 + s)
        norms.append(float(optax.global_norm(g)))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        gsd = state_of(g, stats, "enc", "v2")
        popt.zero_grad()
        for n, p in named.items():
            p.grad = gsd[n].clone()
        popt.step()
    want = state_of(params, stats, "enc", "v2")
    moved = max((want[n] - before[n]).abs().max().item() for n in named)
    for n, p in named.items():
        err = (p.detach() - want[n]).abs().max().item()
        ulp = torch.finfo(torch.float32).eps * want[n].abs().max().item()
        assert err <= 1e-6 * moved + 2 * ulp, (n, err, moved)
        if fixed and train.param_label(n) != "style":
            assert torch.equal(p.detach(), before[n]), n
    assert (norms[0] > 10) == (case in ("clip", "fixed_backbone"))


def test_warmup_multistep_lr_matches_jax():
    for method in ("linear", "constant"):
        ours = train.warmup_multistep_lr(1e-3, (5, 8), 0.1, 1 / 3, 4, method)
        theirs = jtrain.warmup_multistep_lr(1e-3, (5, 8), 0.1, 1 / 3, 4, method)
        for count in range(11):
            assert ours(count) == float(np.float32(theirs(count))), (method, count)


# ---------------------------------------------------------------------------
# AdaIn statistics, z-recache, the train step
# ---------------------------------------------------------------------------


def z_feed(zs):
    """A draw_z that hands out ``zs`` in order."""
    it = iter(zs)
    return lambda n: torch.from_numpy(np.array(next(it), np.float32))


@pytest.mark.parametrize("cimle_version", ["enc", "dec"])
def test_adain_stats_match_jax(cimle_version, tmp_path):
    """compute_adain_stats fed JAX's z (key split per image as the JAX
    function splits it): the same shifts; the .npy the JAX loader reads."""
    jm, variables = jax_prior(cimle_version, "v2")
    rng = np.random.default_rng(7)
    images = [rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(3)]
    key = jax.random.PRNGKey(11)
    ref = jtrain.compute_adain_stats(jm, variables, ({"rgb": im} for im in images), key,
                                     D_LATENT, 2)
    zs, k = [], key
    for _ in images:
        k, sub = jax.random.split(k)
        zs.append(jax.random.normal(sub, (2, D_LATENT), jnp.float32))
    m = port_prior(variables, cimle_version, "v2")
    path = str(tmp_path / "mv.npy")
    got = train.compute_adain_stats(m, ({"rgb": nchw(im)} for im in images), z_feed(zs), 2,
                                    out_path=path)
    assert sorted(got) == sorted(ref)
    for name in ref:
        close_rel(got[name].numpy(), ref[name], REL, name)
    loaded = jtrain.load_mean_var_adain(path)
    for name in ref:
        np.testing.assert_array_equal(np.asarray(loaded[name]), got[name].numpy())


def test_recache_picks_jax_z():
    """recache_z fed JAX's z (per batch and set: split, then k_z of the
    step's split; rows b·mini + j): the same argmin per image, so the same
    z; num_samples 5 with mini 2 takes the floor, 2 sets."""
    jm, variables = jax_prior("enc", "v2")
    shifts = seeded_shifts(shift_dims("enc"))
    tc = jtrain.PriorTrainConfig(d_latent=D_LATENT, num_samples=5, mini_batch_size=2,
                                 loss_mode=CHEAP)
    batches = [batch_np(2, seed=8), batch_np(1, seed=9)]
    key = jax.random.PRNGKey(12)
    jshifts = {k: jnp.asarray(v) for k, v in shifts.items()}
    ref = jtrain.recache_z(jm, variables, jshifts, tc, iter(batches), key)
    zs, k = [], key
    for b in batches:
        for _ in range(2):
            k, sub = jax.random.split(k)
            k_z, _ = jax.random.split(sub)
            zs.append(jax.random.normal(k_z, (b["rgb"].shape[0] * 2, D_LATENT), jnp.float32))
    m = port_prior(variables, "enc", "v2")
    ptc = train.PriorTrainConfig(num_samples=5, mini_batch_size=2,
                                 loss_mode=CHEAP)
    got = train.recache_z(m, {k: torch.from_numpy(v) for k, v in shifts.items()}, ptc,
                          (train.batch_to_torch(b, "cpu") for b in batches), z_feed(zs),
                          torch.Generator())
    assert got.shape == ref.shape == (3, D_LATENT)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def step_case():
    """JAX's make_train_step from seeded weights on one batch and z."""
    jm, variables = jax_prior("enc", "v2")
    shifts = seeded_shifts(shift_dims("enc"))
    tc = jtrain.PriorTrainConfig(d_latent=D_LATENT, loss_mode=CHEAP)
    opt = jtrain.make_prior_optimizer(variables["params"], tc)
    b = batch_np(2, seed=13)
    z = np.random.default_rng(14).standard_normal((2, D_LATENT)).astype(np.float32)
    init = state_of(variables["params"], variables["batch_stats"], "enc", "v2")
    step = jtrain.make_train_step(jm, tc, opt)
    params, stats, _, total, loss_dict = step(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables["batch_stats"]), opt.init(variables["params"]),
        {k: jnp.asarray(v) for k, v in shifts.items()}, {k: jnp.asarray(v) for k, v in b.items()},
        jnp.asarray(z), jax.random.PRNGKey(0))
    return dict(variables=variables, shifts=shifts, batch=b, z=z, init=init,
                after=state_of(params, stats, "enc", "v2"), total=float(total),
                loss_dict={k: float(v) for k, v in loss_dict.items()})


def port_step(case, compute_dtype=None):
    m = port_prior(case["variables"], "enc", "v2")
    tc = train.PriorTrainConfig(loss_mode=CHEAP, compute_dtype=compute_dtype)
    opt = train.PriorOptimizer(m, tc)
    total, loss_dict = train.train_step(
        m, opt, {k: torch.from_numpy(v) for k, v in case["shifts"].items()},
        train.batch_to_torch(case["batch"], "cpu"), torch.from_numpy(case["z"]), {}, tc)
    return m, float(total), {k: float(v) for k, v in loss_dict.items()}


def test_train_step_matches_jax(step_case):
    """One whole step (train-mode forward, criterion, backward, clip, SGD)
    from the same weights, batch and z: the loss and its parts, the
    parameters and the running statistics after it."""
    m, total, loss_dict = port_step(step_case)
    assert abs(total - step_case["total"]) <= 1e-5 * abs(step_case["total"])
    assert sorted(loss_dict) == sorted(step_case["loss_dict"])
    for k, v in step_case["loss_dict"].items():
        assert abs(loss_dict[k] - v) <= 1e-5 * abs(v), k
    sd, want, init = m.state_dict(), step_case["after"], step_case["init"]
    params = {n for n, _ in m.named_parameters()}
    moved = max((want[n] - init[n]).abs().max().item() for n in params)
    for n in params:
        err = (sd[n] - want[n]).abs().max().item()
        assert err <= 1e-3 * moved, (n, err, moved)
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            close_rel(sd[k].numpy(), v.numpy(), REL, k)


def test_bf16_step_within_bound_of_f32(step_case):
    m32, total32, _ = port_step(step_case)
    m16, total16, _ = port_step(step_case, "bfloat16")
    assert abs(total16 - total32) <= 0.05 * abs(total32)
    init = step_case["init"]
    d32 = torch.cat([(p.detach() - init[n]).flatten() for n, p in m32.named_parameters()])
    d16 = torch.cat([(p.detach() - init[n]).flatten() for n, p in m16.named_parameters()])
    assert torch.isfinite(d16).all()
    assert torch.nn.functional.cosine_similarity(d16, d32, 0) > 0.9
    assert all(p.dtype == torch.float32 for p in m16.parameters())
