"""scade_tpu_torch.prior's model, blocks and weight carry-over against
scade_tpu.prior on the CPU.

Weights are the JAX package's own (``init_prior(PRNGKey(0))`` and the
blocks' flax inits) with every BatchNorm's running statistics replaced by
seeded ones, carried across by ``convert``. Inputs x, z and the AdaIn shifts
(non-zero) come from numpy seeds. The small model is
``PriorConfig(d_latent=8).with_small()``: full widths, layers (1, 1, 1, 1).

Tolerances: f32 outputs within 1e-4 × max|JAX output| (measured: at most
3.1e-6 relative; the two frameworks' convolutions sum in other orders); the
port's bf16 within 5% mean relative difference of its f32, the bound
tests/test_prior.py holds the JAX bf16 dump to; weights carried across
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.prior import blocks as jblocks
from scade_tpu.prior import model as jmodel
from scade_tpu.prior import translate
from scade_tpu.prior.train import load_mean_var_adain as jax_load_mean_var_adain
from scade_tpu_torch.prior import blocks, convert, model

D_LATENT = 8
SMALL = model.PriorConfig(d_latent=D_LATENT).with_small()
JSMALL = jmodel.PriorConfig(d_latent=D_LATENT).with_small()
F32_REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_batch_stats(batch_stats, seed=1):
    """The tree with each BatchNorm's mean ~ N(0, 0.1) and var ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


@pytest.fixture(scope="module")
def jax_models():
    """The JAX small prior, v2 and v3, with seeded BatchNorm statistics."""
    out = {}
    for version in ("v2", "v3"):
        m, variables = jmodel.init_prior(jax.random.PRNGKey(0), JSMALL, image_size=(32, 32),
                                         version=version)
        out[version] = (m, {"params": variables["params"],
                            "batch_stats": seeded_batch_stats(variables["batch_stats"])})
    return out


def seeded_shifts(seed=2):
    rng = np.random.default_rng(seed)
    out = {}
    for i, d in enumerate(model.encoder_adain_dims(SMALL)):
        out[f"mean{i}"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
        out[f"var{i}"] = rng.uniform(0.0, 0.2, d).astype(np.float32)
    return out


def port_model(variables, version):
    m = model.DepthModelCIMLE(SMALL, version)
    m.load_state_dict(convert.state_dict_from_flax(variables["params"], variables["batch_stats"],
                                                   SMALL, version), strict=True)
    return m.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def inputs(size, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    z = rng.standard_normal((batch, D_LATENT)).astype(np.float32)
    return x, z


def port_forward(m, shifts, x, z, dtype=torch.float32):
    with torch.inference_mode():
        ts = {k: torch.from_numpy(v).to(dtype) for k, v in shifts.items()}
        out = model.prior_apply(m, ts, nchw(x).to(dtype), torch.from_numpy(z).to(dtype))
    return out.float().permute(0, 2, 3, 1).numpy()


def assert_close_rel(got, ref, rel=F32_REL_TOL):
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("version,size", [("v2", 64), ("v3", 64), ("v2", 224)])
def test_forward_matches_jax(jax_models, version, size):
    """The whole model; at 224 JAX takes its block-diagonal grouped conv
    (H·W ≥ 56²) and AdaInV2 resizes a 4×4 map to 7×7, at 64 a 1×1 one."""
    jm, variables = jax_models[version]
    shifts = seeded_shifts()
    x, z = inputs(size)
    apply = jax.jit(lambda v, s, x, z: jmodel.prior_apply(jm, v, s, x, z))
    ref = np.asarray(apply(variables, {k: jnp.asarray(v) for k, v in shifts.items()}, x, z))
    got = port_forward(port_model(variables, version), shifts, x, z)
    assert_close_rel(got, ref)
    if size == 64:  # prior_inference(rescaled=True): depth − min + 0.01
        rescaled = ref - ref.min() + 0.01
        with torch.inference_mode():
            ts = {k: torch.from_numpy(v) for k, v in shifts.items()}
            port_rescaled = model.prior_inference(port_model(variables, version), ts, nchw(x),
                                                  torch.from_numpy(z), rescaled=True)
        assert_close_rel(port_rescaled.permute(0, 2, 3, 1).numpy(), rescaled)


def test_bf16_within_5pct_of_f32(jax_models):
    _, variables = jax_models["v2"]
    shifts = seeded_shifts()
    x, z = inputs(64)
    m = port_model(variables, "v2")
    f32 = port_forward(m, shifts, x, z)
    bf16 = port_forward(m.to(torch.bfloat16), shifts, x, z, torch.bfloat16)
    assert np.isfinite(bf16).all()
    rel = np.abs(f32 - bf16).mean() / np.abs(f32).mean()
    assert 0 < rel < 0.05, rel


def test_prior_apply_needs_eval_mode(jax_models):
    m = port_model(jax_models["v2"][1], "v2").train()
    x, z = inputs(32)
    with pytest.raises(ValueError, match="eval"):
        model.prior_apply(m, model.zero_shifts(SMALL), nchw(x), torch.from_numpy(z))


def init_flax(module, *args, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), *args)
    params = variables["params"]
    stats = seeded_batch_stats(variables["batch_stats"]) if "batch_stats" in variables else {}
    return params, stats


def load_block(torch_module, params, stats, pairs_fn):
    sd = convert.tree_to_state_dict({"m": params}, {"m": stats}, pairs_fn("m", "m"))
    torch_module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return torch_module.eval()


def run_block(torch_module, *arrays, nchw_args=()):
    args = [nchw(a) if i in nchw_args else torch.from_numpy(np.asarray(a))
            for i, a in enumerate(arrays)]
    with torch.inference_mode():
        return torch_module(*args).permute(0, 2, 3, 1).numpy()


def block_case(name, rng):
    """(flax module, its call args, torch module, pairs, NCHW arg indices)."""
    x = rng.standard_normal((2, 12, 10, 24)).astype(np.float32)
    z = rng.standard_normal((2, D_LATENT)).astype(np.float32)
    img = rng.standard_normal((2, 64, 48, 3)).astype(np.float32)
    ms = (0.1 * rng.standard_normal(24)).astype(np.float32)
    vs = rng.uniform(0, 0.2, 24).astype(np.float32)
    if name == "adain":
        return (jblocks.AdaIn(24), (x, z, ms, vs), blocks.AdaIn(D_LATENT, 24),
                convert._adain_pairs, (0,))
    if name in ("adain_v2_enc", "adain_v2_dec"):
        scale = 1.0 if name == "adain_v2_enc" else 2.0
        return (jblocks.AdaInV2(24, var_scale=scale, mean_scale=scale), (x, z, img, ms, vs),
                blocks.AdaInV2(D_LATENT, 24, scale, scale), convert._adain_v2_pairs, (0, 2))
    if name == "ftb":
        return jblocks.FTB(16), (x,), blocks.FTB(24, 16), convert._ftb_pairs, (0,)
    if name == "ffm":
        high = rng.standard_normal((2, 12, 10, 16)).astype(np.float32)
        return (jblocks.FFM(16, 8), (x, high), blocks.FFM(24, 16, 8),
                lambda t, f: convert._ftb_pairs(t + ".ftb1", f + ".FTB_0")
                + convert._ftb_pairs(t + ".ftb2", f + ".FTB_1"), (0, 1))
    return jblocks.AO(24, 1, 2), (x,), blocks.AO(24), convert._ao_pairs, (0,)


@pytest.mark.parametrize("name", ["adain", "adain_v2_enc", "adain_v2_dec", "ftb", "ffm", "ao"])
def test_block_matches_jax(name):
    """Each block alone at a non-square size: AdaIn, AdaInV2 with the
    encoder's and the decoder's scales (a 64×48 image pools to 1×1, then
    resizes to 7×7), FTB, FFM, AO."""
    rng = np.random.default_rng(3)
    jmod, args, tmod, pairs_fn, nchw_args = block_case(name, rng)
    params, stats = init_flax(jmod, *args)
    ref = np.asarray(jmod.apply({"params": params, "batch_stats": stats}, *args))
    got = run_block(load_block(tmod, params, stats, pairs_fn), *args, nchw_args=nchw_args)
    assert_close_rel(got, ref)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (11, 3)), ((12, 10), (24, 20)),
                                          ((4, 4), (7, 7)), ((1, 3), (7, 7)), ((9, 6), (1, 2))])
def test_resize_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(4).standard_normal((2, *in_hw, 5)).astype(np.float32)
    ref = np.asarray(jblocks.resize_bilinear_align_corners(jnp.asarray(x), out_hw))
    with torch.inference_mode():
        got = blocks.resize_align_corners(nchw(x), out_hw).permute(0, 2, 3, 1).numpy()
    # the lerp weight differs by ulps of the source coordinate (up to 1e-6
    # here): JAX forms it as i·(in−1)/(out−1), torch as i·((in−1)/(out−1))
    assert_close_rel(got, ref)


def test_plain_basic_block_backbone_matches_jax():
    """The backbone without AdaIn on the zoo's ResNet-18 (BasicBlocks): all
    four feature maps."""
    jcfg = jmodel.backbone_config("resnet18", d_latent=D_LATENT).with_small()
    cfg = model.backbone_config("resnet18", d_latent=D_LATENT).with_small()
    jenc = jmodel.ResNeXtCIMLE(jcfg, use_adain=False)
    x, _ = inputs(64, seed=5)
    params, stats = init_flax(jenc, x, None, None)
    ref = jenc.apply({"params": params, "batch_stats": stats}, x, None, None)
    pairs = [(t.removeprefix("encoder_modules."), f, k)
             for t, f, k in convert.name_map(cfg, adain=False)
             if t.startswith("encoder_modules.")]
    enc = model.ResNeXtCIMLE(cfg, use_adain=False)
    enc.load_state_dict(convert.tree_to_state_dict({"encoder": params}, {"encoder": stats},
                                                   pairs), strict=True)
    with torch.inference_mode():
        got = enc.eval()(nchw(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert_close_rel(g.permute(0, 2, 3, 1).numpy(), np.asarray(r))


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_state_dict_from_flax_equals_translate(jax_models, version):
    """Key for key and bit for bit the JAX package's own export, plus the
    num_batches_tracked buffers strict loading wants."""
    _, variables = jax_models[version]
    ours = convert.state_dict_from_flax(variables["params"], variables["batch_stats"], SMALL,
                                        version)
    theirs = translate.params_to_torch_state_dict(variables["params"], variables["batch_stats"],
                                                  JSMALL, version=version)
    tracked = {k for k in ours if k.endswith(".num_batches_tracked")}
    assert tracked and all(int(ours[k]) == 0 for k in tracked)
    assert sorted(set(ours) - tracked) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    assert set(ours) == set(model.DepthModelCIMLE(SMALL, version).state_dict())


@pytest.mark.parametrize("container", ["model_state_dict", "state_dict", "bare",
                                       "export_tool"])
def test_upstream_named_checkpoint_loads_strictly(jax_models, tmp_path, container):
    """A state_dict in the reference's names with wrapper prefixes
    (``module.``, ``depth_model.``), DepthNet_cIMLE's ``encoder_modules.encoder.``
    nesting and num_batches_tracked; or, as tools/export_prior_to_torch.py
    writes it, bare names without num_batches_tracked."""
    _, variables = jax_models["v2"]
    expected = convert.state_dict_from_flax(variables["params"], variables["batch_stats"], SMALL)
    if container == "export_tool":
        sd = translate.params_to_torch_state_dict(variables["params"], variables["batch_stats"],
                                                  JSMALL)
        raw = {"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}
    else:
        sd = {"module.depth_model." + k.replace("encoder_modules.", "encoder_modules.encoder.", 1):
              v for k, v in expected.items()}
        raw = sd if container == "bare" else {container: sd, "epoch": 3}
    path = str(tmp_path / "prior.pth")
    torch.save(raw, path)
    m = model.DepthModelCIMLE(SMALL, "v2")
    m.load_state_dict(convert.load_prior_checkpoint(path), strict=True)
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expected[k].numpy(), err_msg=k)


def test_backbone_zoo_and_shift_dims_match_jax():
    for name in jmodel._BACKBONES:
        ours = model.backbone_config(name, d_latent=16)
        theirs = jmodel.backbone_config(name, d_latent=16)
        assert vars(ours) == vars(theirs), name
        assert model.encoder_adain_dims(ours) == jmodel.encoder_adain_dims(theirs)
        assert vars(ours.with_small()) == vars(theirs.with_small())
    zs = model.zero_shifts(SMALL)
    jzs = jmodel.zero_shifts(JSMALL)
    assert sorted(zs) == sorted(jzs)
    assert all(tuple(zs[k].shape) == jzs[k].shape and not zs[k].any() for k in zs)


def test_load_mean_var_adain_matches_jax(tmp_path):
    """The reference's sidecar stores (1, C) arrays; both squeeze them."""
    rng = np.random.default_rng(6)
    d = {f"{w}{i}": rng.standard_normal((1, c)).astype(np.float64)
         for i, c in enumerate(model.encoder_adain_dims(SMALL)) for w in ("mean", "var")}
    path = str(tmp_path / "mean_var_adain.npy")
    np.save(path, d)
    ours = model.load_mean_var_adain(path)
    theirs = jax_load_mean_var_adain(path)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
