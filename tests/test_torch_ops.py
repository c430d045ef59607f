"""scade_tpu_torch.ops against live scade_tpu.ops and the reference goldens.

Inputs come from numpy seeds and go to both packages on the CPU. Tolerances:
- the goldens keep the tolerances of tests/test_parity_ops.py (they were taken
  from the upstream torch code on another machine);
- live comparisons of pure elementwise arithmetic are exact or 1e-6: the two
  frameworks share the operation order but not their sin/cos/exp
  polynomials, which differ by an ulp or two;
- the inverse-CDF lookup on a shared CDF: atol 2e-6, rtol 1e-6, the bound the
  JAX package holds its own lowerings to; end to end from the weights rtol
  1e-4 (see test_sample_pdf_live).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from scade_tpu import ops as jops
from scade_tpu.ops import sampling as jsampling
from scade_tpu_torch import ops
from scade_tpu_torch.ops import sampling, volume


def t(x):
    return torch.from_numpy(np.array(x))


def test_port_imports_neither_jax_nor_scade_tpu():
    code = (
        "import sys, pkgutil, importlib, scade_tpu_torch\n"
        "pkg = scade_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'scade_tpu_torch.')]\n"
        "assert len(names) >= 54, names\n"
        "for n in names: importlib.import_module(n)\n"
        "banned = ('jax', 'jaxlib', 'optax', 'flax', 'scade_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("multires", [9, 10, 4, 0])
def test_embedding_golden_and_live(multires):
    g = load_golden(f"embed_multires{multires}")
    emb = ops.get_embedder(multires, 0)
    y = ops.positional_encoding(t(g["x"]), emb).numpy()
    assert y.shape == g["y"].shape
    np.testing.assert_allclose(y, g["y"], rtol=1e-5, atol=1e-5)
    live = np.asarray(jops.positional_encoding(jnp.asarray(g["x"]), jops.get_embedder(multires, 0)))
    np.testing.assert_allclose(y, live, rtol=0, atol=1e-6)
    assert emb.out_dim == jops.get_embedder(multires, 0).out_dim


def test_embedding_identity_and_empty():
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(ops.positional_encoding(t(x), ops.get_embedder(9, -1)).numpy(), x)
    empty = ops.Embedder(num_freqs=0, include_input=False)
    assert ops.positional_encoding(t(x), empty).shape == (5, 0)


def test_rays_golden_and_live():
    g = load_golden("rays")
    H, W = int(g["H"]), int(g["W"])
    ro, rd = ops.get_rays(H, W, t(g["intr"]), t(g["c2w"]))
    np.testing.assert_allclose(ro.numpy(), g["rays_o"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rd.numpy(), g["rays_d"], rtol=1e-5, atol=1e-5)
    ro, rd = ops.get_rays(H, W, t(g["intr"]), t(g["c2w"]), coords=t(g["coords"]))
    np.testing.assert_allclose(ro.numpy(), g["rays_o_c"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rd.numpy(), g["rays_d_c"], rtol=1e-5, atol=1e-5)
    jro, jrd = jops.get_rays(H, W, jnp.asarray(g["intr"]), jnp.asarray(g["c2w"]))
    np.testing.assert_allclose(ops.get_rays(H, W, t(g["intr"]), t(g["c2w"]))[1].numpy(),
                               np.asarray(jrd), rtol=0, atol=1e-6)
    _, rd_c = ops.get_rays_at_coords(t(g["intr"]), t(g["c2w"]), t(g["coords"]), H)
    np.testing.assert_allclose(rd_c.numpy(), g["rays_d_c"], rtol=1e-5, atol=1e-5)


def test_z_vals_live():
    rng = np.random.default_rng(1)
    near = rng.uniform(0.1, 1.0, (7, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 5.0, (7, 1)).astype(np.float32)
    t_rand = rng.uniform(size=(7, 16)).astype(np.float32)
    for lindisp in (False, True):
        z = ops.stratified_z_vals(t(near), t(far), 16, lindisp)
        jz = jops.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16, lindisp)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6, atol=0)
        zp = ops.perturb_z_vals(z, t(t_rand))
        jzp = jops.perturb_z_vals(jz, jnp.asarray(t_rand))
        np.testing.assert_allclose(zp.numpy(), np.asarray(jzp), rtol=1e-6, atol=0)


def test_raw2outputs_golden_and_live():
    g = load_golden("raw2outputs")
    rgb_map, disp_map, acc_map, weights, depth_map = ops.raw2outputs(
        t(g["raw"]), t(g["z_vals"]), t(g["rays_d"])
    )
    np.testing.assert_allclose(weights.numpy(), g["weights"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb_map.numpy(), g["rgb_map"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(depth_map.numpy(), g["depth_map"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc_map.numpy(), g["acc_map"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(disp_map.numpy(), g["disp_map"], rtol=1e-4, atol=1e-5)

    noise = np.random.default_rng(2).normal(size=g["z_vals"].shape).astype(np.float32)
    ours = ops.raw2outputs(t(g["raw"]), t(g["z_vals"]), t(g["rays_d"]), t(noise))
    live = jops.raw2outputs(jnp.asarray(g["raw"]), jnp.asarray(g["z_vals"]),
                            jnp.asarray(g["rays_d"]), jnp.asarray(noise))
    for a, b in zip(ours, live):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    w = volume.compute_weights(t(g["raw"]), t(g["z_vals"]), t(g["rays_d"]))
    np.testing.assert_allclose(w.numpy(), g["weights"], rtol=1e-5, atol=1e-6)


def test_sample_pdf_golden():
    g = load_golden("sample_pdf")
    bins, w = t(g["bins"]), t(g["weights"])
    np.testing.assert_allclose(ops.sample_pdf(bins, w, t(g["u"])).numpy(), g["samples"],
                               rtol=1e-4, atol=1e-4)
    u_det = ops.draw_u(None, bins.shape[0], 64, det=True)
    np.testing.assert_allclose(ops.sample_pdf(bins, w, u_det).numpy(), g["samples_det"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ops.sample_pdf(bins, w, t(g["u_joint"])).numpy(),
                               g["samples_joint"], rtol=1e-4, atol=1e-4)


def pdf_inputs(m, squared=False, seed=None):
    rng = np.random.default_rng(m if seed is None else seed)
    bins = np.sort(rng.uniform(0.5, 6.0, (40, m)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (40, m - 1)).astype(np.float32)
    if squared:
        w = w**2
        w[:3] = 0.0  # the 1e-5 floor alone
    u = rng.uniform(0, 1, (40, 128)).astype(np.float32)
    u[:, :4] = [0.0, 1e-8, 1.0 - 1e-7, 1.0]
    return bins, w, u


@pytest.mark.parametrize("m", [63, 191, 17])
def test_lookup_live(m):
    """Given the same CDF, the lookup is the JAX masked form's to 2e-6 (it is
    bitwise equal here), values and gradients."""
    import jax

    bins, w, u = pdf_inputs(m, squared=True)
    cdf = np.asarray(jsampling._cdf_from_weights(w))
    ours = sampling.lookup(t(cdf), t(bins), t(u)).numpy()
    live = np.asarray(jsampling._lookup_masked(bins, cdf, u))
    np.testing.assert_allclose(ours, live, atol=2e-6, rtol=1e-6)

    ct, bt = t(cdf).requires_grad_(True), t(bins).requires_grad_(True)
    (sampling.lookup(ct, bt, t(u)) ** 2).sum().backward()
    gb, gc = jax.grad(lambda b_, c_: jnp.sum(jsampling._lookup_masked(b_, c_, u) ** 2),
                      (0, 1))(bins, cdf)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc), rtol=2e-5,
                               atol=1e-5 * np.abs(np.asarray(gc)).max())
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("m", [63, 191])
def test_sample_pdf_live(m):
    """End to end from the weights. Each framework builds the CDF with its own
    sum and cumsum order, which differ by up to 3 ulp (2.4e-7); the lookup
    multiplies a CDF error by (bin gap)/(CDF gap), about 100 for these
    inputs, so samples agree to rtol 1e-4 and the CDFs to 1e-6."""
    bins, w, u = pdf_inputs(m)
    np.testing.assert_allclose(sampling._cdf_from_weights(t(w)).numpy(),
                               np.asarray(jsampling._cdf_from_weights(w)), atol=1e-6, rtol=0)
    ours = ops.sample_pdf(t(bins), t(w), t(u)).numpy()
    live = np.asarray(jops.sample_pdf(bins, w, u))
    np.testing.assert_allclose(ours, live, atol=2e-6, rtol=1e-4)


def test_draws():
    u = ops.draw_u(None, 3, 5, det=True)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jops.draw_u(None, 3, 5, det=True)))
    gen = torch.Generator().manual_seed(0)
    uj = ops.draw_u(gen, 4, 6, joint=True)
    assert uj.shape == (4, 6) and (uj == uj[:1]).all()
    us = ops.draw_u_sorted(gen, 500, 8)
    assert us.shape == (500, 8)
    assert (us[:, 1:] >= us[:, :-1]).all() and (us > 0).all() and (us < 1).all()
    # the k-th of 8 uniform order statistics has mean k / 9
    np.testing.assert_allclose(us.mean(0).numpy(), np.arange(1, 9) / 9.0, atol=0.03)
    usj = ops.draw_u_sorted(gen, 4, 8, joint=True)
    assert (usj == usj[:1]).all()
    np.testing.assert_array_equal(ops.draw_u_sorted(None, 2, 5, det=True).numpy(), u[:2].numpy())


def test_merge_sorted_live():
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 20, (6, 9)), -1).astype(np.float32)  # integer values: ties
    b = np.sort(rng.integers(0, 20, (6, 13)), -1).astype(np.float32)
    va = rng.normal(size=(6, 9, 4)).astype(np.float32)
    vb = rng.normal(size=(6, 13, 4)).astype(np.float32)
    z, v = ops.merge_sorted(t(a), t(b), t(va), t(vb))
    jz, jv = jops.merge_sorted(a, b, va, vb)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ops.merge_sorted(t(a), t(b)).numpy(), np.asarray(jz))


@pytest.mark.parametrize("is_joint", [False, True])
@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_space_carving_golden_and_live(is_joint, threshold):
    g = load_golden("space_carving")
    loss = ops.compute_space_carving_loss(t(g["pred"]), t(g["hyp"]), is_joint=is_joint,
                                          threshold=threshold)
    ref = g[f"loss_j{int(is_joint)}_t{threshold}"]
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5, atol=1e-6)
    masked = ops.compute_space_carving_loss(t(g["pred"]), t(g["hyp"]), is_joint=is_joint,
                                            mask=t(g["mask"]), threshold=threshold)
    live = jops.compute_space_carving_loss(jnp.asarray(g["pred"]), jnp.asarray(g["hyp"]),
                                           is_joint=is_joint, mask=jnp.asarray(g["mask"]),
                                           threshold=threshold)
    np.testing.assert_allclose(float(masked), float(live), rtol=1e-6, atol=1e-7)
    if threshold == 0.0:
        np.testing.assert_allclose(float(masked), float(g[f"loss_mask_j{int(is_joint)}"]),
                                   rtol=1e-5, atol=1e-6)


def test_mse_psnr_live():
    rng = np.random.default_rng(4)
    x, y = rng.uniform(size=(2, 50, 3)).astype(np.float32)
    mse = ops.img2mse(t(x), t(y))
    np.testing.assert_allclose(float(mse), float(jops.img2mse(x, y)), rtol=1e-6)
    np.testing.assert_allclose(float(ops.mse2psnr(mse)), float(jops.mse2psnr(jnp.float32(mse))),
                               rtol=1e-6)
