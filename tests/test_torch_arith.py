"""The port's float32 arithmetic against the JAX package's jitted steps on the
CPU, bit for bit: ``ops/arith.py``'s fused multiply-add against XLA's
contraction, the ray directions, the jittered strata and Adam.

The JAX package trains and fits test_opt's camera latent in jitted steps,
where XLA contracts a product and its sum into one fused multiply-add. A
latent fit of 100 Adam steps at lr 0.5 amplifies any rounding difference
(tests/test_torch_cli_tasks.py), so these pieces are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

from scade_tpu.ops import rays as jrays
from scade_tpu.ops import volume as jvolume
from scade_tpu_torch.ops import arith, rays, volume
from scade_tpu_torch.train import step


def spread(rng, shape, decades=6):
    """float32 values of both signs over ``decades`` powers of ten."""
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-decades / 2, decades / 2, shape)
            ).astype(np.float32)


def test_fma_is_xlas_contraction():
    rng = np.random.default_rng(0)
    a, b, c = (spread(rng, 1 << 16) for _ in range(3))
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    ours = arith.fma(*(torch.from_numpy(x) for x in (a, b, c)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the product rounded first gives other bits: the check can tell them apart
    assert (((torch.from_numpy(a) * torch.from_numpy(b)) + torch.from_numpy(c)).numpy()
            != ref).any()
    scalar = arith.f32(0.1)
    np.testing.assert_array_equal(
        arith.fma(torch.from_numpy(a), scalar, torch.from_numpy(c)).numpy(),
        np.asarray(jax.jit(lambda a, c: a * np.float32(0.1) + c)(a, c)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_directions_match_jax_bit_for_bit(seed):
    """The full grid (eager, as test_opt makes it) and gathered coordinates
    (jitted, as the train step makes them)."""
    rng = np.random.default_rng(seed)
    H, W = 24, 40
    intr = np.array([30.0, 31.0, 19.5, 12.25], np.float32) * rng.uniform(0.5, 2.0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.random(random_state=seed).as_matrix()
    c2w[:3, 3] = rng.normal(size=3)
    jo, jd = jrays.get_rays(H, W, jnp.asarray(intr), jnp.asarray(c2w))
    po, pd = rays.get_rays(H, W, torch.from_numpy(intr), torch.from_numpy(c2w))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    coords = rng.integers(0, [H, W], size=(512, 2)).astype(np.int32)
    jd = jax.jit(lambda i, c, x: jrays.get_rays_at_coords(i, c, x, H)[1])(
        jnp.asarray(intr), jnp.asarray(c2w), jnp.asarray(coords))
    pd = rays.get_rays_at_coords(torch.from_numpy(intr), torch.from_numpy(c2w),
                                 torch.from_numpy(coords), H)[1]
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n_samples", [8, 64])
def test_jittered_strata_match_jitted_jax(n_samples):
    rng = np.random.default_rng(n_samples)
    z = np.sort(rng.uniform(0.1, 6.0, (256, n_samples)).astype(np.float32), -1)
    t = rng.uniform(size=z.shape).astype(np.float32)
    ref = np.asarray(jax.jit(jvolume.perturb_z_vals)(z, t))
    ours = volume.perturb_z_vals(torch.from_numpy(z), torch.from_numpy(t))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("lr", [0.5, 5e-4, 0.3])
def test_adam_update_is_jitted_optax_bit_for_bit(lr):
    """300 steps on gradients of magnitudes 1e-4 to 10, parameters and both
    moments compared after each; a frozen step (``apply=False``) against
    optax's update zeroed, as the JAX package freezes scale/shift."""
    opt = optax.adam(lr)

    @jax.jit
    def jax_step(p, s, g, frozen):
        u, s = opt.update(g, s, p)
        u = jnp.where(frozen, jnp.zeros_like(u), u)
        return optax.apply_updates(p, u), s

    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(4096).astype(np.float32)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p = torch.from_numpy(p0.copy())
    state = step.AdamState.zeros_like([p])
    for i in range(300):
        g = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
        frozen = i % 50 == 49
        jp, js = jax_step(jp, js, jnp.asarray(g), frozen)
        step.adam_update([p], [torch.from_numpy(g)], state,
                         step.adam_feed(lr, state.count + 1, "cpu"), apply=not frozen)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp), err_msg=f"step {i}")
        np.testing.assert_array_equal(state.mu[0].numpy(), np.asarray(js[0].mu))
        np.testing.assert_array_equal(state.nu[0].numpy(), np.asarray(js[0].nu))
    assert state.count == int(js[0].count) == 300
