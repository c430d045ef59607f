"""scade_tpu_torch.prior.losses against scade_tpu.prior.losses on the CPU.

Inputs come from numpy seeds; the JAX functions take NHWC, the port's NCHW,
converted here at the boundary. The sampled losses run on the JAX package's
own draws: the test splits the keys as ``criterion`` does (losses.py:725;
per image :290/:258, :496/:464, :688/:555; inside ``_edge_guided_pairs``
:229), draws with JAX's ``masked_sample`` and ``_edge_guided_pairs`` (for
the planes the ``cdf`` lowering, bit-identical to ``perm``:
tests/test_prior.py::test_pwn_planes_perm_matches_cdf) and feeds those
indices to the port.

Tolerances (f32 on both sides; the frameworks reduce in other orders):
- indices (``masked_sample`` on fed uniforms, ``edge_pairs``): exact;
- losses: 1e-5 relative to the loss (largest measured 4e-7);
- gradients w.r.t. the prediction: 1e-4 of their largest magnitude
  (measured: 2.7e-5 for the scale/shift fit, whose 2×2 solve the port runs
  in f64 and the JAX package in f32, so the distance is JAX's; 1.1e-5 for
  the whole criterion; 8e-7 or less for the rest);
- maps (normals, edges, xyz, pooled depth, the aligned depth): 1e-5 of
  their largest magnitude (measured 2.5e-6 for the aligned depth, 1.4e-7 or
  less for the rest); orientations (atan2): 1e-4 absolute where the
  magnitude is not ~0 (where it is, the angle of two rounding residues is
  noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.prior import losses as J
from scade_tpu_torch.prior import losses as L

LOSS_REL = 1e-5
GRAD_REL = 1e-4
MAP_REL = 1e-5
MODE = L.DEFAULT_LOSS_MODE


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


def scene(B, H, W, seed=0, quality=3, invalid_rows=0, planes=None):
    """A seeded batch: NHWC numpy for JAX, NCHW tensors for the port."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    gt = (2.0 + 0.03 * xx + 0.02 * yy)[None, :, :, None] + rng.uniform(0, 2.0, (B, H, W, 1))
    gt[:, H // 3:H // 2, W // 4:W // 2] += 3.0  # a step: depth edges
    gt[:, :invalid_rows] = -1.0
    rgb = rng.uniform(-2.0, 2.0, (B, H, W, 3))
    rgb[:, :, W // 2:, 0] += 2.0  # an image edge
    if planes is None:
        planes = np.zeros((B, H, W), np.int32)
    pred = gt[..., :1] * rng.uniform(0.5, 1.5, (B, 1, 1, 1)) + rng.normal(0, 0.3, (B, H, W, 1))
    jb = {"depth": gt.astype(np.float32), "rgb": rgb.astype(np.float32),
          "planes": planes.astype(np.int32),
          "focal_length": np.full((B,), 250.0, np.float32),
          "quality_flg": np.full((B,), quality, np.int32)}
    tb = {"depth": nchw(jb["depth"]), "rgb": nchw(jb["rgb"]),
          "planes": torch.from_numpy(jb["planes"]).long(),
          "focal_length": torch.from_numpy(jb["focal_length"]),
          "quality_flg": torch.from_numpy(jb["quality_flg"])}
    return jb, tb, pred.astype(np.float32)


def seeded_planes(B, H, W, seed=1):
    """Plane ids: plane 1 over most of each image, plane 2 a band, plane 3
    too small to count, id 9 past max_planes."""
    rng = np.random.default_rng(seed)
    p = np.ones((B, H, W), np.int32)
    p[:, : H // 5] = 2
    p[:, -3:, -3:] = 3
    p[:, H // 5: H // 5 + 2] = 9
    p[rng.uniform(size=(B, H, W)) < 0.05] = 0
    return p


def port_value_and_grad(fn, pred):
    p = nchw(pred).requires_grad_(True)
    out = fn(p)
    out.sum().backward()
    return out.detach().numpy(), nhwc(p.grad)


def jax_value_and_grad(fn, pred):
    out, vjp = jax.vjp(fn, jnp.asarray(pred))
    (g,) = vjp(jnp.ones_like(out))
    return np.asarray(out), np.asarray(g)


# ---------------------------------------------------------------------------
# sampling laws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [7, 511, 512, 513, 5000, 100])
def test_masked_sample_law_on_fed_uniforms(P):
    """The port's searchsorted law on JAX's own uniforms gives JAX's bucketed
    indices, the empty mask (P = 100 here) all P−1."""
    key = jax.random.PRNGKey(P)
    rng = np.random.default_rng(P)
    mask = rng.uniform(size=P) < (0.0 if P == 100 else 0.3)
    n = 257
    ref, ok = J.masked_sample(key, jnp.asarray(mask), n)
    u = np.array(jax.random.uniform(key, (n,)))
    got = L.masked_sample(torch.from_numpy(mask), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert bool(ok) == mask.any()
    if mask.any():
        assert mask[got].all()
    else:
        assert (got == P - 1).all()


def test_edge_pairs_match_jax():
    """``edge_pairs`` on JAX's anchors and distances equals
    ``_edge_guided_pairs``."""
    _, tb, _ = scene(1, 40, 56, seed=2)
    im = np.moveaxis(tb["rgb"][0].numpy(), 0, -1)
    edges, thetas = J.sobel_edges(jnp.asarray(im[..., 0]))
    H, W = 40, 56
    for lo, hi in ((2, 31), (3, 20)):
        key = jax.random.PRNGKey(lo)
        A, B = J._edge_guided_pairs(key, edges, thetas, H, W, 300, lo, hi)
        k1, k2 = jax.random.split(key)
        flat = edges.reshape(-1)
        anchors, _ = J.masked_sample(k1, flat >= 0.1 * jnp.max(flat), 300)
        dist = jax.random.randint(k2, (4, 300), lo, hi)
        gA, gB = L.edge_pairs(torch.from_numpy(np.asarray(anchors)).long()[None],
                              torch.from_numpy(np.asarray(dist)).long()[None],
                              torch.from_numpy(np.asarray(thetas))[None], H, W)
        np.testing.assert_array_equal(gA[0].numpy(), np.asarray(A))
        np.testing.assert_array_equal(gB[0].numpy(), np.asarray(B))


# ---------------------------------------------------------------------------
# deterministic losses and maps, value and gradient w.r.t. the prediction
# ---------------------------------------------------------------------------

DETERMINISTIC = {
    "ilnr": (lambda p, g, f: J.ilnr_loss(p, g), lambda p, g, f: L.ilnr_loss(p, g)),
    "ilnr_trimmed": (lambda p, g, f: J.ilnr_loss(p, g, trimmed_stats=True),
                     lambda p, g, f: L.ilnr_loss(p, g, trimmed_stats=True)),
    "msgil": (lambda p, g, f: J.msgil_loss(p, g), lambda p, g, f: L.msgil_loss(p, g)),
    "msgil_trimmed": (lambda p, g, f: J.msgil_loss(p, g, trimmed_stats=True),
                      lambda p, g, f: L.msgil_loss(p, g, trimmed_stats=True)),
    "msgil_progressive": (lambda p, g, f: J.msgil_loss(p, g, scale=3, progressive=True),
                          lambda p, g, f: L.msgil_loss(p, g, scale=3, progressive=True)),
    "recover_scale_shift": (lambda p, g, f: J.recover_scale_shift_depth(p, g),
                            lambda p, g, f: L.recover_scale_shift_depth(p, g)),
    "surface_normal": (lambda p, g, f: J.surface_normal_from_depth(p, f, g > 0),
                       lambda p, g, f: L.surface_normal_from_depth(p, f, g > 0)),
    "depth_to_xyz": (lambda p, g, f: J.depth_to_xyz(p, f), lambda p, g, f: L.depth_to_xyz(p, f)),
    "avg_pool3": (lambda p, g, f: J._avg_pool3(p), lambda p, g, f: L._avg_pool3(p)),
}


@pytest.mark.parametrize("name", list(DETERMINISTIC))
def test_deterministic_loss_and_grad_match_jax(name):
    jb, tb, pred = scene(2, 24, 32, seed=3, invalid_rows=3)
    jfn, tfn = DETERMINISTIC[name]
    f = jnp.asarray(jb["focal_length"])
    ref, ref_g = jax_value_and_grad(lambda p: jfn(p, jnp.asarray(jb["depth"]), f), pred)
    got, got_g = port_value_and_grad(lambda p: tfn(p, tb["depth"], tb["focal_length"]), pred)
    if got.ndim == 4:
        got = np.moveaxis(got, 1, -1)
    close(got, ref, MAP_REL if got.ndim == 4 else LOSS_REL)
    close(got_g, ref_g, GRAD_REL)


def test_safe_normalize_and_its_gradient_at_zero():
    v = np.random.default_rng(4).normal(size=(2, 5, 3)).astype(np.float32)
    v[0, 0] = 0.0
    ref, ref_g = jax_value_and_grad(lambda x: J.safe_normalize(x, axis=-1), v)
    got, got_g = port_value_and_grad(lambda x: L.safe_normalize(x, dim=1), v)
    close(np.moveaxis(got, 1, -1), ref, MAP_REL)
    close(got_g, ref_g, GRAD_REL)
    assert np.isfinite(got_g).all()


def test_edge_maps_match_jax():
    """Sobel edges and orientations, and pwn_edge_maps' four maps."""
    jb, tb, _ = scene(2, 28, 36, seed=5, invalid_rows=2)
    masks = jnp.asarray(jb["depth"]) > -1e-8
    n_g = J.surface_normal_from_depth(jnp.asarray(jb["depth"]), jnp.asarray(jb["focal_length"]),
                                      masks)
    tn_g = L.surface_normal_from_depth(tb["depth"], tb["focal_length"], tb["depth"] > -1e-8)
    got = L.pwn_edge_maps(tb["rgb"], tn_g, tb["depth"])
    ge, gt_ = L.sobel_edges(tb["rgb"][:, 0])
    for b in range(2):
        ref = J.pwn_edge_maps(jnp.asarray(jb["rgb"][b]), n_g[b], jnp.asarray(jb["depth"][b]))
        re, rt = J.sobel_edges(jnp.asarray(jb["rgb"][b, ..., 0]))
        for mag, ang, rmag, rang in ((got[0][b], got[1][b], ref[0], ref[1]),
                                     (got[2][b], got[3][b], ref[2], ref[3]),
                                     (ge[b], gt_[b], re, rt)):
            rmag, rang = np.asarray(rmag), np.asarray(rang)
            close(mag.numpy(), rmag, MAP_REL)
            solid = np.abs(rmag) > 1e-3 * np.abs(rmag).max()
            assert (np.abs(ang.numpy() - rang)[solid] <= 1e-4).all()


# ---------------------------------------------------------------------------
# sampled losses on the JAX package's own draws
# ---------------------------------------------------------------------------


def jax_ranking_draws(key, jb, n_anchors=3000):
    B, H, W = jb["depth"].shape[:3]
    A, Bs = [], []
    for b, kb in enumerate(jax.random.split(key, B)):
        k_e, k_r = jax.random.split(kb)
        edges, thetas = J.sobel_edges(jnp.asarray(jb["rgb"][b, ..., 0]))
        a, bb = J._edge_guided_pairs(k_e, edges, thetas, H, W, n_anchors, 2, 31)
        r, _ = J.masked_sample(k_r, jnp.asarray(jb["depth"][b].reshape(-1) > -1e-8),
                               2 * n_anchors)
        A.append(np.concatenate([a, r[0::2]]))
        Bs.append(np.concatenate([bb, r[1::2]]))
    return torch.from_numpy(np.stack(A)).long(), torch.from_numpy(np.stack(Bs)).long()


def jax_edge_draws(key, jb, pred_ss_unused=None, n_anchors=3000):
    B, H, W = jb["depth"].shape[:3]
    gt = jnp.asarray(jb["depth"])
    n_g = J.surface_normal_from_depth(gt, jnp.asarray(jb["focal_length"]), gt > -1e-8)
    out = [[], [], [], []]
    for b, kb in enumerate(jax.random.split(key, B)):
        k1, k2, k3 = jax.random.split(kb, 3)
        ei, ti, en, tn = J.pwn_edge_maps(jnp.asarray(jb["rgb"][b]), n_g[b], gt[b])
        A1, B1 = J._edge_guided_pairs(k1, ei, ti, H, W, n_anchors, 3, 20)
        A2, B2 = J._edge_guided_pairs(k2, en, tn, H, W, n_anchors, 3, 20)
        r, _ = J.masked_sample(k3, gt[b].reshape(-1) > -1e-8, 4 * n_anchors)
        for lst, v in zip(out, (np.concatenate([A1, A2]), np.concatenate([B1, B2]),
                                r[0::2], r[1::2])):
            lst.append(np.asarray(v))
    return tuple(torch.from_numpy(np.stack(v)).long() for v in out)


def jax_plane_draws(key, planes, sample_groups=5000, max_planes=8):
    idx, counts = [], []
    for b, kb in enumerate(jax.random.split(key, planes.shape[0])):
        flat = jnp.asarray(planes[b].reshape(-1))
        rows, cnt = [], []
        for j, kj in enumerate(jax.random.split(kb, max_planes)):
            mask = flat == j + 1
            i, _ = J.masked_sample(kj, mask, 3 * sample_groups)
            rows.append(np.asarray(i))
            cnt.append(int(mask.sum()))
        idx.append(rows)
        counts.append(cnt)
    return torch.from_numpy(np.array(idx)).long(), torch.tensor(counts)


def test_ranking_edge_loss_on_jax_draws():
    jb, tb, pred = scene(2, 32, 40, seed=6, invalid_rows=4)
    key = jax.random.PRNGKey(6)
    pairs = jax_ranking_draws(key, jb)
    ref, ref_g = jax_value_and_grad(
        lambda p: J.ranking_edge_loss(key, p, jnp.asarray(jb["depth"]), jnp.asarray(jb["rgb"])),
        pred)
    got, got_g = port_value_and_grad(lambda p: L.ranking_edge_loss(p, tb["depth"], pairs), pred)
    close(got, ref, LOSS_REL)
    close(got_g, ref_g, GRAD_REL)


def test_pwn_edge_loss_on_jax_draws():
    jb, tb, pred = scene(2, 40, 48, seed=7, invalid_rows=3)
    key = jax.random.PRNGKey(7)
    pairs = jax_edge_draws(key, jb)
    gt, f = jnp.asarray(jb["depth"]), jnp.asarray(jb["focal_length"])
    ref, ref_g = jax_value_and_grad(
        lambda p: J.pwn_edge_loss(key, p, gt, jnp.asarray(jb["rgb"]), f), pred)
    got, got_g = port_value_and_grad(
        lambda p: L.pwn_edge_loss(p, tb["depth"], tb["focal_length"], pairs), pred)
    assert (ref > 0).all()
    close(got, ref, LOSS_REL)
    close(got_g, ref_g, GRAD_REL)


@pytest.mark.parametrize("case", ["mixed", "full_and_sign"])
def test_pwn_planes_loss_on_jax_draws(case):
    """The cases of tests/test_prior.py's perm-vs-cdf and reference-semantics
    tests: ids past max_planes, empty and sub-threshold planes, a
    full-support plane; a negated depth (|depth| in x, y)."""
    B, H, W = 2, 48, 64
    rng = np.random.default_rng(8)
    pred = rng.uniform(0.3, 5.0, (B, H, W, 1)).astype(np.float32)
    planes = rng.integers(0, 3, (B, H, W)).astype(np.int32)
    if case == "mixed":
        planes[0, :2, :] = 9
        planes[1, 4:6, 4:6] = 4
        planes[1, 20:40, :] = 3
    else:
        planes[:] = 1
        pred[1] = -pred[1]
    f = np.full((B,), 300.0, np.float32)
    key = jax.random.PRNGKey(8)
    draws = jax_plane_draws(key, planes, sample_groups=32, max_planes=4)
    ref, ref_g = jax_value_and_grad(
        lambda p: J.pwn_planes_loss(key, p, p, jnp.asarray(planes), jnp.asarray(f),
                                    sample_groups=32, max_planes=4, impl="cdf"), pred)
    got, got_g = port_value_and_grad(
        lambda p: L.pwn_planes_loss(p, torch.from_numpy(f), draws, sample_groups=32), pred)
    assert np.abs(ref).sum() > 0
    close(got, ref, LOSS_REL)
    close(got_g, ref_g, GRAD_REL)


def jax_criterion_draws(key, jb):
    k_rank, k_edge, k_plane = jax.random.split(key, 3)
    return {"ranking": jax_ranking_draws(k_rank, jb), "edge": jax_edge_draws(k_edge, jb),
            "plane": jax_plane_draws(k_plane, jb["planes"])}


@pytest.mark.parametrize("quality", [3, 2])
def test_criterion_matches_jax(quality):
    """All five losses at the defaults (3000 anchors, 5000 groups a plane,
    8 planes) on a 112×128 batch whose planes carry the plane loss; quality
    3 opens the PWN edge loss, 2 closes it."""
    B, H, W = 2, 112, 128
    jb, tb, pred = scene(B, H, W, seed=9, quality=quality, invalid_rows=6,
                         planes=seeded_planes(B, H, W))
    key = jax.random.PRNGKey(9)
    draws = jax_criterion_draws(key, jb)
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    ref_dict, _ = J.criterion(key, jnp.asarray(pred), jbatch, MODE)
    ref, ref_g = jax_value_and_grad(lambda p: J.criterion(key, p, jbatch, MODE)[1], pred)
    p = nchw(pred).requires_grad_(True)
    got_dict, total = L.criterion(p, tb, MODE, draws)
    total.sum().backward()
    assert list(got_dict) == list(ref_dict)
    for k in ref_dict:
        close(got_dict[k].detach().numpy(), np.asarray(ref_dict[k]), LOSS_REL)
    close(total.detach().numpy(), ref, LOSS_REL)
    close(nhwc(p.grad), ref_g, GRAD_REL)
    assert float(ref_dict["pairwise-normal-regress-plane_loss"]) > 0
    edge = float(got_dict["pairwise-normal-regress-edge_loss"].detach())
    assert (edge > 0) if quality == 3 else (edge == 0.0)


def test_criterion_gradients_finite_on_degenerate_input():
    """tests/test_prior.py:124's case on the port with its own draws: half the
    image invalid, no plane at all, quality 3; then all of it invalid."""
    jb, tb, pred = scene(1, 24, 32, seed=3, invalid_rows=12)
    gen = torch.Generator().manual_seed(0)
    for depth in (tb["depth"], torch.full_like(tb["depth"], -1.0)):
        batch = dict(tb, depth=depth)
        p = nchw(pred).requires_grad_(True)
        _, total = L.criterion(p, batch, MODE, generator=gen)
        total.sum().backward()
        assert torch.isfinite(total).all() and torch.isfinite(p.grad).all()


def test_port_draws_follow_their_masks():
    """The port's own draws: anchors on strong edges, random pairs on valid
    depth, plane pixels inside their plane, distances in range."""
    B, H, W = 2, 64, 80
    jb, tb, _ = scene(B, H, W, seed=10, invalid_rows=8, planes=seeded_planes(B, H, W))
    gen = torch.Generator().manual_seed(1)
    draws = L.draw_criterion(gen, tb, MODE)
    valid = (tb["depth"] > -1e-8).reshape(B, -1)
    A, Bi = draws["ranking"]
    assert A.shape == Bi.shape == (B, 4 * 3000)
    assert valid.gather(1, A[:, 9000:]).all() and valid.gather(1, Bi[:, 9000:]).all()
    edges, _ = L.sobel_edges(tb["rgb"][:, 0])
    ef = edges.reshape(B, -1)
    strong = ef >= 0.1 * ef.max(1, keepdim=True).values
    # the first third of the edge pairs starts at an anchor's first offset;
    # the anchors themselves sit between points b and c: within 30 px of A
    assert (A[:, :9000] < H * W).all() and strong.any(1).all()
    idx, counts = draws["plane"]
    flat = tb["planes"].reshape(B, -1)
    for j in range(8):
        sel = flat.gather(1, idx[:, j])
        has = counts[:, j] > 0
        assert (sel[has] == j + 1).all()
        assert (idx[~has, j] == H * W - 1).all()
    eA, eB, rA, rB = draws["edge"]
    assert eA.shape == (B, 6 * 3000) and rA.shape == (B, 6000)
    assert valid.gather(1, rA).all() and valid.gather(1, rB).all()
