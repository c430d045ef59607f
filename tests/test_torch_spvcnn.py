"""The SPVCNN classifier in the port (``scade_tpu_torch/prior/spvcnn.py``):
the oracles of tests/test_spvcnn.py, then parity with live ``scade_tpu``.

Oracles (the reference's own module cannot be imported, so correctness is
pinned by construction): the key matching and dedup against dict/np.unique,
sparse convs at stride 1 and 2 against torch's dense ``conv3d`` on a fully
occupied block, devoxelization against direct trilinear interpolation, the
voxelization means, the transpose conv, padding/permutation/batch
invariance, masked BN and pooling, and the depth → point cloud input functions.

Parity: ``sparse_match``, ``sparse_unique`` and ``sparse_conv3d`` array for
array (matches and sites exactly, conv features to 2e-5, f32 sums of 27
products in other orders), and the classifier on ``init_spvcnn``'s weights
carried over by ``convert.spvcnn_params_to_state_dict`` at cr=0.25 and
capacity 48, to rtol 1e-4 / atol 1e-6 (f32 sums in other orders through
about 20 layers). The JAX side is computed once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scade_tpu.prior import spvcnn as jsp
from scade_tpu_torch.prior import spvcnn as sp
from scade_tpu_torch.prior.convert import spvcnn_params_to_state_dict
from scade_tpu_torch.prior.spvcnn import (
    SPVCNNConfig,
    SparsePoints,
    SparseVoxels,
    _kernel_offsets,
    batch_norm_masked,
    depth_to_pcd,
    global_avg_pool,
    init_image_coor,
    init_spvcnn,
    initial_voxelize,
    pcd_to_sparsetensor,
    pcd_uv_to_sparsetensor,
    point_to_voxel,
    refine_focal,
    refine_shift,
    sparse_conv3d,
    sparse_conv3d_transpose,
    sparse_match,
    sparse_unique,
    voxel_to_point,
)

CONV_TOL = 2e-5
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def _rand_coords(rng, n, lo=-6, hi=6, batches=2):
    c = rng.randint(lo, hi, size=(n, 3))
    b = rng.randint(0, batches, size=(n, 1))
    return np.concatenate([c, b], 1).astype(np.int32)


def _match_case(seed=0):
    rng = np.random.RandomState(seed)
    table = _rand_coords(rng, 64)
    _, keep = np.unique(table, axis=0, return_index=True)
    tmask = np.zeros(64, bool)
    tmask[keep] = True
    query = _rand_coords(rng, 96)
    qmask = rng.rand(96) > 0.2
    return table, tmask, query, qmask


def _unique_case(seed=1):
    rng = np.random.RandomState(seed)
    return _rand_coords(rng, 80, lo=-3, hi=3), rng.rand(80) > 0.3


def _dense_block(rng, d, cin, batches=1):
    """All sites of a d³ grid as a SparseVoxels (capacity = exact), and the
    same features as a dense (B, d, d, d, C) array indexed [b, x, y, z]."""
    g = np.stack(np.meshgrid(*([np.arange(d)] * 3), indexing="ij"), -1).reshape(-1, 3)
    coords, feats = [], []
    for b in range(batches):
        coords.append(np.concatenate([g, np.full((g.shape[0], 1), b)], 1))
        feats.append(rng.randn(g.shape[0], cin))
    coords = np.concatenate(coords).astype(np.int32)
    feats = np.concatenate(feats).astype(np.float32)
    dense = np.zeros((batches, d, d, d, cin), np.float32)
    dense[coords[:, 3], coords[:, 0], coords[:, 1], coords[:, 2]] = feats
    return coords, feats, dense


def _voxels(coords, feats, stride=1):
    return SparseVoxels(t(feats), t(coords), torch.ones(coords.shape[0], dtype=torch.bool), stride)


def _dense_weight(w: np.ndarray, ks: int) -> torch.Tensor:
    """(ks³, Cin, Cout) indexed by offset (x fastest over (z, y, x)) → conv3d's
    (Cout, Cin, kx, ky, kz) for a (B, C, x, y, z) input."""
    return t(w).reshape(ks, ks, ks, w.shape[1], w.shape[2]).permute(4, 3, 2, 1, 0)


def _toy_points(rng, n, cap, cin=3, batches=1, scale=4.0):
    pts = (rng.rand(n, 3) * scale).astype(np.float32)
    b = rng.randint(0, batches, size=(n, 1)).astype(np.float32)
    feats = np.zeros((cap, cin), np.float32)
    fc = np.zeros((cap, 4), np.float32)
    feats[:n] = rng.randn(n, cin)
    fc[:n] = np.concatenate([pts, b], 1)
    return feats, fc, np.arange(cap) < n


def _points(feats, fc, mask):
    return SparsePoints(t(feats), t(fc), t(mask))


@pytest.fixture(scope="module")
def tiny_net():
    cfg = SPVCNNConfig(input_channel=3, num_classes=1, cr=0.25, pres=1.0, vres=1.0)
    return cfg, init_spvcnn(cfg, torch.Generator().manual_seed(0))


# --- the oracles of tests/test_spvcnn.py ------------------------------------


def test_sparse_match_vs_dict():
    table, tmask, query, qmask = _match_case()
    got = sparse_match(t(table), t(tmask), t(query), t(qmask)).numpy()
    lut = {tuple(c): i for i, c in enumerate(table) if tmask[i]}
    want = np.array([lut.get(tuple(q), -1) if qmask[i] else -1 for i, q in enumerate(query)])
    np.testing.assert_array_equal(got, want)


def test_sparse_unique_vs_numpy():
    coords, mask = _unique_case()
    uc, um, inv, counts = (a.numpy() for a in sparse_unique(t(coords), t(mask)))
    ref_unique, ref_counts = np.unique(coords[mask], axis=0, return_counts=True)
    n = ref_unique.shape[0]
    assert um.sum() == n and um[:n].all()
    assert {tuple(c): k for c, k in zip(uc[:n], counts[:n])} == {
        tuple(c): k for c, k in zip(ref_unique, ref_counts)}
    # unique coords come first, in (b, z, y, x) order
    order = np.lexsort((uc[:n, 0], uc[:n, 1], uc[:n, 2], uc[:n, 3]))
    np.testing.assert_array_equal(order, np.arange(n))
    for i in range(80):
        if mask[i]:
            assert tuple(uc[inv[i]]) == tuple(coords[i])
        else:
            assert inv[i] == -1


def test_sparse_conv_stride1_matches_dense_conv3d():
    rng = np.random.RandomState(2)
    d, cin, cout, ks = 5, 3, 4, 3
    coords, feats, dense = _dense_block(rng, d, cin, batches=2)
    w = rng.randn(ks ** 3, cin, cout).astype(np.float32)
    y = sparse_conv3d(_voxels(coords, feats), t(w), ks=ks, stride=1)
    # absent neighbours are zero features: zero padding on a full block
    want = F.conv3d(t(dense).permute(0, 4, 1, 2, 3), _dense_weight(w, ks), padding=ks // 2)
    want = want.permute(0, 2, 3, 4, 1).numpy()
    c = y.coords.numpy()
    np.testing.assert_allclose(y.feats.numpy(), want[c[:, 3], c[:, 0], c[:, 1], c[:, 2]],
                               rtol=CONV_TOL, atol=CONV_TOL)


def test_sparse_conv_stride2_matches_dense_conv3d():
    rng = np.random.RandomState(3)
    d, cin, cout = 4, 2, 3
    coords, feats, dense = _dense_block(rng, d, cin)
    w = rng.randn(8, cin, cout).astype(np.float32)
    y = sparse_conv3d(_voxels(coords, feats), t(w), ks=2, stride=2)
    assert y.stride == 2
    m = y.mask.numpy()
    c = y.coords.numpy()[m]
    # the output sites are the unique floor(c / 2) * 2: the 2³ even corners
    assert sorted(map(tuple, c)) == sorted((2 * i, 2 * j, 2 * k, 0) for i in range(d // 2)
                                           for j in range(d // 2) for k in range(d // 2))
    want = F.conv3d(t(dense).permute(0, 4, 1, 2, 3), _dense_weight(w, 2), stride=2)
    want = want.permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(y.feats.numpy()[m], want[c[:, 3], c[:, 0] // 2, c[:, 1] // 2,
                                                        c[:, 2] // 2], rtol=CONV_TOL, atol=CONV_TOL)
    assert (y.feats.numpy()[~m] == 0).all()


def test_voxel_to_point_trilinear_oracle():
    rng = np.random.RandomState(4)
    d, c = 4, 3
    coords, feats, dense = _dense_block(rng, d, c)
    npts = 16
    pts = rng.rand(npts, 3).astype(np.float32) * (d - 1)
    fc = np.concatenate([pts, np.zeros((npts, 1), np.float32)], 1)
    z = SparsePoints(torch.zeros(npts, c), t(fc), torch.ones(npts, dtype=torch.bool))
    out = voxel_to_point(_voxels(coords, feats), z).feats.numpy()
    for i in range(npts):
        base = np.floor(pts[i]).astype(int)
        frac = pts[i] - base
        want = np.zeros(c)
        for o in np.ndindex(2, 2, 2):
            cc = base + o
            if np.all(cc < d):
                w = np.prod([f if k else 1 - f for f, k in zip(frac, o)])
                want += w * dense[0, cc[0], cc[1], cc[2]]
        np.testing.assert_allclose(out[i], want, rtol=1e-5, atol=1e-5)


def test_initial_voxelize_means_points():
    feats = torch.tensor([[1.0, 0.0], [3.0, 0.0], [0.0, 8.0]])
    fc = torch.tensor([[0.2, 0.3, 0.4, 0.0], [0.6, 0.7, 0.9, 0.0], [2.5, 0.1, 0.1, 0.0]])
    x, z2 = initial_voxelize(SparsePoints(feats, fc, torch.ones(3, dtype=torch.bool)), 1.0, 1.0)
    vm = x.mask.numpy()
    assert vm.sum() == 2
    got = {tuple(c[:3]): tuple(f) for c, f, m in zip(x.coords.numpy(), x.feats.numpy(), vm) if m}
    np.testing.assert_allclose(got[(0, 0, 0)], (2.0, 0.0))
    np.testing.assert_allclose(got[(2, 0, 0)], (0.0, 8.0))
    # round trip: point_to_voxel puts the same means back
    np.testing.assert_allclose(point_to_voxel(x, z2).feats.numpy(), x.feats.numpy(), atol=1e-6)


def test_initial_voxelize_pres_vres_rescale():
    feats = torch.tensor([[1.0], [2.0]])
    fc = torch.tensor([[3.0, 1.0, 5.0, 0.0], [3.2, 1.2, 5.2, 0.0]])
    x, z2 = initial_voxelize(SparsePoints(feats, fc, torch.ones(2, dtype=torch.bool)), 0.5, 1.0)
    np.testing.assert_allclose(z2.fcoords.numpy()[:, :3], fc.numpy()[:, :3] * 0.5, rtol=1e-6)
    assert {tuple(c[:3]) for c, m in zip(x.coords.numpy(), x.mask.numpy()) if m} == {(1, 0, 2)}
    np.testing.assert_allclose(x.feats.numpy()[x.mask.numpy()], [[1.5]], rtol=1e-6)


def test_deconv_upsamples_onto_finer_sites():
    rng = np.random.RandomState(5)
    coords, feats, _ = _dense_block(rng, 4, 2)
    x = _voxels(coords, feats)
    y = sparse_conv3d(x, t(rng.randn(8, 2, 3).astype(np.float32)), ks=2, stride=2)
    w_up = rng.randn(8, 3, 2).astype(np.float32)
    up = sparse_conv3d_transpose(y, t(w_up), out_sites=x, ks=2)
    assert up.stride == 1
    np.testing.assert_array_equal(up.coords.numpy(), coords)
    # every fine site c receives its parent floor(c / 2) * 2 through o = c - parent
    yc = {tuple(c): f for c, f, m in zip(y.coords.numpy(), y.feats.numpy(), y.mask.numpy()) if m}
    offs = [tuple(o) for o in _kernel_offsets(2, 1)]
    for i, c in enumerate(coords):
        parent = (c[0] // 2 * 2, c[1] // 2 * 2, c[2] // 2 * 2, c[3])
        k = offs.index((c[0] - parent[0], c[1] - parent[1], c[2] - parent[2]))
        np.testing.assert_allclose(up.feats.numpy()[i], yc[parent] @ w_up[k], rtol=CONV_TOL,
                                   atol=CONV_TOL)


def test_classifier_forward_finite_and_padding_invariant(tiny_net):
    cfg, model = tiny_net
    feats, fc, mask = _toy_points(np.random.RandomState(6), 40, cap=48)
    with torch.no_grad():
        out1 = model(_points(feats, fc, mask)).numpy()
        assert out1.shape == (1, 1) and np.isfinite(out1).all()
        pad = np.zeros((16,), bool)
        out2 = model(_points(np.concatenate([feats, np.zeros((16, 3), np.float32)]),
                             np.concatenate([fc, np.zeros((16, 4), np.float32)]),
                             np.concatenate([mask, pad]))).numpy()
    np.testing.assert_allclose(out2, out1, rtol=1e-4, atol=1e-5)


def test_classifier_permutation_invariant(tiny_net):
    cfg, model = tiny_net
    rng = np.random.RandomState(7)
    feats, fc, mask = _toy_points(rng, 40, 40)
    perm = rng.permutation(40)
    with torch.no_grad():
        out = model(_points(feats, fc, mask)).numpy()
        outp = model(_points(feats[perm], fc[perm], mask[perm])).numpy()
    np.testing.assert_allclose(outp, out, rtol=1e-4, atol=1e-5)


def test_classifier_batched(tiny_net):
    cfg, model = tiny_net
    feats, fc, mask = _toy_points(np.random.RandomState(8), 60, cap=64, batches=2)
    with torch.no_grad():
        out = model(_points(feats, fc, mask), num_batches=2).numpy()
    assert out.shape == (2, 1) and np.isfinite(out).all()


def test_masked_bn_and_gap_ignore_padding():
    f = np.random.RandomState(9).randn(10, 4).astype(np.float32)
    m = np.arange(10) < 7
    y = batch_norm_masked(t(f), t(m), torch.ones(4), torch.zeros(4)).numpy()
    np.testing.assert_allclose(y[:7].mean(0), 0, atol=1e-5)
    np.testing.assert_allclose(y[:7].std(0), 1, atol=1e-3)
    np.testing.assert_array_equal(y[7:], 0)
    x = SparseVoxels(t(f), torch.zeros(10, 4, dtype=torch.int32), t(m), 1)
    np.testing.assert_allclose(global_avg_pool(x, 1).numpy()[0], f[:7].mean(0), rtol=1e-5,
                               atol=1e-6)


def test_depth_pcd_inputs_and_refinement(tiny_net, monkeypatch):
    cfg, model = tiny_net
    rng = np.random.RandomState(10)
    H, W = 12, 16
    depth = rng.rand(H, W).astype(np.float32) + 0.5
    depth[0, :] = 0.0  # an invalid band
    u_u0, v_v0 = init_image_coor(H, W)
    pcd, valid = depth_to_pcd(depth.copy(), u_u0, v_v0, f=20.0)
    assert valid.sum() == (H - 1) * W
    pts = pcd_to_sparsetensor(pcd, valid, voxel_size=0.25, num_points=64)
    assert pts.feats.shape == (64, 3)
    ptsuv = pcd_uv_to_sparsetensor(pcd, u_u0, v_v0, valid, f=20.0, voxel_size=0.25,
                                   num_points=64)
    assert ptsuv.feats.shape == (64, 5)
    model5 = init_spvcnn(SPVCNNConfig(input_channel=5, num_classes=1, cr=0.25),
                         torch.Generator().manual_seed(1))
    # the input functions' capacity cut for speed
    uv, xyz = sp.pcd_uv_to_sparsetensor, sp.pcd_to_sparsetensor
    monkeypatch.setattr(sp, "pcd_uv_to_sparsetensor", lambda *a, **k: uv(*a, **{**k, "num_points": 64}))
    monkeypatch.setattr(sp, "pcd_to_sparsetensor", lambda *a, **k: xyz(*a, **{**k, "num_points": 64}))
    with torch.no_grad():
        focal, scale = refine_focal(depth, 20.0, model5, u0=W / 2, v0=H / 2)
        assert np.isfinite(focal) and focal == pytest.approx(20.0 / scale)
        shift = refine_shift(depth, model, 20.0, u0=W / 2, v0=H / 2)
    assert np.isfinite(shift) and shift <= 0.7
    assert depth[0, 0] == 0.0 and (depth[1:] > 0).all()  # the input functions copy the depth


# --- parity with live scade_tpu ---------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """scade_tpu's results on the inputs of the parity tests below."""
    table, tmask, query, qmask = _match_case()
    coords, mask = _unique_case()
    rng = np.random.RandomState(12)
    c, f, _ = _dense_block(rng, 4, 3, batches=2)
    keep = rng.rand(c.shape[0]) > 0.3  # a sparse, masked block
    w3 = rng.randn(27, 3, 5).astype(np.float32)
    w2 = rng.randn(8, 3, 5).astype(np.float32)
    jx = jsp.SparseVoxels(jnp.asarray(f), jnp.asarray(c), jnp.asarray(keep), 1)
    cfg = jsp.SPVCNNConfig(input_channel=3, num_classes=1, cr=0.25)
    # jitted: the same draws as eager, in half the time on the CPU
    params = jax.jit(jsp.init_spvcnn, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    feats, fc, pmask = _toy_points(np.random.RandomState(13), 40, cap=48)
    logits = jsp.spvcnn_apply(params, cfg, jsp.SparsePoints(
        jnp.asarray(feats), jnp.asarray(fc), jnp.asarray(pmask)))
    np_tree = jax.tree.map(np.asarray, params)
    return dict(
        match=(table, tmask, query, qmask, np.asarray(jsp.sparse_match(
            jnp.asarray(table), jnp.asarray(tmask), jnp.asarray(query), jnp.asarray(qmask)))),
        unique=(coords, mask, [np.asarray(a) for a in jsp.sparse_unique(
            jnp.asarray(coords), jnp.asarray(mask))]),
        conv=(c, f, keep, w3, w2,
              [np.asarray(jsp.sparse_conv3d(jx, jnp.asarray(w3), ks=3).feats),
               *map(np.asarray, jsp.sparse_conv3d(jx, jnp.asarray(w2), ks=2, stride=2)[:3])]),
        net=(cfg, np_tree, (feats, fc, pmask), np.asarray(logits)))


def test_sparse_match_and_unique_equal_jax(jax_side):
    table, tmask, query, qmask, want = jax_side["match"]
    np.testing.assert_array_equal(sparse_match(t(table), t(tmask), t(query), t(qmask)).numpy(),
                                  want)
    coords, mask, want = jax_side["unique"]
    for got, ref in zip(sparse_unique(t(coords), t(mask)), want):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_sparse_conv_equals_jax(jax_side):
    c, f, keep, w3, w2, (f3, f2, c2, m2) = jax_side["conv"]
    x = SparseVoxels(t(f), t(c), t(keep), 1)
    np.testing.assert_allclose(sparse_conv3d(x, t(w3), ks=3).feats.numpy(), f3, rtol=CONV_TOL,
                               atol=CONV_TOL)
    y = sparse_conv3d(x, t(w2), ks=2, stride=2)
    np.testing.assert_array_equal(y.coords.numpy(), c2)
    np.testing.assert_array_equal(y.mask.numpy(), m2)
    np.testing.assert_allclose(y.feats.numpy(), f2, rtol=CONV_TOL, atol=CONV_TOL)


def test_classifier_equals_jax_on_converted_weights(jax_side):
    cfg, np_tree, (feats, fc, mask), want = jax_side["net"]
    model = sp.SPVCNN(SPVCNNConfig(input_channel=cfg.input_channel, num_classes=cfg.num_classes,
                                   cr=cfg.cr, pres=cfg.pres, vres=cfg.vres))
    model.load_state_dict(spvcnn_params_to_state_dict(np_tree), strict=True)
    with torch.no_grad():
        got = model.eval()(_points(feats, fc, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
