"""The train step's gathers without a host read, against the 0-d index they
replace.

``sample_ray_batch`` draws the image index as a 0-d tensor on the device. It
used to index the scene with it (``scene.images[img_i, rows, cols]`` and the
like), and ``compute_loss`` the per-image scales and shifts: PyTorch reads a
0-d integer index to the host, so on the card each such index waited for the
device, and the stratified law's tables were copied from numpy on every step,
which waits too. This file keeps those expressions as ``sample_ray_batch_0d``
and ``scaled_hypotheses_0d`` and holds the step's sync-free gathers to them
bit for bit: the batch, the scaled hypotheses, the loss, and every gradient
(scales' and shifts' through ``index_select``'s backward in place of
``select``'s), for each pixel law and with the masks off, the corner mask,
and the wild runner's edge mask on RGB and space carving. The cached
stratum tables equal numpy's. The transmittance's ``cumprod_nonzero`` equals
``torch.cumprod`` in value and gradient: torch's backward asks the host
whether a factor is zero, and none is. tests/test_torch_cuda.py runs three
steps on the card against the same copies and ``torch.cumprod``. No JAX
here.
"""

import numpy as np
import pytest
import torch

from scade_tpu_torch.ops import volume
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.render.renderer import make_render_config
from scade_tpu_torch.train import step

H, W = 48, 64  # the 20 px corners and the 10 px border leave pixels unmasked
N_TRAIN, N_REL, K = 3, 4, 5
SMALL = dict(multires=4, netwidth=64, netwidth_fine=64, n_samples=8, n_importance=16)


@pytest.fixture(autouse=True)
def one_thread():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def sample_ray_batch_0d(generator, scene, H, W, n_train, tc):
    """``step.sample_ray_batch`` as it was: every gather by the 0-d index, and
    the stratum tables made from numpy on every call."""
    dev = scene.images.device
    img_i = torch.randint(0, n_train, (), generator=generator, device=dev)
    if tc.pixel_sampling == "stratified":
        u = torch.rand(tc.n_rand, generator=generator, device=dev)
        b = np.arange(tc.n_rand + 1, dtype=np.int64) * (H * W) // tc.n_rand
        lo = torch.as_tensor(b[:-1], device=dev)
        size = torch.as_tensor((b[1:] - b[:-1]).astype(np.float32), device=dev)
        pix = lo + (u * size).long()
    else:
        pix = step.select_pixels(generator, H, W, tc, device=dev)
    rows = pix // W
    cols = pix % W
    coords = torch.stack([rows, cols], dim=-1).float()
    rays_o, rays_d = get_rays(H, W, scene.intrinsics[img_i], scene.poses[img_i], coords=coords)
    target_s = scene.images[img_i, rows, cols]
    target_h = scene.hyps[img_i][:, rows, cols]
    if tc.mask_corners:
        sc_mask = step._corner_mask(rows, cols, H, W)
    elif tc.mask_edges:
        sc_mask = step._edge_mask(rows, cols, H, W)
    else:
        sc_mask = None
    return step.RayBatch(rays_o, rays_d, target_s, target_h, sc_mask, img_i)


def scaled_hypotheses_0d(state, batch):
    """``compute_loss``'s scaled hypotheses as they were, by the 0-d index."""
    return batch.target_h * state.scales[batch.img_i] + state.shifts[batch.img_i]


def tiny_scene(seed=0):
    rng = np.random.default_rng(seed)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (N_REL, 4, 4)).copy()
    poses[:, :3, 3] = rng.normal(size=(N_REL, 3)) * 0.05
    poses[:, :3, :3] += rng.normal(size=(N_REL, 3, 3)).astype(np.float32) * 0.1
    intr = rng.uniform(7.0, 9.0, size=(N_REL, 4)).astype(np.float32)
    return step.SceneTensors(
        images=torch.from_numpy(rng.uniform(size=(N_REL, H, W, 3)).astype(np.float32)),
        poses=torch.from_numpy(poses),
        intrinsics=torch.from_numpy(intr),
        hyps=torch.from_numpy(rng.uniform(1.0, 5.0, size=(N_TRAIN, K, H, W, 1))
                              .astype(np.float32)),
        near=torch.tensor(0.1), far=torch.tensor(10.0),
        bb_center=torch.zeros(3), bb_scale=torch.tensor(0.5),
    )


MASKS = {"none": {}, "corners": {"mask_corners": True},
         "edges_rgb": {"mask_edges": True, "mask_rgb": True}}


@pytest.mark.parametrize("masks", list(MASKS))
@pytest.mark.parametrize("sampling", ["stratified", "choice", "iid"])
def test_sync_free_batch_and_loss_equal_the_0d_index(sampling, masks, monkeypatch):
    tc = step.TrainConfig(n_rand=40, pixel_sampling=sampling, **MASKS[masks])
    rc = make_render_config(**SMALL, device="cpu")
    scene = tiny_scene()
    state = step.create_train_state(0, rc, tc, N_REL)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # a scale and shift of their own for every image
        state.scales.copy_(1.0 + 0.2 * torch.rand(N_REL, 1, generator=gen))
        state.shifts.copy_(0.1 * torch.randn(N_REL, 1, generator=gen))

    def run(sample, scaled, seed):
        monkeypatch.setattr(step, "_scaled_hypotheses", scaled)
        g = torch.Generator().manual_seed(seed)
        batch = sample(g, scene, H, W, N_TRAIN, tc)
        th = scaled(state, batch)
        grads, g_scales, g_shifts, metrics = step.compute_grads(state, scene, batch, rc, tc,
                                                                generator=g)
        return batch, th, [*grads, g_scales, g_shifts], metrics

    seen = set()
    for seed in range(6):
        old = run(sample_ray_batch_0d, scaled_hypotheses_0d, seed)
        new = run(step.sample_ray_batch, step._scaled_hypotheses, seed)
        seen.add(int(new[0].img_i))
        for name, a, b in zip(step.RayBatch._fields, old[0], new[0]):
            if a is None:
                assert b is None, name
            else:
                assert torch.equal(a, b) and a.stride() == b.stride(), name
        assert (new[0].sc_mask is None) == (masks == "none")
        assert torch.equal(old[1], new[1])
        for i, (a, b) in enumerate(zip(old[2], new[2])):
            assert torch.equal(a, b), i
        assert new[2][-2].count_nonzero() == 1  # the gradient sits in the image's row
        for k in old[3]:
            assert torch.equal(old[3][k], new[3][k]), k
    assert len(seen) > 1


@pytest.mark.parametrize("hw,n_rand", [((16, 16), 32), ((15, 20), 32), ((7, 9), 63),
                                       ((468, 624), 1024)])
def test_cached_strata_equal_numpy(hw, n_rand):
    h, w = hw
    b = np.arange(n_rand + 1, dtype=np.int64) * (h * w) // n_rand
    lo, size = step._strata(h, w, n_rand, torch.device("cpu"))
    assert lo.dtype == torch.int64 and size.dtype == torch.float32
    np.testing.assert_array_equal(lo.numpy(), b[:-1])
    np.testing.assert_array_equal(size.numpy(), (b[1:] - b[:-1]).astype(np.float32))
    assert step._strata(h, w, n_rand, torch.device("cpu"))[0] is lo  # made once


@pytest.mark.parametrize("shape", [(1024, 65), (1024, 193), (7, 3, 9), (4, 2), (5, 1)])
def test_cumprod_nonzero_is_torch_cumprod(shape):
    gen = torch.Generator().manual_seed(2)
    x = 1.0 - torch.rand(shape, generator=gen) + 1e-10  # as compute_weights' factors
    x[..., :1] = 1.0
    x[..., 1::3] = 1e-10  # the floor, where alpha is 1
    g = torch.randn(shape, generator=gen)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_a, out_b = torch.cumprod(a, dim=-1), volume.cumprod_nonzero(b)
    assert torch.equal(out_a, out_b)
    # as compute_weights cuts it, then whole
    ga, = torch.autograd.grad(out_a[..., :-1], a, g[..., :-1], retain_graph=True)
    gb, = torch.autograd.grad(out_b[..., :-1], b, g[..., :-1], retain_graph=True)
    assert torch.equal(ga, gb)
    ga, = torch.autograd.grad(out_a, a, g)
    gb, = torch.autograd.grad(out_b, b, g)
    assert torch.equal(ga, gb)
