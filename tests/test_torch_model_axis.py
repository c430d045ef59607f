"""The mesh's model axis in the port (``parallel/mesh.py``, ``dist.make_grid``):
a NeRF train step tensor-parallel over a data x model grid of gloo ranks on
the CPU, against 1 process and against ``scade_tpu``.

Small config of tests/test_train_step.py's mesh tests (multires 4, 8+16
samples, N_rand 32, 2 steps), at netwidth 256, the smallest width at which
``views_linears.0`` (W/2 out) shards too. One launch of subprocesses per grid
(1x2 and 2x2), each rank training with K1's wrapper (its plain version on
the CPU, on gathered weights) and with the column-parallel plain path.

Tolerances:
- the losses against 1 process: rtol 2e-5 / atol 2e-6, the bound of the JAX
  package's own tensor-parallel test (test_device_count_equivalence);
- the first step's grads, gathered: 1e-5 of each tensor's largest entry
  (the ranks sum in other orders);
- the second step's grads: 1e-3 of each tensor's largest entry. The first
  step's params differ by what Adam makes of those reordered sums (up to
  3.5e-6), and the fine model's samples, drawn from the coarse weights,
  move with them: up to 7.9e-4 was measured (the plain path);
- the gathered params after 2 steps: every entry within 1e-5 of 1
  process's plus what Adam (replayed in f64 from the same init) makes of
  the difference of the two runs' applied grads. Adam divides by the root
  of the second moment, so a small grad's difference moves its param by up
  to lr: without the replay 0 (K1, 1x2), 26 (K1, 2x2) and 8 (plain, either
  grid) of the 1.15M entries are beyond 1e-5, by up to 1.9e-4; with it the
  largest distance is 3e-8;
- the replicated tensors of a data row's ranks: bit-equal;
- a view rendered over the grid: 1e-5 of 1 process's maps;
- one 1x2 step against scade_tpu on the fixed batch and shared u of
  tests/test_torch_train_step.py, and the port's 1-process step likewise:
  the loss 1e-5 relative; the grads 1e-4 of each tensor's largest entry of
  JAX's, once the terms of the points in FLIPS are taken out (and the 1x2
  step's grads 1e-5 of that largest from the 1-process step's). At three
  hidden units a ReLU sits at its threshold at one sample point, and the two
  frameworks' sample positions (5e-6 apart) fall on either side: that one
  point's term of the grads differs, by up to 9.3e-3 of the largest entry
  (fine pts_linears.1). Each such term is checked to be one point's, at
  its unit's threshold, before it is taken out.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.models.nerf import nerf_init
from scade_tpu.parallel import mesh as jmesh
from scade_tpu.render import renderer as jrenderer
from scade_tpu.train import step as jstep
from scade_tpu_torch import convert
from scade_tpu_torch.models.nerf import NeRF
from scade_tpu_torch.ops.embedding import get_embedder
from scade_tpu_torch.parallel import mesh
from scade_tpu_torch.parallel.dist import Ranks
from scade_tpu_torch.render.renderer import make_render_config
from scade_tpu_torch.train import step
from test_torch_train_step import (
    H,
    N_REL,
    N_TRAIN,
    W,
    as_state_dict,
    jax_scene,
    make_jax_step,
    smooth_density,
    tiny_scene_np,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL = 2e-5, 2e-6
PARAM_TOL = 1e-5
GRAD_REL, STEP2_GRAD_REL = 1e-5, 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
RENDER_TOL = 1e-5
JAX_LOSS_RTOL, JAX_GRAD_REL = 1e-5, 1e-4
GRIDS = {"1x2": (2, 2), "2x2": (4, 2)}  # name: (world, n_model)
# The hidden units whose ReLU sits at its threshold at one sample point of
# the JAX case's batch, as (layer, unit) from the top down: coarse unit 217
# of layer 0, fine unit 174 of layer 1 and fine unit 152 of layer 0, each at
# another point.
FLIPS = {"coarse": [(0, 217)], "fine": [(1, 174), (0, 152)]}
# |pre-activation| at such a point over sum |w_i x_i| + |b|: measured 5e-8
# to 1.9e-4 (the point's input is estimated from the grads' differences,
# which carry the other points' roundoff)
AT_THRESHOLD = 1e-3
# such a point's input to layer 0, against the positional encoding of its
# first 3 entries (the point), over its largest entry: measured 1e-3 to 8e-3
ENCODED = 2e-2


# What the test process and each rank both run: a string, so that the ranks
# import neither JAX nor this module (and its JAX imports).
HELPERS = """
import numpy as np
import torch
from scade_tpu_torch.parallel import mesh
from scade_tpu_torch.render.renderer import SceneVars, make_render_config, render_image
from scade_tpu_torch.train import step

H = W = 16
N_TRAIN, N_REL = 2, 3
SMALL = dict(multires=4, netwidth=256, netwidth_fine=256, n_samples=8, n_importance=16)
N_RAND, STEPS = 32, 2
PATHS = {"fused": True, "plain": False}


def render_cfg(fused):
    return make_render_config(**SMALL, use_fused=fused, device="cpu")


def port_scene(d):
    return step.SceneTensors(**{k: torch.as_tensor(np.array(v)) for k, v in d.items()})


def whole_state(state):
    '''The state's NeRF params, whole, by ``coarse.``/``fine.`` name.'''
    return {f"{w}.{k}": v for w, m in (("coarse", state.model_coarse), ("fine", state.model_fine))
            for k, v in mesh.gather_params(m).items()}


def render_view(state, rc, scene, ranks=None):
    sv = SceneVars(state.model_coarse, state.model_fine, scene.bb_center, scene.bb_scale,
                   torch.zeros(0))
    out = render_image(sv, rc, H, W, scene.intrinsics[N_TRAIN], scene.poses[N_TRAIN],
                       float(scene.near), float(scene.far), chunk=64,
                       outputs=("rgb_map", "depth_map"), ranks=ranks)
    return {k: v.detach().clone() for k, v in out.items()}


def train(state, rc, scene, ranks=None):
    '''STEPS steps of make_train_step, generator reseeded each step: the
    losses, and each step's grads as applied (whole, in nerf_params order,
    then scales and shifts).'''
    fn = step.make_train_step(rc, step.TrainConfig(n_rand=N_RAND), H, W, N_TRAIN, ranks=ranks)
    grads, apply = [], step.apply_grads

    def spy(state, g, g_scales, g_shifts, *args, **kwargs):
        whole = mesh.gather_nerf(state, g) + [g_scales, g_shifts]
        wrt = state.nerf_params() + [state.scales, state.shifts]
        grads.append([torch.zeros_like(p) if t is None else t.detach().clone()
                      for t, p in zip(whole, wrt)])
        return apply(state, g, g_scales, g_shifts, *args, **kwargs)

    step.apply_grads = spy
    try:
        losses = [float(fn(state, scene, torch.Generator().manual_seed(100 + i))["loss"])
                  for i in range(STEPS)]
    finally:
        step.apply_grads = apply
    return losses, grads


def port_state_from(case, rc, ranks=None):
    '''A state with the JAX init's weights, scales and shifts (sharded over
    ``ranks``).'''
    state = step.create_train_state(0, rc, step.TrainConfig(n_rand=N_RAND), N_REL)
    state.model_coarse.load_state_dict(case["coarse"], strict=True)
    state.model_fine.load_state_dict(case["fine"], strict=True)
    with torch.no_grad():
        state.scales.copy_(case["scales"])
        state.shifts.copy_(case["shifts"])
    if ranks is not None:
        mesh.shard_state(state, ranks)
    return state


def jax_case_grads(case, rc, ranks=None):
    '''(loss, whole grads by name) of one compute_grads on the case's batch.'''
    state = port_state_from(case, rc, ranks)
    batch = step.RayBatch(*case["batch"])
    grads, g_scales, g_shifts, metrics = step.compute_grads(
        state, port_scene(case["scene"]), batch, rc, step.TrainConfig(n_rand=N_RAND),
        cached_u=case["u"], ranks=ranks)
    whole = mesh.gather_nerf(state, grads)
    names = [f"{w}.{n}" for w in ("coarse", "fine")
             for n, _ in state.model_coarse.named_parameters()]
    out = dict(zip(names, whole))
    out["scales"], out["shifts"] = g_scales, g_shifts
    return float(metrics["loss"]), {k: v.detach().clone() for k, v in out.items()}
"""

_ns: dict = {}
exec(HELPERS, _ns)
SMALL, N_RAND, PATHS, render_cfg, port_scene, whole_state, render_view, train = (
    _ns[k] for k in ("SMALL", "N_RAND", "PATHS", "render_cfg", "port_scene", "whole_state",
                     "render_view", "train"))


# One rank of a grid: trains along both paths, renders a view, and (on a 1x2
# grid) takes the JAX case's step; saves what it saw.
WORKER = """
import os, sys, torch
torch.set_num_threads(1)
import torch.distributed as tdist
case_path, out, port, world, n_model = sys.argv[1], sys.argv[2], sys.argv[3], *map(int, sys.argv[4:6])
rank = int(os.environ["RANK"])
tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
from scade_tpu_torch.parallel import dist
grid = dist.make_grid(n_model)
case = torch.load(case_path)
scene = port_scene(case["scene"])
rec = dict(rank=rank, data_index=grid.data_index, model_index=grid.model_index)
for name, fused in PATHS.items():
    rc = render_cfg(fused)
    state = step.create_train_state(0, rc, step.TrainConfig(n_rand=N_RAND), N_REL, grid=grid)
    local = {f"{w}.{k}": tuple(v.shape) for w, m in (("coarse", state.model_coarse),
             ("fine", state.model_fine)) for k, v in m.state_dict().items()}
    moments = [tuple(m.shape) for m in state.opt.mu + state.opt.nu]
    render = render_view(state, rc, scene, grid) if fused else None
    losses, grads = train(state, rc, scene, grid)
    dims = mesh.nerf_dims(state)
    replicated = [p.detach().clone() for p, d in zip(state.nerf_params(), dims) if d is None]
    replicated += [m.clone() for m, d in zip(state.opt.mu + state.opt.nu, dims + dims) if d is None]
    replicated += [state.scales.detach().clone(), state.shifts.detach().clone(),
                   *state.ss_opt.mu, *state.ss_opt.nu]
    rec[name] = dict(losses=losses, grads=grads, params=whole_state(state), local=local,
                     moments=moments,
                     replicated=replicated, render=render)
    if "jax" in case:
        rec[name]["jax_step"] = jax_case_grads(case["jax"], rc, grid)
torch.save(rec, os.path.join(out, f"rank{rank}.pt"))
tdist.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX init (its density head shrunk), a fixed batch and shared u,
    and scade_tpu's loss and grads of one step on them."""
    tc = jstep.TrainConfig(n_rand=N_RAND)
    jrc = jrenderer.make_render_config(**SMALL)
    d = tiny_scene_np()
    jscene = jax_scene(d)
    jstate = smooth_density(jstep.create_train_state(jax.random.PRNGKey(0), jrc, tc,
                                                     n_images=N_REL))
    jbatch = jstep.sample_ray_batch(jax.random.PRNGKey(10), jscene, H, W, N_TRAIN, tc)
    u = np.random.default_rng(7).uniform(size=(N_RAND, 16)).astype(np.float32)
    _, jloss, jgrads = make_jax_step(jrc, tc, jscene)(jstate, jbatch, jnp.asarray(u))
    grads = {f"{w}.{k}": v for w in ("coarse", "fine")
             for k, v in as_state_dict(jgrads["params"][w]).items()}
    grads["scales"], grads["shifts"] = np.asarray(jgrads["scales"]), np.asarray(jgrads["shifts"])
    case = dict(
        scene={k: torch.as_tensor(np.array(v)) for k, v in d.items()},
        coarse={k: torch.from_numpy(v) for k, v in as_state_dict(jstate.params["coarse"]).items()},
        fine={k: torch.from_numpy(v) for k, v in as_state_dict(jstate.params["fine"]).items()},
        scales=torch.from_numpy(np.array(jstate.scales)),
        shifts=torch.from_numpy(np.array(jstate.shifts)),
        batch=[None if x is None else torch.from_numpy(np.array(x)) for x in jbatch],
        u=torch.from_numpy(u))
    one = {name: _ns["jax_case_grads"](case, render_cfg(fused)) for name, fused in PATHS.items()}
    return case, float(jloss), grads, one


@pytest.fixture(scope="module")
def one_process():
    """What 1 process trains and renders, along both paths."""
    scene = port_scene(tiny_scene_np())
    out = {}
    for name, fused in PATHS.items():
        rc = render_cfg(fused)
        state = step.create_train_state(0, rc, step.TrainConfig(n_rand=N_RAND), N_REL)
        render = render_view(state, rc, scene)
        losses, grads = train(state, rc, scene)
        out[name] = dict(losses=losses, grads=grads, params=whole_state(state), render=render)
    return out


def launch(tmp, grid, case):
    world, n_model = GRIDS[grid]
    out = tmp / grid
    out.mkdir()
    torch.save(case, out / "case.pt")
    worker = out / "worker.py"
    worker.write_text(HELPERS + WORKER)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(out / "case.pt"), str(out), str(port), str(world), str(n_model)],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks_1x2(tmp_path_factory, jax_case):
    case = dict(scene=jax_case[0]["scene"], jax=jax_case[0])
    return launch(tmp_path_factory.mktemp("tp"), "1x2", case)


@pytest.fixture(scope="module")
def ranks_2x2(tmp_path_factory):
    scene = {k: torch.as_tensor(np.array(v)) for k, v in tiny_scene_np().items()}
    return launch(tmp_path_factory.mktemp("tp"), "2x2", dict(scene=scene))


@pytest.fixture(params=list(GRIDS))
def grid_ranks(request):
    return request.param, request.getfixturevalue(f"ranks_{request.param}")


def jax_sharded_names(width):
    """The state_dict names of the tensors scade_tpu's nerf_param_pspecs
    shards over the model axis: each leaf replaced by ones where sharded and
    zeros where not, mapped through convert.params_to_state_dict."""
    jrc = jrenderer.make_render_config(multires=4, netwidth=width, netwidth_fine=width)
    params = nerf_init(jax.random.PRNGKey(0), jrc.nerf_coarse)
    specs = jmesh.nerf_param_pspecs(params)
    flags = jax.tree.map(lambda x, s: np.full(x.shape, float(s != jax.sharding.PartitionSpec()),
                                              np.float32), params, specs,
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    sd = convert.params_to_state_dict(flags)
    return {k for k, v in sd.items() if bool(v.all())}, set(sd)


@pytest.mark.parametrize("width", [64, 256, 512])
def test_sharded_set_matches_jax(width):
    want, names = jax_sharded_names(width)
    model = NeRF(make_render_config(multires=4, netwidth=width, device="cpu").nerf_coarse)
    specs = mesh.nerf_param_specs(model)
    assert set(specs) == names
    assert {k for k, d in specs.items() if d is not None} == want
    if width == 64:
        assert want == set()
    else:
        assert "views_linears.0.weight" in want and "alpha_linear.weight" not in want


def test_state_shardings_by_path_not_shape():
    """A (4, 256) leaf in place of scales replicates, while the hidden
    weights, their biases and their Adam moments (by position) shard."""
    rc = render_cfg(True)
    state = step.create_train_state(0, rc, step.TrainConfig(n_rand=N_RAND), N_REL)
    state.scales = torch.zeros(4, 256)
    specs = mesh.state_shardings(state, Ranks(0, 2, 2), shard_model=True)
    assert specs["scales"] is None and specs["shifts"] is None
    assert all(v is None for k, v in specs.items() if k.startswith("ss_opt."))
    assert specs["model_coarse.pts_linears.0.weight"] == 0
    assert specs["model_fine.feature_linear.bias"] == 0
    assert specs["model_coarse.alpha_linear.weight"] is None
    params = [n for n, _ in state.model_coarse.named_parameters()]
    i = params.index("pts_linears.3.weight")
    assert specs[f"opt.mu.{i}"] == specs[f"opt.nu.{i}"] == 0
    j = len(params) + params.index("rgb_linear.bias")
    assert specs[f"opt.mu.{j}"] is None
    assert all(v is None for v in mesh.state_shardings(state, Ranks(0, 2, 2)).values())


def test_grid_places_ranks():
    """Rank r sits at data row r // n_model and model column r % n_model, as
    make_mesh reshapes the devices; a data row's ranks share a block of rays."""
    assert [(Ranks(r, 4, 2).data_index, Ranks(r, 4, 2).model_index) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert Ranks(1, 4, 2).block(32) == slice(0, 16) == Ranks(0, 4, 2).block(32)
    assert Ranks(3, 4, 2).block(32) == slice(16, 32)
    assert Ranks(1, 2, 2).block(32) == slice(0, 32)
    assert Ranks(3, 4).block(32) == slice(24, 32) and Ranks(3, 4).n_data == 4
    with pytest.raises(ValueError, match="evenly"):
        Ranks(0, 4, 2).block(31)


def adam_replay(grads, tc):
    """Each param's summed updates over the steps of ``grads`` (per step, a
    list in nerf_params order), by Adam in f64."""
    out = []
    for per_step in zip(*grads):
        m = v = x = 0.0
        for t, g in enumerate(per_step, 1):
            g = g.double()
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            x = x - step.staircase_lr(tc, t - 1) * (m / (1 - B1**t)) / (
                torch.sqrt(v / (1 - B2**t)) + EPS)
        out.append(x)
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_grid_trains_as_one_process(grid_ranks, one_process, path):
    grid, ranks = grid_ranks
    world, n_model = GRIDS[grid]
    one = one_process[path]
    names = list(one["params"])
    tc = step.TrainConfig(n_rand=N_RAND)
    one_replay = adam_replay([g[:len(names)] for g in one["grads"]], tc)
    for rec in ranks:
        mine = rec[path]
        np.testing.assert_allclose(mine["losses"], one["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for i, rel in ((0, GRAD_REL), (1, STEP2_GRAD_REL)):
            for a, b, name in zip(mine["grads"][i], one["grads"][i], names + ["scales", "shifts"]):
                err = (a - b).abs().max().item()
                assert err <= rel * b.abs().max().item(), (grid, rec["rank"], i, name, err)
        replay = adam_replay([g[:len(names)] for g in mine["grads"]], tc)
        for name, r, o in zip(names, replay, one_replay):
            err = ((mine["params"][name] - one["params"][name]).double() - (r - o)).abs().max()
            assert err.item() <= PARAM_TOL, (grid, rec["rank"], name, err.item())
    for a in ranks:  # a data row's ranks hold bit-equal replicated tensors
        for b in ranks:
            if a["data_index"] == b["data_index"]:
                assert all(torch.equal(x, y) for x, y in
                           zip(a[path]["replicated"], b[path]["replicated"]))
    # every rank holds 1/n_model of each sharded weight, bias and moment
    for rec in ranks:
        for k, v in one["params"].items():
            shard = k.split(".", 1)[1].rsplit(".", 1)[0] not in ("alpha_linear", "rgb_linear")
            want = (v.shape[0] // n_model, *v.shape[1:]) if shard else tuple(v.shape)
            assert rec[path]["local"][k] == want, k
        assert [m[0] for m in rec[path]["moments"]] == [
            rec[path]["local"][k][0] for k in one["params"]] * 2


def test_grid_renders_as_one_process(grid_ranks, one_process):
    """render_image(ranks=grid): a data row per block of rays, each row's
    ranks column-parallel through K1's wrapper."""
    _, ranks = grid_ranks
    for rec in ranks:
        for k, v in one_process["fused"]["render"].items():
            assert (rec["fused"]["render"][k] - v).abs().max().item() <= RENDER_TOL, k


def assert_grads_match_jax(grads, jgrads, weights, who):
    """Every grad within JAX_GRAD_REL of its tensor's largest entry of JAX's,
    once the terms of the FLIPS points are taken out, top down. A flipped
    unit's row of its layer's grads is one point's term, delta x input: the
    unit's pre-activation at that input must be at its threshold. Below it,
    that point's term is relu'(z) * (the unit's weights * delta) x the
    layer's input, one outer product: its input is fitted from the rows, and
    must give, through the layer, the input of the layer above. An input to
    layer 0 must be a point's positional encoding."""
    embed = get_embedder(SMALL["multires"])

    def point(x, *where):
        if where[1] == 0:
            err = np.abs(embed(torch.from_numpy(x[:3])).numpy() - x).max()
            assert err <= ENCODED * np.abs(x).max(), (who, *where, err)
        return x

    diff = {k: grads[k].double().numpy() - np.asarray(jgrads[k], np.float64) for k in jgrads}
    for model, flips in FLIPS.items():
        wts = {k: v.double().numpy() for k, v in weights[model].items()}
        carry = None  # the point's delta into this layer's output and that output
        for layer in range(flips[0][0], -1, -1):
            dw = diff[f"{model}.pts_linears.{layer}.weight"]
            db = diff[f"{model}.pts_linears.{layer}.bias"]
            w, b = wts[f"pts_linears.{layer}.weight"], wts[f"pts_linears.{layer}.bias"]
            units = [u for l, u in flips if l == layer]
            rest = np.setdiff1d(np.arange(len(db)), units)
            if carry is not None:
                delta, out = carry
                on = np.where(np.abs(db - delta) < np.abs(db), delta, 0.0)[rest]
                x = point(dw[rest].T @ on / (on @ on), model, layer)
                z = w @ x + b
                assert np.abs(np.maximum(z, 0) - out).max() <= AT_THRESHOLD * np.abs(out).max(), (
                    who, model, layer)
                term = np.where(z > 0, delta, 0.0)
                dw -= np.outer(term, x)
                db -= term
            carry = None
            for u in units:
                x = point(dw[u] / db[u], model, layer, u)
                z = w[u] @ x + b[u]
                assert abs(z) <= AT_THRESHOLD * (np.abs(w[u]) @ np.abs(x) + abs(b[u])), (
                    who, model, layer, u, z)
                carry = (db[u] * w[u], x)
                dw[u], db[u] = 0.0, 0.0
    for name, ref in jgrads.items():
        err = np.abs(diff[name]).max()
        assert err <= JAX_GRAD_REL * np.abs(ref).max(), (who, name, err)


@pytest.mark.parametrize("path", list(PATHS))
def test_one_step_matches_jax(ranks_1x2, jax_case, path):
    case, jloss, jgrads, one = jax_case
    one_loss, one_grads = one[path]
    np.testing.assert_allclose(one_loss, jloss, rtol=JAX_LOSS_RTOL)
    assert set(one_grads) == set(jgrads)
    assert_grads_match_jax(one_grads, jgrads, case, "1 process")
    for rec in ranks_1x2:
        loss, grads = rec[path]["jax_step"]
        np.testing.assert_allclose(loss, jloss, rtol=JAX_LOSS_RTOL)
        assert set(grads) == set(jgrads)
        for name, mine in one_grads.items():
            got = grads[name]
            assert (got - mine).abs().max().item() <= GRAD_REL * mine.abs().max().item(), name
        assert_grads_match_jax(grads, jgrads, case, f"rank {rec['rank']}")
