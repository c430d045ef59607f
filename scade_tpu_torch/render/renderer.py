"""The SCADE volumetric rendering pipeline.

Per ray batch:
  1. stratified coarse depths (+ optional per-stratum jitter),
  2. coarse MLP → compositing weights,
  3. importance resampling of the coarse weights (detached) → fine depths,
  4. fine MLP on the sorted union of depths → final rgb/depth/weights,
  5. P_depth draws from the fine termination distribution, differentiable:
     SCADE's space-carving loss backprops through them.

The MLP passes go through kernel K1 (``ops/fused_mlp.py``) and the inverse-CDF
lookups through kernel K2 (``ops/fused_sampling.py``) when ``use_fused`` and
``fused_sampling`` are on, which they are by default. This module alone
decides where a kernel runs; ``on_kernels`` tells the train step whether all
of a step does. Randomness comes from
an explicit ``torch.Generator``; ``generator=None`` is the deterministic
(test-time) path.

Under data parallelism (``parallel/dist.py``) a rank renders a block of a
batch: ``render_rays(block=RayBlock(rows, total))`` makes every draw for the
whole batch and keeps the block's rows, so the ranks together draw what one
device would; ``render_image(ranks=...)`` splits an image's rays into
contiguous blocks, one a data row, and reassembles the maps on every rank.
A model whose layers are sharded over a model axis (``parallel/mesh.py``)
gathers what it needs itself, in ``NeRF.forward`` and in K1's wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from scade_tpu_torch.models.nerf import NeRF, NeRFConfig
from scade_tpu_torch.ops.embedding import Embedder, get_embedder, positional_encoding
from scade_tpu_torch.ops.fused_mlp import FusedCfg, fused_nerf_apply, supports_fusion
from scade_tpu_torch.ops.fused_sampling import fused_sample_pdf
from scade_tpu_torch.ops.rays import get_rays
from scade_tpu_torch.ops.sampling import draw_u, draw_u_sorted, merge_sorted, sample_pdf
from scade_tpu_torch.ops.volume import perturb_z_vals, raw2outputs, stratified_z_vals
from scade_tpu_torch.parallel.dist import Ranks


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: bool = True
    raw_noise_std: float = 0.0
    lindisp: bool = False
    is_joint: bool = False
    use_viewdirs: bool = True
    embed_pos: Embedder = dataclasses.field(
        default_factory=lambda: Embedder(num_freqs=9, max_freq_log2=8.0)
    )
    # get_embedder(multires_views=0): identity only, consistent with use_viewdirs
    embed_dirs: Optional[Embedder] = dataclasses.field(
        default_factory=lambda: Embedder(num_freqs=0, max_freq_log2=-1.0)
    )
    nerf_coarse: NeRFConfig = dataclasses.field(
        default_factory=lambda: NeRFConfig(input_ch=57, input_ch_views=3, output_ch=5)
    )
    nerf_fine: Optional[NeRFConfig] = dataclasses.field(
        default_factory=lambda: NeRFConfig(input_ch=57, input_ch_views=3, output_ch=5)
    )
    input_ch_cam: int = 0
    # MLP passes through kernel K1 where supports_fusion allows
    use_fused: bool = True
    # inverse-CDF lookups through kernel K2
    fused_sampling: bool = True
    device: str = "cuda"

    def test_mode(self) -> "RenderConfig":
        """perturb off, no density noise."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0)


def make_render_config(
    multires: int = 9,
    multires_views: int = 0,
    i_embed: int = 0,
    netdepth: int = 8,
    netwidth: int = 256,
    netdepth_fine: int = 8,
    netwidth_fine: int = 256,
    n_samples: int = 64,
    n_importance: int = 128,
    perturb: bool = True,
    raw_noise_std: float = 0.0,
    lindisp: bool = False,
    is_joint: bool = False,
    use_viewdirs: bool = True,
    input_ch_cam: int = 0,
    compute_dtype: Any = torch.float32,
    use_fused: bool = True,
    fused_sampling: bool = True,
    device: str = "cuda",
) -> RenderConfig:
    """A RenderConfig from reference-style flags."""
    embed_pos = get_embedder(multires, i_embed)
    embed_dirs = get_embedder(multires_views, i_embed) if use_viewdirs else None
    input_ch = embed_pos.out_dim
    input_ch_views = embed_dirs.out_dim if embed_dirs is not None else 0

    def mk(d, w):
        return NeRFConfig(
            D=d,
            W=w,
            input_ch=input_ch,
            input_ch_views=input_ch_views,
            input_ch_cam=input_ch_cam,
            output_ch=5 if n_importance > 0 else 4,
            use_viewdirs=use_viewdirs,
            compute_dtype=compute_dtype,
        )

    return RenderConfig(
        n_samples=n_samples,
        n_importance=n_importance,
        perturb=perturb,
        raw_noise_std=raw_noise_std,
        lindisp=lindisp,
        is_joint=is_joint,
        use_viewdirs=use_viewdirs,
        embed_pos=embed_pos,
        embed_dirs=embed_dirs,
        nerf_coarse=mk(netdepth, netwidth),
        nerf_fine=mk(netdepth_fine, netwidth_fine) if n_importance > 0 else None,
        input_ch_cam=input_ch_cam,
        use_fused=use_fused,
        fused_sampling=fused_sampling,
        device=device,
    )


class SceneVars(NamedTuple):
    """The per-scene state rendering reads."""

    model_coarse: NeRF
    model_fine: NeRF  # the coarse model itself when n_importance == 0
    bb_center: torch.Tensor  # (3,) scene bounding-box centre
    bb_scale: torch.Tensor  # () or (3,) scale to [-1, 1]
    embedded_cam: torch.Tensor  # (input_ch_cam,) or (0,)


def _mlp_passes(rc: RenderConfig, grad: bool) -> list:
    """A render's MLP passes, each as (network, whether its points carry a
    gradient). Single-network mode (``n_importance == 0``) queries the
    coarse network again at points drawn from its own weights, which carry
    one where ``grad``; the fine pass's draws are detached."""
    if rc.n_importance == 0:
        return [(rc.nerf_coarse, False), (rc.nerf_coarse, grad)]
    return [(rc.nerf_coarse, False), (rc.nerf_fine, False)]


def _on_k1(nerf_cfg: NeRFConfig, rc: RenderConfig, pts_grad: bool) -> bool:
    """Whether a pass runs its MLP on K1: kernels on, view directions on, an
    architecture the kernel covers (no camera latent, the standard
    encodings), and points that carry no gradient (K1's backward gives the
    weights' only). A pass on K1 whose points do carry one raises on the
    card at its backward."""
    return (rc.use_fused and rc.use_viewdirs and not pts_grad
            and supports_fusion(nerf_cfg, rc.embed_pos, rc.embed_dirs, rc.input_ch_cam))


def on_kernels(rc: RenderConfig) -> bool:
    """Whether a train step runs every MLP pass on K1 and every inverse-CDF
    draw on K2: false in single-network mode, whose second pass is plain
    while training."""
    return rc.fused_sampling and all(_on_k1(c, rc, g) for c, g in _mlp_passes(rc, grad=True))


def _query_network(model: NeRF, nerf_cfg: NeRFConfig, rc: RenderConfig, pts, viewdirs,
                   scene: SceneVars, pts_grad: bool):
    """Embed points (+ dirs + camera latent) and run the MLP, on K1 where
    ``_on_k1``. pts: (R, S, 3); viewdirs: (R, 3) or None; pts_grad: from
    ``_mlp_passes``. Returns raw (R, S, 4)."""
    x = (pts - scene.bb_center) * scene.bb_scale
    R, S = pts.shape[:2]

    if _on_k1(nerf_cfg, rc, pts_grad):
        dirs_flat = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        fcfg = FusedCfg(nerf_cfg.D, nerf_cfg.W, rc.embed_pos.num_freqs, nerf_cfg.skips)
        raw = fused_nerf_apply(model, fcfg, x.reshape(-1, 3), dirs_flat,
                               nerf_cfg.compute_dtype)
        return raw.reshape(R, S, 4)

    embedded = positional_encoding(x, rc.embed_pos)
    if viewdirs is not None:
        dirs = positional_encoding(viewdirs, rc.embed_dirs)
        feats = [embedded, dirs[:, None, :].expand(R, S, dirs.shape[-1])]
        if rc.input_ch_cam > 0:
            feats.append(scene.embedded_cam.expand(R, S, rc.input_ch_cam))
        embedded = torch.cat(feats, dim=-1)
    return model(embedded)


class RayBlock(NamedTuple):
    """Rows ``rows`` of a batch of ``total`` rays: a rank's share of the
    train step's batch."""

    rows: slice
    total: int


def _density_noise(generator, n_draw: int, n_pts: int, std: float, device, mine):
    if std <= 0.0 or generator is None:
        return 0.0
    return mine(torch.randn((n_draw, n_pts), generator=generator, device=device)) * std


def render_rays(
    scene: SceneVars,
    rc: RenderConfig,
    rays_o,
    rays_d,
    near,
    far,
    viewdirs=None,
    generator: Optional[torch.Generator] = None,
    cached_u=None,
    block: Optional[RayBlock] = None,
):
    """Render an (N, 3) ray batch into the reference's ret dict.

    near/far: scalars or (N, 1) tensors. generator=None ⇒ fully
    deterministic (linspace draws, no jitter, no noise): the test-time path.
    block: the rays are rows ``block.rows`` of a batch of ``block.total``;
    every draw is made for the whole batch and cut to those rows.
    """
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    n_draw = n_rays if block is None else block.total

    def mine(x):
        return x if block is None else x[block.rows]

    near = torch.as_tensor(near, dtype=torch.float32, device=dev).expand(n_rays, 1)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev).expand(n_rays, 1)
    if rc.use_viewdirs and viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if not rc.use_viewdirs:
        viewdirs = None

    det = (not rc.perturb) or generator is None
    _sample_pdf = fused_sample_pdf if rc.fused_sampling else sample_pdf
    (coarse_cfg, coarse_grad), (second_cfg, second_grad) = _mlp_passes(
        rc, torch.is_grad_enabled())

    # --- coarse pass -------------------------------------------------------
    z_vals = stratified_z_vals(near, far, rc.n_samples, rc.lindisp)
    if rc.perturb and generator is not None:
        z_vals = perturb_z_vals(z_vals, mine(
            torch.rand((n_draw, rc.n_samples), generator=generator, device=dev)))

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = _query_network(scene.model_coarse, coarse_cfg, rc, pts, viewdirs, scene, coarse_grad)
    noise0 = _density_noise(generator, n_draw, raw.shape[1], rc.raw_noise_std, dev, mine)
    rgb_map, disp_map, acc_map, weights, depth_map = raw2outputs(raw, z_vals, rays_d, noise0)

    if rc.n_importance == 0:
        # Single-network mode with two tiers of P_depth draws. The reference
        # crashes here on an undefined `u`; the second tier's u is returned.
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        # sorted draws keep z_vals_2 ascending, so the union is a merge
        u1 = mine(draw_u_sorted(generator, n_draw, rc.n_samples, det=det, joint=rc.is_joint,
                                device=dev))
        z_vals_2 = _sample_pdf(z_mid, weights[..., 1:-1], u1)

        pts2 = rays_o[..., None, :] + rays_d[..., None, :] * z_vals_2[..., :, None]
        raw2 = _query_network(scene.model_coarse, second_cfg, rc, pts2, viewdirs, scene,
                              second_grad)
        z_all, raw_all = merge_sorted(z_vals, z_vals_2, raw, raw2)
        noise1 = _density_noise(generator, n_draw, raw_all.shape[1], rc.raw_noise_std, dev, mine)
        rgb_map, disp_map, acc_map, weights, depth_map = raw2outputs(
            raw_all, z_all, rays_d, noise1
        )

        z_mid2 = 0.5 * (z_all[..., 1:] + z_all[..., :-1])
        if cached_u is None:
            u = mine(draw_u(generator, n_draw, rc.n_samples, det=det, joint=rc.is_joint,
                            device=dev))
        else:
            u = cached_u
        z_vals_output = _sample_pdf(z_mid2, weights[..., 1:-1], u)
        pred_hyp = torch.cat([z_vals_2, z_vals_output], dim=-1)
        return {
            "rgb_map": rgb_map,
            "disp_map": disp_map,
            "acc_map": acc_map,
            "depth_map": depth_map,
            "z_vals": z_all,
            "weights": weights,
            "pred_hyp": pred_hyp,
            "u": u,
        }

    # --- fine pass (the shipped configuration) ----------------------------
    rgb0, disp0, acc0, depth0, z0, w0 = rgb_map, disp_map, acc_map, depth_map, z_vals, weights

    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    u_imp = mine(draw_u_sorted(generator, n_draw, rc.n_importance, det=det, device=dev))
    # fine positions do not backprop into the coarse weights
    z_samples = _sample_pdf(z_mid, weights[..., 1:-1], u_imp).detach()

    z_all = merge_sorted(z_vals, z_samples)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    raw = _query_network(scene.model_fine, second_cfg, rc, pts, viewdirs, scene, second_grad)
    noise1 = _density_noise(generator, n_draw, raw.shape[1], rc.raw_noise_std, dev, mine)
    rgb_map, disp_map, acc_map, weights, depth_map = raw2outputs(raw, z_all, rays_d, noise1)

    # --- P_depth draws from the fine termination distribution -------------
    z_mid2 = 0.5 * (z_all[..., 1:] + z_all[..., :-1])
    if cached_u is None:
        u = mine(draw_u(generator, n_draw, rc.n_importance, det=det, joint=rc.is_joint,
                        device=dev))
    else:
        u = cached_u
    pred_hyp = _sample_pdf(z_mid2, weights[..., 1:-1], u)  # differentiable

    # the reference computes z_std from the P_depth draws (population std)
    z_std = torch.std(pred_hyp, dim=-1, unbiased=False)

    return {
        "rgb_map": rgb_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "depth_map": depth_map,
        "z_vals": z_all,
        "weights": weights,
        "pred_hyp": pred_hyp,
        "u": u,
        "rgb0": rgb0,
        "disp0": disp0,
        "acc0": acc0,
        "depth0": depth0,
        "z_vals0": z0,
        "weights0": w0,
        "z_std": z_std,
    }


def render_ray_batch(
    scene: SceneVars,
    rc: RenderConfig,
    rays_o,
    rays_d,
    near,
    far,
    chunk: int = 32768,
    generator: Optional[torch.Generator] = None,
    outputs: Optional[tuple] = None,
):
    """Render any number of rays in chunks of ``chunk``.

    near/far: scalars, (N,) or (N, 1). ``outputs``: the ret-dict keys to keep;
    naming only the maps a caller reads keeps the per-sample leaves (about 192
    floats per ray each) from piling up over the chunks.
    """
    n = rays_o.shape[0]

    def per_ray(x):
        x = torch.as_tensor(x, dtype=rays_o.dtype, device=rays_o.device)
        if x.ndim == 0:
            x = x.reshape(1, 1)
        elif x.ndim == 1:
            x = x[:, None]
        return x.expand(n, 1)

    near, far = per_ray(near), per_ray(far)
    pieces = []
    for start in range(0, n, chunk):
        sl = slice(start, min(start + chunk, n))
        out = render_rays(scene, rc, rays_o[sl], rays_d[sl], near[sl], far[sl],
                          generator=generator)
        if outputs is not None:
            out = {k: out[k] for k in outputs}
        pieces.append(out)
    return {k: torch.cat([p[k] for p in pieces], dim=0) for k in pieces[0]}


def render_image(
    scene: SceneVars,
    rc: RenderConfig,
    H: int,
    W: int,
    intrinsic,
    c2w,
    near,
    far,
    chunk: int = 16384,
    with_5_9: bool = False,
    outputs: Optional[tuple] = None,
    ranks: Optional[Ranks] = None,
):
    """Full-image deterministic render on ``rc.device``, without gradients.
    Returns the ret dict with (H, W, ...) leaves (W cropped to 16:9 with
    ``with_5_9``).

    ranks: render sharded over the process group (every rank must call it):
    the flattened rays split into equal contiguous blocks, one a data row
    (the last padded with copies of the last ray), each data row renders its
    block, and every rank gets the whole maps
    (scade_tpu/render/renderer.py:467-526). On a grid with a model axis the
    ranks of a row render their block together, each with its columns of
    the sharded layers (``parallel/mesh.py``)."""
    device = torch.device(rc.device)
    intrinsic = torch.as_tensor(intrinsic, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    with torch.no_grad():
        rays_o, rays_d = get_rays(H, W, intrinsic, c2w)
        w_out = W
        if with_5_9:
            w_out = int(H / 9.0 * 16.0 / 3.0)
            if w_out % 2 != 0:
                w_out -= 1
            start = (W - w_out) // 2
            rays_o = rays_o[:, start: start + w_out, :]
            rays_d = rays_d[:, start: start + w_out, :]
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        if ranks is None:
            out = render_ray_batch(scene, rc.test_mode(), rays_o, rays_d, float(near),
                                   float(far), chunk=chunk, outputs=outputs)
        else:
            n = rays_o.shape[0]
            per = -(-n // ranks.n_data)
            mine = slice(ranks.data_index * per, (ranks.data_index + 1) * per)

            def padded(x):
                return torch.cat([x, x[-1:].expand(per * ranks.n_data - n, 3)])[mine]

            out = render_ray_batch(scene, rc.test_mode(), padded(rays_o), padded(rays_d),
                                   float(near), float(far), chunk=min(chunk, per),
                                   outputs=outputs)
            out = {k: ranks.gather_rows(v, n) for k, v in out.items()}
    return {k: v.reshape((H, w_out) + v.shape[1:]) for k, v in out.items()}
