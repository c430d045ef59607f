"""Fused positional encoding + NeRF MLP: kernel K1 and its plain version.

Replaces the Pallas kernel ``scade_tpu/ops/fused_mlp.py::_kernel``. The CUDA
source is ``csrc/fused_mlp.cu``; its header says what bounds it on the card
(operations: 1.17 MFLOP per point at D=8, W=256, F=9) and how the design
keeps the activations on chip and runs the W-wide layers on the tensor cores
with ``wgmma``, its weights streamed by bulk asynchronous copies into a ring
of ``mbarrier``-guarded stages. The kernel reads its weights from one buffer
that ``pack_weights`` writes per call, in the layout ``pack_layout`` and
``part_positions`` describe: each staged chunk is already the shared-memory
image the products read.

``fused_nerf_apply`` is the entry point. For CUDA tensors it launches the
kernel (``fused_mlp_cuda``) and raises if the launch fails; only for CPU
tensors does it take the plain version (``fused_mlp_plain``), which is also
the oracle the kernel is held against. Its backward gives the gradients of
the f32 network in either mode. On the card, where pts and dirs want no
gradient (no train path asks for one), it runs K1's backward kernels
(``fused_mlp_backward_cuda``): the network recomputed per tile on chip, as
the JAX package's custom VJP recomputes, and its weight and bias gradients
in 3xTF32, reading the weights also in a transposed packed layout
(``pack_layout_t``), with the ReLU decisions of the plain version in f32
where 3xTF32 may take another. Otherwise, and on the CPU, it recomputes
through the plain version in f32 and takes ``torch.autograd.grad`` of it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from scade_tpu_torch import _kernels
from scade_tpu_torch.ops.embedding import Embedder, positional_encoding
from scade_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FusedCfg:
    """The static slice of NeRFConfig and the embedder the kernel needs."""

    D: int
    W: int
    num_freqs: int
    skips: Tuple[int, ...]


def supports_fusion(nerf_cfg, embed_pos, embed_dirs, input_ch_cam: int) -> bool:
    """The kernel covers the shipped architecture: view branch on, no camera
    latent, log-sampled PE with the input included, raw dirs
    (multires_views=0)."""
    return (
        nerf_cfg.use_viewdirs
        and input_ch_cam == 0
        and not embed_pos.identity
        and embed_pos.include_input
        and embed_pos.log_sampling
        and embed_pos.num_freqs >= 1
        and float(embed_pos.max_freq_log2) == float(embed_pos.num_freqs - 1)
        and (embed_dirs is None or embed_dirs.num_freqs == 0)
    )


def flat_weights(model) -> List[torch.Tensor]:
    """(weight, bias) pairs in the kernel's order: trunk, alpha, feature,
    views, rgb. On a model sharded over a model axis (``parallel/mesh.py``)
    each sharded tensor is first gathered whole over the model group (the
    kernel computes the whole network per point), differentiably: the
    backward hands each rank the grad of its own rows. This is what XLA does
    with a custom call that has no partitioning rule."""
    names = [*(f"pts_linears.{i}" for i in range(len(model.pts_linears))), "alpha_linear",
             "feature_linear", "views_linears.0", "rgb_linear"]
    axis = model.model_axis
    out = []
    for name in names:
        layer = model.get_submodule(name)
        for t in (layer.weight, layer.bias):
            out.append(t if axis is None or name not in axis.layers
                       else axis.ranks.model_gather(t, 0))
    return out


def fused_mlp_plain(weights: Sequence[torch.Tensor], cfg: FusedCfg, pts, dirs,
                    compute_dtype=torch.float32):
    """The kernel's function in plain PyTorch: operands rounded to
    ``compute_dtype`` at each product, f32 sums, f32 biases added after the
    sum. (N, 3) normalized pts + (N, 3) dirs → (N, 4)."""
    D = cfg.D

    def rnd(x):
        return x if compute_dtype == torch.float32 else x.to(compute_dtype).float()

    def dense(x, i):
        return F.linear(rnd(x), rnd(weights[2 * i]), weights[2 * i + 1])

    emb = positional_encoding(
        pts, Embedder(input_dims=3, num_freqs=cfg.num_freqs,
                      max_freq_log2=float(cfg.num_freqs - 1)),
    )
    h = emb
    for i in range(D):
        x = torch.cat([emb, h], dim=-1) if i > 0 and (i - 1) in cfg.skips else h
        h = torch.relu(dense(x, i))
    alpha = dense(h, D)
    feature = dense(h, D + 1)
    hv = torch.relu(dense(torch.cat([feature, dirs], dim=-1), D + 2))
    rgb = dense(hv, D + 3)
    return torch.cat([rgb, F.softplus(10.0 * alpha) / 10.0], dim=-1)


@dataclasses.dataclass(frozen=True)
class Part:
    """One matrix of a packed weight buffer: rows ``n0 .. n0 + n`` of layer
    ``layer``'s weight, input columns ``k0 .. k0 + k``, padded with zero
    columns to ``kp``, from element ``offset`` on; if ``transposed``, the
    same of the weight's transpose (its rows the inputs, its columns the
    outputs). A head (``staged`` False: alpha, rgb) is stored row-major. A
    tensor-core part (``staged``) is a run of chunk images, ``copies`` of
    each: see ``part_positions``."""

    layer: int
    k0: int
    k: int
    kp: int
    n: int
    offset: int
    staged: bool = False
    copies: int = 1
    n0: int = 0
    transposed: bool = False

    @property
    def size(self) -> int:
        return self.copies * self.n * self.kp


def kstep(dtype) -> int:
    """Depth of one tensor-core product: wgmma k16 in bf16, k8 in tf32 (32
    bytes either way)."""
    return 16 if dtype == torch.bfloat16 else 8


def chunk_depth(dtype) -> int:
    """K of one staged weight chunk, the group of products summed apart
    before the rounded add: 64 in bf16 (four k16 products), 8 in tf32 (the
    three k8 products of 3xTF32)."""
    return 64 if dtype == torch.bfloat16 else 8


def copies(dtype) -> int:
    """Copies of a staged chunk: f32 weights come as their tf32 hi and lo
    halves (``tf32_round``), bf16 weights as they are."""
    return 2 if dtype == torch.float32 else 1


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits' ulp
    to the magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@functools.lru_cache(maxsize=None)
def pack_layout(cfg: FusedCfg, dtype) -> Tuple[Part, ...]:
    """The parts of the packed buffer, in the order the kernel reads them:
    each trunk layer (the skip layer as its emb part, then its h part), the
    alpha head, the feature layer, the view layer (feature part, then dirs
    part), the rgb head, one after another with no gap. A staged part's K is
    padded with zeros to whole chunks (``chunk_depth``): the skip layer's emb
    part and layer 0 take E = 3 + 6F to at most 64 columns, the dirs part 3
    to one chunk. A head's K (W or W/2) is whole product depths as it is.
    Every part starts 16-byte aligned, as ``cp.async.bulk`` needs."""
    D, W, E = cfg.D, cfg.W, 3 + 6 * cfg.num_freqs
    parts: List[Part] = []
    end = 0

    def add(layer, k0, k, n, staged=True):
        nonlocal end
        step = chunk_depth(dtype) if staged else kstep(dtype)
        kp = -(-k // step) * step
        part = Part(layer, k0, k, kp, n, end, staged, copies(dtype) if staged else 1)
        parts.append(part)
        end += part.size

    for layer in range(D):
        if layer == 0:
            add(0, 0, E, W)
        elif (layer - 1) in cfg.skips:
            add(layer, 0, E, W)
            add(layer, E, W, W)
        else:
            add(layer, 0, W, W)
    add(D, 0, W, 1, staged=False)  # alpha
    add(D + 1, 0, W, W)  # feature
    add(D + 2, 0, W, W // 2)  # views on the feature
    add(D + 2, W, 3, W // 2)  # views on the dirs
    add(D + 3, 0, W // 2, 3, staged=False)  # rgb
    return tuple(parts)


@functools.lru_cache(maxsize=None)
def pack_layout_t(cfg: FusedCfg) -> Tuple[Part, ...]:
    """The parts of the transposed buffer K1's backward reads (f32 only: its
    products are 3xTF32), in its order: the view layer's feature columns,
    the feature layer, then trunk layers D-1 down to 1 (the skip layer's h
    columns, rows E .. E + W of its transpose). Each is W rows of the
    transpose, K its outputs (W/2 for the view layer, else W), staged as
    ``pack_layout``'s f32 parts are: tf32 hi and lo chunk images of depth 8,
    16-byte aligned, one after another from element 0. The delta of a
    layer's input is the delta of its output times this matrix: wgmma's
    tf32 products read both operands K-major only, so the weight comes
    transposed."""
    D, W, E = cfg.D, cfg.W, 3 + 6 * cfg.num_freqs
    parts: List[Part] = []
    end = 0

    def add(layer, k, n0):
        nonlocal end
        part = Part(layer, 0, k, k, W, end, True, copies(torch.float32), n0, True)
        parts.append(part)
        end += part.size

    add(D + 2, W // 2, 0)
    add(D + 1, W, 0)
    for layer in range(D - 1, 0, -1):
        add(layer, W, E if (layer - 1) in cfg.skips else 0)
    return tuple(parts)


def part_positions(p: Part, dtype) -> torch.Tensor:
    """(copies, n, kp): where each element of the part's padded matrix lies in
    the packed buffer. A head is row-major. A staged part is cut along K into
    chunks of ``chunk_depth``, stored one after the other, each as
    ``copies`` images (f32: hi, then lo) of the shared memory
    that the kernel's wgmma B descriptor reads: core matrices of 8 rows x 16
    bytes, 128 contiguous bytes each; in a chunk, the core matrices of rows
    8b..8b+7 lie together, in K order. So one bulk copy moves a chunk as it
    is."""
    rows, kk = torch.arange(p.n)[:, None], torch.arange(p.kp)
    if not p.staged:
        return (p.offset + rows * p.kp + kk)[None]
    cd, t16 = chunk_depth(dtype), 16 // torch.empty((), dtype=dtype).element_size()
    c, kl = kk // cd, kk % cd
    within = (rows // 8) * 8 * cd + (kl // t16) * 8 * t16 + (rows % 8) * t16 + kl % t16
    copy = torch.arange(p.copies)[:, None, None] * p.n * cd
    return p.offset + c * p.copies * p.n * cd + copy + within


@functools.lru_cache(maxsize=None)
def _weight_shapes(cfg: FusedCfg) -> Tuple[Tuple[int, int], ...]:
    """(out, in) of each weight matrix of ``flat_weights``."""
    D, W, E = cfg.D, cfg.W, 3 + 6 * cfg.num_freqs
    trunk = [(W, E if layer == 0 else E + W if (layer - 1) in cfg.skips else W)
             for layer in range(D)]
    return (*trunk, (1, W), (W, W), (W // 2, W + 3), (3, W // 2))


@functools.lru_cache(maxsize=None)
def _pack_index(cfg: FusedCfg, dtype, device, transposed: bool = False) -> torch.Tensor:
    """For each element of the packed buffer (``pack_layout``'s, or
    ``pack_layout_t``'s if ``transposed``), its index in ``_pack_source``:
    the weight matrices flattened and concatenated (bf16, or f32 followed by
    their tf32 hi and lo halves), then one zero, taken where the layout
    pads."""
    shapes = _weight_shapes(cfg)
    starts = [0]
    for n, k in shapes:
        starts.append(starts[-1] + n * k)
    total = starts[-1]
    parts = pack_layout_t(cfg) if transposed else pack_layout(cfg, dtype)
    zero = total * (3 if dtype == torch.float32 else 1)
    index = torch.full((parts[-1].offset + parts[-1].size,), zero)
    for p in parts:
        k_in = shapes[p.layer][1]
        rows, cols = p.n0 + torch.arange(p.n)[:, None], p.k0 + torch.arange(p.k)
        src = torch.full((p.n, p.kp), -1)
        src[:, :p.k] = starts[p.layer] + (cols * k_in + rows if p.transposed else rows * k_in + cols)
        pos = part_positions(p, dtype)
        for cp in range(p.copies):
            # a staged f32 part reads the hi, then the lo halves
            base = (1 + cp) * total if p.staged and dtype == torch.float32 else 0
            index[pos[cp]] = torch.where(src >= 0, src + base, zero)
    return index.to(device)


def _pack_source(mats: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    flat = torch.cat([m.reshape(-1) for m in mats]).to(dtype)
    zero = flat.new_zeros(1)
    if dtype != torch.float32:
        return torch.cat([flat, zero])
    hi = tf32_round(flat)
    return torch.cat([flat, hi, tf32_round(flat - hi), zero])


def pack_weights(weights: Sequence[torch.Tensor], cfg: FusedCfg, dtype,
                 transposed: bool = False) -> torch.Tensor:
    """The weights of ``flat_weights`` in the kernel's packed layout: one
    contiguous 1-D buffer of ``dtype`` (bf16, or f32 for the 3xTF32 mode,
    whose staged parts hold the tf32 hi and lo halves), zero wherever
    ``pack_layout`` pads, written anew on every call by one gather. Biases are
    not packed: the kernel reads them as they are, in f32. ``transposed``:
    ``pack_layout_t``'s buffer instead (``dtype`` f32: K1's backward)."""
    mats = [w.detach() for w in weights[0::2]]
    shapes = _weight_shapes(cfg)
    if [tuple(m.shape) for m in mats] != list(shapes):
        raise ValueError(f"pack_weights: weight shapes {[tuple(m.shape) for m in mats]}, "
                         f"expected {list(shapes)}")
    src = _pack_source(mats, dtype)
    return src[_pack_index(cfg, dtype, src.device, transposed)]


def _table(parts: Sequence[Part]):
    return (ctypes.c_int * (3 * len(parts)))(*[v for p in parts for v in (p.offset, p.n, p.kp)])


@functools.lru_cache(maxsize=None)
def _layout_table(cfg: FusedCfg, dtype):
    return _table(pack_layout(cfg, dtype))


@functools.lru_cache(maxsize=None)
def _layout_table_t(cfg: FusedCfg):
    return _table(pack_layout_t(cfg))


def _check_operand(t: torch.Tensor, shape, what: str):
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def kernel_geometry() -> dict:
    """The built kernel's points per block at a time, stages of its ring in
    bf16 and f32 mode, and the blocks the card holds at once at W=256 in each
    mode."""
    keys = ("tile", "stages_bf16", "stages_f32", "blocks_bf16", "blocks_f32")
    fn = _kernels.load("fused_mlp").fused_mlp_geometry
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(keys)
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in keys]
    _kernels.check(fn(*[ctypes.byref(v) for v in vals]), "fused_mlp_geometry")
    return dict(zip(keys, (v.value for v in vals)))


def _check_call(what: str, weights: Sequence[torch.Tensor], cfg: FusedCfg, pts, dirs) -> int:
    """Refuses what the kernels do not take; returns n."""
    if cfg.W not in (64, 128, 256) or not 1 <= cfg.D <= 16 or not 1 <= cfg.num_freqs <= 10:
        raise ValueError(f"{what}: D={cfg.D}, W={cfg.W}, F={cfg.num_freqs} not "
                         "supported (D <= 16, W in 64/128/256, F <= 10)")
    if any(s >= 31 for s in cfg.skips):
        raise ValueError(f"{what}: skips {cfg.skips} out of range")
    n = pts.shape[0]
    _check_operand(pts, (n, 3), "pts")
    _check_operand(dirs, (n, 3), "dirs")
    if len(weights) != 2 * (cfg.D + 4):
        raise ValueError(f"{what}: {len(weights)} weight tensors, expected {2 * (cfg.D + 4)}")
    for i, w in enumerate(weights):
        _check_operand(w, None, f"weights[{i}]")
        if w.device != pts.device:
            raise ValueError(f"weights[{i}] on {w.device}, pts on {pts.device}")
    return n


def fused_mlp_cuda(weights: Sequence[torch.Tensor], cfg: FusedCfg, pts, dirs,
                   compute_dtype=torch.float32):
    """Launches kernel K1 on the current stream. ``fused_mlp_cuda.launches``
    counts the launches."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_mlp_cuda: compute_dtype {compute_dtype} not supported")
    n = _check_call("fused_mlp_cuda", weights, cfg, pts, dirs)
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    packed = pack_weights(weights, cfg, compute_dtype)
    table = _layout_table(cfg, compute_dtype)
    lib = _kernels.load("fused_mlp")
    fn = lib.fused_mlp_forward
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    biases = (ctypes.c_void_p * (cfg.D + 4))(*[b.data_ptr() for b in weights[1::2]])
    skip_mask = sum(1 << s for s in cfg.skips)
    status = fn(
        pts.data_ptr(), dirs.data_ptr(), out.data_ptr(), n, cfg.D, cfg.W,
        cfg.num_freqs, skip_mask, int(compute_dtype == torch.bfloat16), packed.data_ptr(),
        table, len(table) // 3, biases, torch.cuda.current_stream(pts.device).cuda_stream,
    )
    _kernels.check(status, "fused_mlp_forward")
    fused_mlp_cuda.launches += 1
    return out


fused_mlp_cuda.launches = 0


def fused_mlp_backward_cuda(weights: Sequence[torch.Tensor], cfg: FusedCfg, pts, dirs, g):
    """K1's backward on the current stream: from the upstream gradient ``g``
    (N, 4), the gradient of the f32 network (3xTF32, see ``csrc/fused_mlp.cu``)
    for each tensor of ``weights``, in their order, as views of one buffer,
    its ReLU decisions plain f32's. Four kernels and the packing of both
    layouts; no gradient of pts or dirs. ``fused_mlp_backward_cuda.launches``
    counts the calls."""
    n = _check_call("fused_mlp_backward_cuda", weights, cfg, pts, dirs)
    _check_operand(g, (n, 4), "g")
    if g.data_ptr() % 16:
        raise ValueError("fused_mlp_backward_cuda: g must be 16-byte aligned (rows read as float4)")
    sizes = [w.numel() for w in weights]
    grad = torch.empty(sum(sizes), dtype=torch.float32, device=pts.device)
    if n == 0:
        grad.zero_()
    else:
        lib = _kernels.load("fused_mlp")
        skip_mask = sum(1 << s for s in cfg.skips)
        shape = (n, cfg.D, cfg.W, cfg.num_freqs, skip_mask)
        size = ctypes.c_longlong()
        fn = lib.fused_mlp_backward_workspace
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        _kernels.check(fn(*shape, ctypes.byref(size)), "fused_mlp_backward_workspace")
        workspace = torch.empty(size.value, dtype=torch.uint8, device=pts.device)
        packed = pack_weights(weights, cfg, torch.float32)
        packed_t = pack_weights(weights, cfg, torch.float32, transposed=True)
        table, table_t = _layout_table(cfg, torch.float32), _layout_table_t(cfg)
        biases = (ctypes.c_void_p * (cfg.D + 4))(*[b.data_ptr() for b in weights[1::2]])
        fn = lib.fused_mlp_backward
        mats = (ctypes.c_void_p * (cfg.D + 4))(*[w.data_ptr() for w in weights[0::2]])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        status = fn(
            pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), grad.data_ptr(), grad.numel(), *shape,
            packed.data_ptr(), table, len(table) // 3, packed_t.data_ptr(), table_t,
            len(table_t) // 3, mats, biases, workspace.data_ptr(), size.value,
            torch.cuda.current_stream(pts.device).cuda_stream,
        )
        _kernels.check(status, "fused_mlp_backward")
    fused_mlp_backward_cuda.launches += 1
    return [t.view_as(w) for t, w in zip(torch.split(grad, sizes), weights)]


fused_mlp_backward_cuda.launches = 0


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, compute_dtype, pts, dirs, *weights):
        ctx.cfg = cfg
        ctx.save_for_backward(pts, dirs, *weights)
        if pts.device.type == "cpu":
            return fused_mlp_plain(weights, cfg, pts, dirs, compute_dtype)
        return fused_mlp_cuda(weights, cfg, pts, dirs, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        pts, dirs, *weights = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        if pts.device.type == "cuda" and not (needs[0] or needs[1]):
            # the kernels give every weight's gradient; the points' would
            # need the delta of the embedding, which no train path asks for
            with span("scade.k1.recompute"):
                grads = fused_mlp_backward_cuda(weights, ctx.cfg, pts, dirs, g.contiguous())
            return (None, None, None, None,
                    *[gr if need else None for gr, need in zip(grads, needs[2:])])
        inputs = [t.detach().requires_grad_(need) for t, need in zip([pts, dirs, *weights], needs)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), span("scade.k1.recompute"):
            out = fused_mlp_plain(inputs[2:], ctx.cfg, inputs[0], inputs[1])
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None, None, *[next(grads) if t.requires_grad else None for t in inputs])


def fused_nerf_apply(model, cfg: FusedCfg, pts, dirs, compute_dtype=torch.float32):
    """(N, 3) normalized pts + (N, 3) dirs → (N, 4) raw, differentiable in
    pts, dirs and the model's parameters."""
    return _FusedMLP.apply(cfg, compute_dtype, pts.contiguous(), dirs.contiguous(),
                           *flat_weights(model))
