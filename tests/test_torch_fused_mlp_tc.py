"""Kernel K1's tensor-core form, as far as the CPU can check it: the packed
weight buffer the kernel reads (``pack_layout``, ``pack_weights``), and the
arithmetic of its f32 mode ("3xTF32") emulated in PyTorch.

The kernel itself runs only on the card (tests/test_torch_cuda.py). Here:
- the packing round-trips bit for bit through the inverse of its
  permutation (f32 parts as their tf32 hi and lo halves), pads with zeros,
  aligns every part to 16 bytes and every staged chunk to one contiguous
  bulk copy of 128-byte core matrices, and splits the skip layer and the
  view layer where the kernel reads them, at small configs (W=64/128, D=8,
  F=4/10); read back by the kernel's descriptor arithmetic, each chunk
  holds the weights where the products look; it reads the weights anew on
  every call and refuses a weight of the wrong shape or a missing layer;
- 3xTF32 through the whole network at W=256, F=9 on 4,096 points stays
  within 1e-5 of ``fused_mlp_plain`` (its f32 function, evaluated in f64;
  2.9e-6 seen), far under the 1e-4 the kernel is held to on the card, while
  plain TF32 (the lo terms dropped) misses 1e-4 (3.5e-3 seen): the test
  tells the two apart.
"""

import types

import numpy as np
import pytest
import torch

from scade_tpu_torch.models.nerf import NeRF, NeRFConfig
from scade_tpu_torch.ops import fused_mlp

CONFIGS = [(64, 4), (64, 10), (128, 4), (128, 10)]  # (W, F), D=8, skip after layer 4
DTYPES = [torch.float32, torch.bfloat16]


def packed(W, F, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = NeRF(NeRFConfig(D=8, W=W, input_ch=3 + 6 * F, input_ch_views=3), generator=gen)
    with torch.no_grad():  # random biases, so a bias packed by mistake would show
        for p in model.parameters():
            p.uniform_(-1, 1, generator=gen)
    cfg = fused_mlp.FusedCfg(8, W, F, (4,))
    weights = fused_mlp.flat_weights(model)
    return cfg, weights, fused_mlp.pack_weights(weights, cfg, dtype), \
        fused_mlp.pack_layout(cfg, dtype)


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def unpacked(buf, p, dtype):
    """Part ``p``'s (copies, n, kp) matrices read back from the packed buffer
    through the inverse of the layout's permutation."""
    return buf[fused_mlp.part_positions(p, dtype)]


def expected_copies(w, p, dtype):
    """What the kernel must find for part ``p`` of weight ``w`` (its columns
    k0 .. k0 + k): the tf32 hi and lo halves of a staged f32 part, else the
    weights in ``dtype``."""
    w = w.detach()[:, p.k0:p.k0 + p.k]
    if p.staged and dtype == torch.float32:
        hi = tf32_rna(w)
        return [hi, tf32_rna(w - hi)]
    return [w.to(dtype)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,F", CONFIGS)
def test_pack_round_trips(W, F, dtype):
    cfg, weights, buf, parts = packed(W, F, dtype)
    assert buf.dtype == dtype and buf.dim() == 1 and buf.is_contiguous()
    for layer in range(cfg.D + 4):
        mine = sorted((p for p in parts if p.layer == layer), key=lambda p: p.k0)
        assert sum(p.k for p in mine) == weights[2 * layer].shape[1]
        for p in mine:
            got = unpacked(buf, p, dtype)[..., :p.k]
            want = expected_copies(weights[2 * layer], p, dtype)
            assert got.shape[0] == len(want) == p.copies
            for g, w in zip(got, want):
                assert torch.equal(bits(g), bits(w))
    # f32: hi + lo is the weight to 2^-22 of it, and a weight that tf32 holds
    # exactly has a zero lo half
    if dtype == torch.float32:
        p = parts[1]
        hi, lo = unpacked(buf, p, dtype)[..., :p.k]
        w = weights[2 * p.layer].detach()[:, p.k0:p.k0 + p.k]
        assert ((hi + lo - w).abs() <= w.abs() * 2.0**-21).all()
        assert not (lo[hi == w] != 0).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,F", CONFIGS)
def test_pack_pads_with_zeros(W, F, dtype):
    cfg, weights, buf, parts = packed(W, F, dtype)
    used = torch.zeros(buf.numel(), dtype=torch.int64)
    holds = torch.zeros(buf.numel(), dtype=torch.bool)
    first = torch.zeros(buf.numel(), dtype=torch.bool)  # a weight or its hi half
    for p in parts:
        pos = fused_mlp.part_positions(p, dtype)
        used.index_add_(0, pos.reshape(-1), torch.ones(pos.numel(), dtype=torch.int64))
        holds[pos[..., :p.k].reshape(-1)] = True
        first[pos[0, :, :p.k].reshape(-1)] = True
    assert (used == 1).all()  # the parts tile the buffer: no gap, no overlap
    assert int(holds.sum()) == sum(p.copies * p.n * p.k for p in parts)
    assert not bits(buf)[~holds].any()
    # every weight lands in a slot that holds one: the source's nonzero mask,
    # packed, is nonzero exactly where the packed weights are (uniform_ can
    # draw an exact 0, about once in 2^24 draws); a 1's lo half is 0
    source_nonzero = fused_mlp.pack_weights([(w != 0).float() for w in weights], cfg,
                                            dtype) != 0
    assert (source_nonzero <= holds).all()
    assert torch.equal((buf != 0)[first], source_nonzero[first])
    assert not source_nonzero[holds & ~first].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,F", CONFIGS)
def test_pack_aligns_parts_and_rows(W, F, dtype):
    cfg, _, buf, parts = packed(W, F, dtype)
    elem = buf.element_size()
    step, depth = fused_mlp.kstep(dtype), fused_mlp.chunk_depth(dtype)
    for p in parts:
        assert p.offset * elem % 16 == 0  # cp.async.bulk copies from 16-byte boundaries
        assert p.kp % step == 0 and p.kp * elem % 32 == 0  # a row is whole product depths
        pad = depth if p.staged else step  # a staged part is whole chunks
        assert p.kp % pad == 0 and p.k <= p.kp < p.k + pad
        if not p.staged:
            continue
        # every chunk is one bulk copy of 16-byte multiples, its core
        # matrices 128-byte aligned, and fits a stage of the ring
        pos = fused_mlp.part_positions(p, dtype)
        for k0 in range(0, p.kp, depth):
            chunk = pos[:, :, k0:k0 + depth]
            lo, size = int(chunk.min()), chunk.numel()
            assert lo * elem % 16 == 0 and size * elem % 16 == 0
            assert int(chunk.max()) == lo + size - 1  # contiguous
            assert not ((chunk[:, ::8, ::16 // elem] - lo) * elem % 128).any()
            assert size <= cfg.W * depth * p.copies  # a stage: W rows of a chunk
    assert parts[-1].offset + parts[-1].size == buf.numel()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,F", CONFIGS)
def test_pack_splits_where_the_kernel_reads(W, F, dtype):
    cfg, _, _, parts = packed(W, F, dtype)
    D, E, depth = cfg.D, 3 + 6 * F, fused_mlp.chunk_depth(dtype)
    # the kernel's order: trunk (the skip layer as emb part, then h part),
    # alpha, feature, views (feature part, then dirs part), rgb
    order = [(p.layer, p.k0, p.k, p.n) for p in parts]
    trunk = [(0, 0, E, W)] + [t for layer in range(1, D) for t in (
        [(layer, 0, E, W), (layer, E, W, W)] if layer == 5 else [(layer, 0, W, W)])]
    assert order == trunk + [(D, 0, W, 1), (D + 1, 0, W, W), (D + 2, 0, W, W // 2),
                             (D + 2, W, 3, W // 2), (D + 3, 0, W // 2, 3)]
    emb_parts = [p for p in parts if p.k0 == 0 and p.k == E]
    assert len(emb_parts) == 2 and all(E <= p.kp <= 64 for p in emb_parts)
    assert parts[-2].kp == depth  # the dirs part: 3 columns padded to one chunk
    # the heads stay on the CUDA cores, row-major and whole; every other part
    # goes through the tensor cores, in f32 as its hi and lo halves
    assert [p.staged for p in parts] == [p.n >= 8 for p in parts]
    assert all(p.copies == (fused_mlp.copies(dtype) if p.staged else 1) for p in parts)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_chunks_are_what_the_descriptor_reads(dtype):
    """Reads each staged chunk back the way the kernel's products do: a
    group of products for output columns col .. col + 63 at product depth i
    of a chunk starting at byte st reads B[n][k] (k < 32 bytes of the depth)
    at st + (col / 8) * SBO + i * 256 + ((n - col) / 8) * SBO + (k bytes / 16)
    * 128 (LBO) + (n % 8) * 16 + k bytes % 16, SBO = 256 bytes per depth of
    the chunk; an f32 chunk's lo copy follows its hi copy at rows * 32
    bytes. Every chunk is whole: 4 depths in bf16, 1 in f32."""
    cfg, weights, buf, parts = packed(128, 9, dtype)
    elem = buf.element_size()
    raw = buf.view(torch.uint8)
    depth, per = fused_mlp.chunk_depth(dtype), 32 // elem  # elements a product depth
    for p in (p for p in parts if p.staged):
        want = expected_copies(weights[2 * p.layer], p, dtype)
        for c0 in range(0, p.kp, depth):
            depths = depth // per
            st = (p.offset + c0 * p.copies * p.n) * elem
            sbo = depths * 256
            for cp in range(p.copies):
                base = st + cp * p.n * depths * 32
                for n in range(0, p.n, 3):  # every third row
                    for kk in range(depths * per):
                        k = c0 + kk
                        i, kb = divmod(kk * elem, 32)
                        at = base + (n // 8) * sbo + i * 256 + (kb // 16) * 128 + (n % 8) * 16 \
                            + kb % 16
                        v = raw[at:at + elem].view(dtype)[0]
                        w = want[cp][n, k] if k < p.k else torch.zeros((), dtype=dtype)
                        assert torch.equal(bits(v), bits(w)), (p, cp, n, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_reads_the_weights_of_each_call(dtype):
    cfg, weights, before, parts = packed(64, 4, dtype)
    weights[2].data.mul_(2)  # a write the version counter does not see
    after = fused_mlp.pack_weights(weights, cfg, dtype)
    p = next(p for p in parts if p.layer == 1)
    for got, want in zip(unpacked(after, p, dtype)[..., :p.k], expected_copies(weights[2], p, dtype)):
        assert torch.equal(bits(got), bits(want))
    assert not torch.equal(before, after)


def _trunk_short_a_column(w, cfg):
    w[2] = w[2][:, :-1]


def _skip_short_a_row(w, cfg):
    w[2 * 5] = w[2 * 5][:-1]


def _views_without_dirs(w, cfg):
    w[2 * (cfg.D + 2)] = w[2 * (cfg.D + 2)][:, :cfg.W]


def _one_layer_short(w, cfg):
    del w[-2:]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wrong", [_trunk_short_a_column, _skip_short_a_row, _views_without_dirs,
                                   _one_layer_short])
def test_pack_rejects_wrong_shapes(wrong, dtype):
    cfg, weights, _, _ = packed(64, 4, dtype)
    weights = list(weights)
    wrong(weights, cfg)
    with pytest.raises(ValueError, match="weight shapes"):
        fused_mlp.pack_weights(weights, cfg, dtype)


def tf32_rna(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped bits' ulp to the
    magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def linear_3xtf32(x, w, b):
    """The f32 mode's products: x = xh + xl, w = wh + wl, each part TF32, and
    x w^T ~ xl wh^T + xh wl^T + xh wh^T summed in f32 (every product of two
    TF32 values is exact in f32), f32 bias after the sum."""
    xh, wh = tf32_rna(x), tf32_rna(w)
    xl, wl = tf32_rna(x - xh), tf32_rna(w - wh)
    return xl @ wh.T + xh @ wl.T + xh @ wh.T + b


def linear_tf32(x, w, b):
    return tf32_rna(x) @ tf32_rna(w).T + b


def test_tf32_rounding_is_to_nearest():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32))
    r = tf32_rna(x)
    assert torch.equal(fused_mlp.tf32_round(x), r)  # what pack_weights splits with
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()  # half an ulp of 10 mantissa bits
    # ties go away from zero: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    ties = torch.tensor([1 + 2**-11, -(1 + 2**-11)], dtype=torch.float32)
    assert tf32_rna(ties).tolist() == [1 + 2**-10, -(1 + 2**-10)]


@pytest.mark.parametrize("linear,within", [(linear_3xtf32, True), (linear_tf32, False)])
def test_3xtf32_network_is_f32_accurate(monkeypatch, linear, within):
    W, F, n = 256, 9, 4096
    model = NeRF(NeRFConfig(D=8, W=W, input_ch=3 + 6 * F, input_ch_views=3),
                 generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3))
    dirs = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    cfg = fused_mlp.FusedCfg(8, W, F, (4,))
    weights = [w.detach() for w in fused_mlp.flat_weights(model)]
    # One PE for both, in f32 as the kernel computes it: the f32 argument
    # pi 2^f x is itself rounded (5.2e-5 from an f64 PE at f=8, 4.3e-5 at
    # the output), which is the PE's error, not the products'. The oracle
    # then runs the network in f64, the emulation in f32. The PE must be
    # deterministic for that to hold.
    embedder = fused_mlp.Embedder(input_dims=3, num_freqs=F, max_freq_log2=float(F - 1))
    emb = fused_mlp.positional_encoding(pts, embedder)
    assert torch.equal(emb, fused_mlp.positional_encoding(pts, embedder))
    monkeypatch.setattr(fused_mlp, "positional_encoding", lambda p, e: emb.to(p.dtype))
    ref = fused_mlp.fused_mlp_plain([w.double() for w in weights], cfg, pts.double(),
                                    dirs.double()).float()
    # the same network with every product taken the emulated way
    monkeypatch.setattr(fused_mlp, "F", types.SimpleNamespace(
        linear=linear, softplus=torch.nn.functional.softplus))
    got = fused_mlp.fused_mlp_plain(weights, cfg, pts, dirs)
    err = (got - ref).abs().max().item()
    assert ref.abs().max().item() > 1.0  # outputs of order 1: the bound is not trivial
    if within:
        assert err <= 1e-5  # 2.9e-6 seen
    else:
        assert err > 1e-4  # 3.5e-3 seen
