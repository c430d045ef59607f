"""K2's backward as the CPU can check it: the port's plain backward against
the JAX package's VJP, the backward kernel's arithmetic in its torch
transcription against a literal one of its lanes, and the launcher's
argument checks.

- The plain backward (``fused_sample_pdf`` on CPU tensors: autograd through
  ``sampling.sample_pdf``) against ``jax.vjp`` of
  ``scade_tpu.ops.sampling.sample_pdf`` for bins, weights and draws, per-ray
  draws and one draw row broadcast to every ray, on every draw: both build
  the CDF in one order, so every bin and guard decision is the same, and
  only the gradients' own sums run in other orders (they reach the hundreds
  where a draw lands in a narrow interval). On dyadic weights rtol 1e-4 and
  an atol of 1e-6 of the largest entry; on random weights an atol of 1e-4
  of it: grad_w = (grad_pdf - d) / sum(w') is a difference of terms that
  can be far larger than itself (at M = 2 it is zero but for rounding, and
  JAX's rounding leaves up to 1.5e-5 where the weight is small). Draws
  include exactly 0 and 1, and row 1 is a row where the guard fires
  (``guard_row``). Peaked rows (98% of the weight in 3 adjacent bins) take
  the random weights' atol on dyadic weights too: there ~87 of a row's 256
  terms add into one entry, those of the few draws in the light bins in the
  hundreds, and grad_w is a difference of such sums, so the two orders
  differ by up to 1.8e-6 of the largest entry (measured, M=191).
- ``sample_pdf_backward_kernel_order`` bit for bit against a transcription of
  the kernel's loops in numpy float32 scalars, every lane and chain; and
  against the plain backward by the same bounds as above. Peaked rows
  (``test_torch_cuda.peaked``: 98% of the weight in 3 adjacent bins) too.
- The kernel's schedule of the adds (``sorted_sums``: a stable counting sort
  of each tile's terms by entry, then each owner's serial sums) bit for bit
  against the first design's (``broadcast_sums``: each draw's terms
  broadcast to the owning lane in draw order), sums and gradients, on the
  cases above, peaked rows, draws that clip to entry M-1, and S = 3, 200, 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scade_tpu.ops import sampling as jsampling
from scade_tpu_torch.ops import fused_sampling, sampling
from test_torch_cuda import backward_case, grads_close
from test_torch_sample_pdf_kernel import kernel_cdf_parts, kernel_row_sum

R, S = 64, 128
CASES = [(M, exact, draws) for M in (2, 63, 191) for exact in (True, False)
         for draws in ("per_ray", "broadcast")]
PEAKED_CASES = [(M, exact, draws) for M in (63, 191) for exact in (True, False)
                for draws in ("per_ray", "broadcast")]


def case(M, exact, draws, peak=False):
    bins, w, u, g = (torch.from_numpy(a) for a in backward_case(M, R, S, exact, peak=peak))
    if draws == "broadcast":
        u = u[:1].expand(R, S)
    return bins, w, u, g


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's VJPs of every case, once: grads of bins, weights and the draws
    (for a broadcast row, of the row)."""
    out = {}
    for key in [(*k, False) for k in CASES] + [(*k, True) for k in PEAKED_CASES]:
        bins, w, u, g = (t.numpy() for t in case(*key))
        if key[2] == "broadcast":
            def f(b, w_, row):
                return jsampling.sample_pdf(b, w_, jnp.broadcast_to(row, (R, S)))
            u = u[0]
        else:
            f = jsampling.sample_pdf
        _, vjp = jax.vjp(f, jnp.asarray(bins), jnp.asarray(w), jnp.asarray(u))
        out[key] = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(g))]
    return out


@pytest.mark.parametrize("M,exact,draws", CASES)
def test_plain_backward_matches_jax(jax_grads, M, exact, draws):
    plain_backward_matches_jax(jax_grads, M, exact, draws, False)


@pytest.mark.parametrize("M,exact,draws", PEAKED_CASES)
def test_plain_backward_matches_jax_peaked(jax_grads, M, exact, draws):
    plain_backward_matches_jax(jax_grads, M, exact, draws, True)


def plain_backward_matches_jax(jax_grads, M, exact, draws, peak):
    bins, w, u, g = case(M, exact, draws, peak)
    row = u[0].clone().requires_grad_(True) if draws == "broadcast" else None
    leaves = [bins.clone().requires_grad_(True), w.clone().requires_grad_(True),
              row if row is not None else u.clone().requires_grad_(True)]
    u_in = row.expand(R, S) if row is not None else leaves[2]
    before = fused_sampling.sample_pdf_backward_cuda.launches
    out = fused_sampling.fused_sample_pdf(leaves[0], leaves[1], u_in)
    got = torch.autograd.grad(out, leaves, g)
    assert fused_sampling.sample_pdf_backward_cuda.launches == before
    if M > 2 and draws == "per_ray":  # the guard row's narrow gaps take the guard
        cdf = sampling._cdf_from_weights(w[1])
        inds = torch.searchsorted(cdf, u[1, 5:10], right=True)
        assert ((cdf[inds] - cdf[inds - 1]) < 1e-5).all()
    grads_close(got, jax_grads[(M, exact, draws, peak)], exact and not peak)


def kernel_backward_loop(b, w, u, g, sums=None):
    """K2's backward for one row, transcribed from csrc/fused_sampling.cu lane
    by lane in numpy float32 scalars → (grad_bins, grad_w, grad_u). ``sums``
    (the draws' terms, M) → (CDF entries' sums, bins' sums) is the schedule
    of the adds; the first design's, ``broadcast_sums``, by default."""
    f = np.float32
    M, S = len(b), len(u)
    n = M - 1
    cs, pdf, s = kernel_cdf_parts(w)

    terms, gu_out = [], [f(0)] * S  # per draw: below, above and its four terms
    for j in range(S):
        uu, gj = f(u[j]), f(g[j])
        k = sum(x <= uu for x in cs)
        below, above = max(k - 1, 0), min(k, M - 1)
        cb = cs[below]
        denom = f(cs[above] - cb)
        guard = denom < f(1e-5)
        if guard:
            denom = f(1)
        tt = f(f(uu - cb) / denom)
        gu = f(f(gj * f(b[above] - b[below])) / denom)
        q = f(gu * tt)
        g_ba = f(gj * tt)
        terms.append((below, above, -gu if guard else f(q - gu), f(0) if guard else -q,
                      f(gj - g_ba), g_ba))
        gu_out[j] = gu
    gc, gb = (sums or broadcast_sums)(terms, M)

    k = (n + 15) // 16  # the reverse scan: lane b % 32's block b from its top
    gcs, off = list(gc), [f(0)] * k
    for blk in range(k):
        c = f(0)
        for i in range(min(16 * blk + 16, n) - 1, 16 * blk - 1, -1):
            c = gcs[i + 1] = f(c + gcs[i + 1])
        off[blk] = c
    e = f(0)  # lane 0: the totals chained from the last block down
    for blk in reversed(range(k)):
        off[blk], e = e, f(e + off[blk])
    g_pdf = [f(gcs[i + 1] + off[i // 16]) for i in range(n)]
    d = kernel_row_sum([f(g_pdf[i] * pdf[i]) for i in range(n)])
    g_w = [f(f(g_pdf[i] - d) / s) for i in range(n)]
    return (np.array(gb, np.float32), np.array(g_w, np.float32), np.array(gu_out, np.float32))


def broadcast_sums(terms, M):
    """The first design's adds: lane l owns the CDF entries and bins
    1 + [l L, (l+1) L) (lane 0 also bins[0]); the warp takes 32 draws at a
    time, a draw a lane, and for each of the 32 in index order every lane
    adds the broadcast terms of the entries it owns, below before above."""
    f = np.float32
    S, n = len(terms), M - 1
    L = (n + 31) // 32
    lo = [min(lane * L, n) for lane in range(32)]
    hi = [min(a + L, n) for a in lo]
    gc, gb = [f(0)] * M, [f(0)] * M
    for j0 in range(0, S, 32):
        for k in range(min(32, S - j0)):
            kb, ka, vcb, vca, vbb, vba = terms[j0 + k]
            for lane in range(32):
                own_lo = -1 if lane == 0 else lo[lane]
                if lo[lane] < kb <= hi[lane]:
                    gc[kb] = f(gc[kb] + vcb)
                if lo[lane] < ka <= hi[lane]:
                    gc[ka] = f(gc[ka] + vca)
                if own_lo < kb <= hi[lane]:
                    gb[kb] = f(gb[kb] + vbb)
                if own_lo < ka <= hi[lane]:
                    gb[ka] = f(gb[ka] + vba)
    return gc, gb


def sorted_sums(terms, M):
    """The kernel's adds, per tile of TILE draws. Term 2j is draw j's below,
    2j + 1 its above; round i gives lane l term 32 i + l. A term's rank is
    the count of its entry (the earlier rounds') plus the lanes below it in
    its match group (__match_any_sync on the entry); the last lane of the
    group then bumps the count. An exclusive scan of the counts over the
    lanes' segments of the M + 1 entries gives the list starts; each term
    goes to start + rank; lane l adds the lists of entries l, l + 32, ...
    serially onto their sums (cdf[0] takes none)."""
    f = np.float32
    S, TILE = len(terms), fused_sampling.TILE
    gc, gb = [f(0)] * M, [f(0)] * M
    for t0 in range(0, S, TILE):
        start = [0] * (M + 1)
        items = []  # (entry, rank, (cdf term, bin term)) of each lane of each round
        for i in range(TILE // 16):
            ent, val = [], []
            for lane in range(32):
                j = t0 + 16 * i + lane // 2
                if j >= S:
                    ent.append(-1)
                    val.append(None)
                    continue
                below, above, g_cb, g_ca, g_bb, g_ba = terms[j]
                ent.append(above if lane & 1 else below)
                val.append((g_ca, g_ba) if lane & 1 else (g_cb, g_bb))
            base = [start[e] if e >= 0 else 0 for e in ent]
            for lane in range(32):
                same = [x for x in range(32) if ent[x] == ent[lane]]
                items.append((ent[lane], base[lane] + sum(x < lane for x in same), val[lane]))
                if ent[lane] >= 0 and same[-1] == lane:
                    start[ent[lane]] = base[lane] + len(same)
        n1 = M + 1
        L = (n1 + 31) // 32
        lo = [min(lane * L, n1) for lane in range(32)]
        hi = [min(a + L, n1) for a in lo]
        c = [sum(start[lo[lane]:hi[lane]]) for lane in range(32)]
        for off in (1, 2, 4, 8, 16):
            c = [c[lane - off] + c[lane] if lane >= off else c[lane] for lane in range(32)]
        o = [0] + c[:-1]
        for lane in range(32):
            for i in range(lo[lane], hi[lane]):
                start[i], o[lane] = o[lane], o[lane] + start[i]
        slots = [None] * (2 * TILE)
        for e, rank, v in items:
            if e >= 0:
                assert slots[start[e] + rank] is None
                slots[start[e] + rank] = v
        for lane in range(32):
            for e in range(lane, M, 32):
                for vc, vb in slots[start[e]:start[e + 1]]:
                    if e > 0:
                        gc[e] = f(gc[e] + vc)
                    gb[e] = f(gb[e] + vb)
    return gc, gb


@pytest.mark.parametrize("M", [2, 3, 33, 34, 63, 191])
def test_backward_kernel_order_is_the_kernels_loop(M):
    """M-1 around multiples of 32 puts empty and partial segments in the last
    lanes. Rows: random weights with the edge draws, the guard row, and a
    zero row (the 1e-5 floor alone)."""
    bins, w, u, g = backward_case(M, 3, S, exact=False, seed=7)
    w[2] = 0.0
    got = fused_sampling.sample_pdf_backward_kernel_order(
        *(torch.from_numpy(a) for a in (bins, w, u, g)))
    for r in range(3):
        for a, ref in zip(got, kernel_backward_loop(bins[r], w[r], u[r], g[r])):
            np.testing.assert_array_equal(a[r].numpy(), ref)


def bits(x):
    """float32 values as their bits: tells +0 from -0."""
    return np.asarray(x, np.float32).view(np.uint32)


SCHEDULE_CASES = (
    [("uniform", M, 128) for M in (2, 3, 33, 34, 63, 191)]
    + [(rows, M, 128) for rows in ("peaked", "peaked_dyadic", "clip") for M in (63, 191)]
    + [("uniform", M, S) for M in (63, 191) for S in (3, 200, 0)])


@pytest.mark.parametrize("rows,M,S", SCHEDULE_CASES)
def test_sorted_schedule_is_the_broadcast_loop(rows, M, S):
    """The kernel's sort-then-sum schedule against the first design's
    broadcast loop, bit for bit: the entries' and bins' sums on the same
    terms, and the three gradients. Rows: random weights with the edge
    draws, the guard row and a zero row (``uniform``, as the loop's test);
    98% of the weight in 3 adjacent bins, so that most draws share 2-4
    entries (``peaked``, random or dyadic); dyadic weights, whose cdf[M-1]
    is 1 exactly, with every third draw (row 0) and every draw (row 2) at
    u = 1, so that both terms clip to entry M-1 and the guard fires
    (``clip``). S = 200 is two tiles, the second partial; S = 0 none."""
    peak = rows.startswith("peaked")
    bins, w, u, g = backward_case(M, 3, S, exact=rows in ("peaked_dyadic", "clip"), seed=7,
                                  peak=peak)
    if rows == "uniform":
        w[2] = 0.0
    if rows == "clip":
        u[0, ::3] = 1.0
        u[2] = 1.0
    for r in range(3):
        seen = []

        def spy(terms, M_):
            seen.append(terms)
            return sorted_sums(terms, M_)

        got = kernel_backward_loop(bins[r], w[r], u[r], g[r], sums=spy)
        ref = kernel_backward_loop(bins[r], w[r], u[r], g[r])
        for a, c in zip(got, ref):
            np.testing.assert_array_equal(bits(a), bits(c))
        for a, c in zip(sorted_sums(seen[0], M), broadcast_sums(seen[0], M)):
            np.testing.assert_array_equal(bits(a), bits(c))
        if rows == "clip" and r != 1:
            assert sum(t[0] == t[1] == M - 1 for t in seen[0]) >= S // 3
        if peak and r != 1:  # most draws' terms land on at most 4 entries
            counts = np.bincount([e for t in seen[0] for e in t[:2]], minlength=M)
            assert np.sort(counts)[-4:].sum() >= 0.9 * 2 * S


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("M", [63, 191])
def test_backward_kernel_order_near_plain_peaked(M, exact):
    """As test_backward_kernel_order_near_plain, on peaked rows (their bound,
    see the module docstring); and the torch transcription bit for bit the
    numpy loop on three of them."""
    bins, w, u, g = case(M, exact, "per_ray", peak=True)
    leaves = [t.clone().requires_grad_(True) for t in (bins, w, u)]
    ref = torch.autograd.grad(sampling.sample_pdf(*leaves), leaves, g)
    got = fused_sampling.sample_pdf_backward_kernel_order(bins, w, u, g)
    grads_close(got, ref, exact=False)
    for r in (0, 2, 3):
        for a, c in zip(got, kernel_backward_loop(*(t[r].numpy() for t in (bins, w, u, g)))):
            np.testing.assert_array_equal(bits(a[r].numpy()), bits(c))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("M", [2, 63, 191])
def test_backward_kernel_order_near_plain(M, exact):
    """The kernel's gradients against autograd through the plain sample_pdf,
    by the module's bounds."""
    bins, w, u, g = case(M, exact, "per_ray")
    leaves = [t.clone().requires_grad_(True) for t in (bins, w, u)]
    ref = torch.autograd.grad(sampling.sample_pdf(*leaves), leaves, g)
    got = fused_sampling.sample_pdf_backward_kernel_order(bins, w, u, g)
    grads_close(got, ref, exact)


def test_fused_backward_on_cpu_takes_the_plain_version():
    """On CPU tensors, the renderer's weights[..., 1:-1] view and a draw row
    broadcast with row stride 0: the Function's gradients are autograd's
    through the plain sample_pdf of contiguous copies, bit for bit, with no
    launch."""
    bins, w, u, g = (torch.from_numpy(a) for a in backward_case(191, 8, 32, exact=False))
    full = torch.nn.functional.pad(w, (1, 1), value=5.0).requires_grad_(True)
    row = u[0].clone().requires_grad_(True)
    before = fused_sampling.sample_pdf_backward_cuda.launches
    out = fused_sampling.fused_sample_pdf(bins, full[:, 1:-1], row.expand(8, 32))
    got = torch.autograd.grad(out, [full, row], g)
    assert fused_sampling.sample_pdf_backward_cuda.launches == before
    w2, row2 = w.clone().requires_grad_(True), u[0].clone().requires_grad_(True)
    ref = torch.autograd.grad(sampling.sample_pdf(bins, w2, row2.expand(8, 32).contiguous()),
                              [w2, row2], g)
    assert torch.equal(got[0][:, 1:-1], ref[0]) and not got[0][:, [0, -1]].any()
    assert torch.equal(got[1], ref[1])


def refused(case_name):
    bins, w, u, g = (torch.from_numpy(a) for a in backward_case(63, 4, 8, exact=False))
    if case_name == "2-D":
        g = g[None]
    elif case_name == "shapes":
        g = g[:, :5]
    elif case_name == "float32":
        g = g.double()
    elif case_name == "inner stride":
        g = g.repeat_interleave(2, -1)[:, ::2]
    elif case_name == "at least 2":
        bins, w = bins[:, :1], w[:, :0]
    return bins, w, u, g


@pytest.mark.parametrize("case_name", ["CUDA", "2-D", "shapes", "float32", "inner stride",
                                       "at least 2"])
def test_sample_pdf_backward_cuda_refuses(case_name):
    """The backward launcher refuses what its kernel does not take: wrong
    dims, a g of another shape, a non-f32 tensor, inner stride != 1, CPU
    tensors, M < 2 (every check before the device's shows on CPU tensors)."""
    with pytest.raises(ValueError, match=case_name):
        fused_sampling.sample_pdf_backward_cuda(*refused(case_name))
