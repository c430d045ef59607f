#!/usr/bin/env python3
"""The port's sample_pdf against the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/sample_pdf_vs_jax.py [--rows 2048] [--seed 0]

For each width the port runs (M = 31, 63, 95, 191) and three kinds of rows
(opaque with totals 1.0 and 0.999: 5 adjacent bins hold a Dirichlet draw,
every other bin 0; and uniform random weights), S = 128 draws and an
upstream gradient g ~ N(0, 1), prints one JSON line: the share of CDF
entries bit-equal to ``scade_tpu.ops.sampling._cdf_from_weights``, the
share of empty bins (opaque rows) whose 1e-5-guard decision differs, the
share of draws bit-equal to JAX's (op by op), and the weights' gradient's
relative L2 distance from ``jax.vjp`` (jitted) for the plain backward and
for ``sample_pdf_backward_kernel_order``. Run from the root of a tree; it
measures that tree's ``scade_tpu_torch``.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scade_tpu.ops import sampling as jsampling  # noqa: E402
from scade_tpu_torch.ops import fused_sampling, sampling  # noqa: E402


def opaque(rng, R, n, total):
    at = rng.integers(0, n - 4, R)
    w = np.zeros((R, n), np.float32)
    for r in range(R):
        w[r, at[r]:at[r] + 5] = rng.dirichlet(np.ones(5)) * total
    return w


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    R, S = args.rows, 128

    @jax.jit
    def grad_w(bins, w, u, g):
        return jax.vjp(lambda w_: jsampling.sample_pdf(bins, w_, u), w)[1](g)[0]

    out = {}
    for M in (31, 63, 95, 191):
        n = M - 1
        for kind in ("opaque1.0", "opaque0.999", "uniform"):
            rng = np.random.default_rng(args.seed + M)
            bins = (0.5 + np.cumsum(rng.uniform(0.005, 0.06, (R, M)), -1)).astype(np.float32)
            w = (rng.uniform(0, 1, (R, n)).astype(np.float32) if kind == "uniform"
                 else opaque(rng, R, n, float(kind[6:])))
            u = rng.uniform(0, 1, (R, S)).astype(np.float32)
            g = rng.standard_normal((R, S)).astype(np.float32)
            ref_cdf = np.asarray(jsampling._cdf_from_weights(jnp.asarray(w)))
            tb, tw, tu, tg = map(torch.from_numpy, (bins, w, u, g))
            cdf = sampling._cdf_from_weights(tw).numpy()
            res = dict(cdf_bit_equal=float((cdf == ref_cdf).mean()))
            if kind != "uniform":
                empty = w == 0
                fires = [np.diff(c, axis=-1)[empty] < np.float32(1e-5) for c in (cdf, ref_cdf)]
                res.update(guard_fires_jax=float(fires[1].mean()),
                           guard_differs=float((fires[0] != fires[1]).mean()))
            draws = sampling.sample_pdf(tb, tw, tu).numpy()
            ref_draws = np.asarray(jsampling.sample_pdf(*map(jnp.asarray, (bins, w, u))))
            ref_g = np.asarray(grad_w(bins, w, u, g))
            wl = tw.clone().requires_grad_(True)
            plain = torch.autograd.grad(fused_sampling.fused_sample_pdf(tb, wl, tu), wl, tg)[0]
            kernel = fused_sampling.sample_pdf_backward_kernel_order(tb, tw, tu, tg)[1]
            res.update(draws_bit_equal=float((draws == ref_draws).mean()),
                       grad_w_rel_l2_plain=rel_l2(plain, ref_g),
                       grad_w_rel_l2_kernel_order=rel_l2(kernel, ref_g))
            out[f"M{M}_{kind}"] = res
    print(json.dumps(dict(rows=R, draws=S, seed=args.seed, results=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
