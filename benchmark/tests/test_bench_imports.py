"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole, so the port ``scade_tpu_torch`` is allowed), and its plain
references not the port either."""

import json
import os
import subprocess
import sys

from conftest import BENCH

CHECKOUT = os.path.dirname(BENCH)


def _top_modules(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{CHECKOUT!r}, {BENCH!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_its_drivers_load_no_jax():
    code = """
import run
from harness import manifest
for w in ("scannet-train", "prior-step", "scannet-render"):
    wl = manifest.load(run.BENCH, w)
    wl.driver(); wl.counts()
    [wl.metric_reader(m["name"]) for m in wl.per_layer]
import readings
"""
    tops = _top_modules(code)
    assert "scade_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "scade_tpu"}


def test_references_load_neither_jax_nor_the_port():
    tops = _top_modules("import reference.nerf, reference.nerf_render, reference.prior")
    assert not tops & {"jax", "jaxlib", "flax", "scade_tpu", "scade_tpu_torch"}
