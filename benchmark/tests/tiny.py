"""A copy of the benchmark at tiny sizes in a temporary folder, for CPU
runs of the whole harness with its look for a card skipped."""

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "scade-scannet": dict(H=12, W=16, n_train=3, n_val=1, netwidth=32, netwidth_fine=32,
                          multires=4, N_samples=8, N_importance=16, N_rand=32,
                          num_hypothesis=2, i_print=2),
    "leres-cimle-rx101": dict(layers=[1, 1, 1, 1], d_latent=8, image_size=64, raw_H=48,
                              raw_W=64, views=5, batchsize=2, num_samples=4,
                              mini_batch_size=2),
}
TRAFFIC = {"trace_warm_steps": 1, "trace_steps": 2}
# a view of 12 x 16 rays in three chunks
CHUNKS = {"nerf-render-views.json": {"chunk": 64}}


def tiny_copy(tmp: str) -> str:
    """The benchmark's folder copied under ``tmp`` with tiny configurations
    and short traces, its manifest beside it; returns the copy's root."""
    root = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), tmp)
    for name, over in TINY.items():
        path = os.path.join(root, "configs", f"{name}.json")
        with open(path) as fp:
            config = json.load(fp)
        config.update(over)
        with open(path, "w") as fp:
            json.dump(config, fp)
    for name in os.listdir(os.path.join(root, "traffic")):
        path = os.path.join(root, "traffic", name)
        with open(path) as fp:
            traffic = json.load(fp)
        traffic.update(TRAFFIC, **CHUNKS.get(name, {}))
        with open(path, "w") as fp:
            json.dump(traffic, fp)
    return root
