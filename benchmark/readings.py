"""Reads the numbers that decide ``correct`` over many seeds in one
process, for setting a cell's limits: the program's sound runs, the
control (the nearest precision below the configuration's, in the program's
place) and each fault the driver plants in the program.

    python3 benchmark/readings.py --workload <name> --mode program --seeds 1 2 3 ...
    python3 benchmark/readings.py --workload <name> --mode control --seeds 1 2 3
    python3 benchmark/readings.py --workload <name> --mode half_batch --seeds 1 2 3

Each seed runs the cell's set-up and the comparison (no window) and prints
one JSON line. Needs the card, as a run does.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

import run as bench  # noqa: E402


def readings(workload: str, mode: str, seeds, root: str = BENCH, require=None):
    """Yields (seed, checks, seconds) for each seed."""
    from harness import device as devmod
    from harness import manifest

    devmod.cache_env(bench.CHECKOUT)
    wl = manifest.load(root, workload)
    (require or devmod.require_devices)(wl.chips)
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    driver = wl.driver()
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = bench.Context(workload, seed, dev, wl.config, wl.traffic, wl.cell)
        if mode == "control":
            record, inputs = driver.control_record(ctx)
        elif mode == "program":
            record, inputs = driver.finish(driver.setup(ctx))
        else:
            with driver.FAULTS[mode]():
                record, inputs = driver.finish(driver.setup(ctx))
        checks = driver.judge_run(ctx, record, inputs)
        del record, inputs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield seed, checks, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed, checks, seconds in readings(args.workload, args.mode, args.seeds):
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "checks": {k: bench._finite(v) if isinstance(v, float) else v
                                     for k, v in checks.items()},
                          "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
