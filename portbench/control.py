"""Readings on the chip that a cell's limits are set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

For each seed, as a run does, builds and calibrates the cell, serves one
burst (the window's first, at the cell's load), frees the port's state and
prints one line: every number ``check`` compares for the port, the same
numbers on the reference for the float8 control (``check``'s module
docstring), the burst's threshold, the share escalated and the burst's wall
time. Where memory is short, give one seed a process.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import bench
from portbench.cell import System, correctness, serve_window
from portbench.record import Record
from portbench.recorder import Recorder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = bench.cell(bench.load(), args.workload)
    device = torch.device("cuda", 0)
    for seed in seeds:
        t0 = time.perf_counter()
        system = System(cell, seed, device)
        system.warm(seed)
        system.calibrate(seed)
        recorder = Recorder(system.engines)
        setup_s = time.perf_counter() - t0
        serve_window(system, seed, 0.0, recorder)
        b = recorder.bursts[0]
        row = {"seed": seed, "setup_s": setup_s,
               "burst_s": b.t_end - b.t_sub,
               "steps": max(c.step for c in b.calls) + 1,
               "escalated": sum(r.hops > 0 for r in b.results.values()),
               "requests": len(b.results),
               "threshold": b.thresholds[0]}
        rec = Record(system.models, system.names, cell.traffic, recorder,
                     setup_s, 0.0)
        recorder.detach()
        system.free()
        row.update(correctness(system, rec, seed, control=True))
        print(json.dumps(row), flush=True)
        del system, recorder
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
