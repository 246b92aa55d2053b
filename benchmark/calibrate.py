"""Readings that the limits of `correct` are set from (`benchmark/checks/`).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --frames 400

For each seed it makes the cell's inputs, puts the control in the
program's place (the plain reference at the precision below the one the
configuration states: `control_session` of the cell's loop) for the first
`--frames` frames of a session, and compares it with the reference as a
run compares the program. It prints one JSON line of numbers a seed. The
program's own readings are those its runs print (`benchmark/run.py`).
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(cell, seed: int, frames: int, device) -> dict:
    from benchmark.harness.spec import load_module

    return load_module("loops", cell.traffic["loop"]).control(cell, seed, frames, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        nums = control_numbers(cell, seed, args.frames, torch.device("cuda:0"))
        print(json.dumps({"workload": args.workload, "control": True, "seed": seed, "frames": args.frames,
                          "seconds": time.perf_counter() - t, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
