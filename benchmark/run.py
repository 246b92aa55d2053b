"""Run one cell of the benchmark once, on the chips of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`BENCHMARK.json`'s `workloads`) names a configuration and a
traffic mix; the traffic names its session loop (`benchmark/loops/`). The
run makes its inputs from `--seed`, builds and warms the program (set-up,
`setup_s`), measures for `--seconds`, then checks what the program
produced against the plain reference (`benchmark/reference/`). With
`--trace 0` it reports the cell's end-to-end metrics; with `--trace 1`
it profiles a stretch of the window and reports the per-layer metrics
(`benchmark/metrics/<name>.py`). The last line of standard output is one
JSON object; the numbers that decided `correct` are the last lines of
standard error and the last key of that object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ra_slam_tpu")
# CPU threads of the program's host-side torch work (the reader's resize).
# The host's cores are shared: a parallel region waits for its slowest
# thread, and idle workers spin beside the dispatching thread. One thread
# reads slower than eight but spreads less from run to run.
HOST_THREADS = 1


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Context:
    def __init__(self, cell, seed, seconds, trace, device, work):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.work = device, work
        self.setup_parts: dict = {}
        self.t_open = None

    def window_open(self):
        """The end of set-up: `setup_s` runs from process start to here."""
        self.t_open = time.perf_counter()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may bring JAX in."""
    build = ROOT / "build" / "benchmark"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    args = parse(argv)
    prepare_env()
    import torch

    torch.set_num_threads(HOST_THREADS)

    from benchmark.harness.spec import load_cell, load_module

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    result = run_cell(cell, args, torch.device("cuda:0"), load_module)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def run_cell(cell, args, device, load_module):
    """Set up, measure and check one run; the result object, or None when
    the run must print no result."""
    import torch

    from benchmark.harness import dev
    from benchmark.reference.compare import judge

    if device.type == "cuda":
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_") as work:
        ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, Path(work))
        loop = load_module("loops", cell.traffic["loop"])
        out = loop.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return None
    setup_s = ctx.t_open - T_START
    card = card_line() if device.type == "cuda" else "cpu"
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            reader = load_module("metrics", m["name"])
            v = reader.read(out, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct, table = judge(out["numbers"], cell.limits)
    device_info = {"platform": "gpu", "kind": dev.name(device), "count": cell.chips,
                   "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    tr = out.get("trace")
    if args.trace and tr is not None:
        device_info["busy_s"], device_info["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["card"] = card
    result["setup_parts_s"] = dict(ctx.setup_parts, total=setup_s)
    result["counters"] = {k: v for k, v in out["counters"].items() if not isinstance(v, list) or len(v) <= 10}
    result["check"] = table
    for name, v in out["numbers"].items():
        if name not in table:
            print(f"reading {name} {v!r}", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)
    return result


if __name__ == "__main__":
    sys.exit(main())
