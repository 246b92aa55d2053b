"""The trajectory accuracy matrix of `scripts/gen_eval.py`, through the
PyTorch port (`ra_slam_tpu_torch.eval.trajectory_bench`).

The hardened VGA scene (6 clutter boxes, 2% depth dropout, depth
quantization 0.001, +-15% exposure drift, 0.35 rad yaw sweep, 0.5% depth
noise), 150 frames: seeds 0/1/2 x loop closing on/off, then the local-BA
ablation rows on seed 0 (`ba1`: BA at every keyframe; `ba1+drop` and
`ba1+refresh`: with the post-correction observation repair). The
acceptance rule is the JAX script's: with loop closing on, no frame lost
and a closure on every seed, and a lower ATE than the same seed without.

    python3 scripts/gen_eval_torch.py --out EVAL.json [--device cuda]

Writes only --out.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HARD = dict(clutter=6, depth_dropout=0.02, depth_quant=0.001, exposure_drift=0.15, yaw_sweep=0.35)
W, H = 640, 480
SCALE = W / 320.0
N_FRAMES = 150


def matrix(run, seeds=(0, 1, 2), ablation_seeds=(0,)):
    """The rows of the matrix, through `run(tag, **kw)`."""
    for seed in seeds:
        for loop in (True, False):
            run("baseline", seed=seed, loop_closure=loop)
    # local-BA ablation (loop on; the re-association gate is angular: 8 px at 320)
    for seed in ablation_seeds:
        run("ba1", seed=seed, ba_every_kf=1)
        run("ba1+drop", seed=seed, ba_every_kf=1, reassoc_mode=1, reassoc_gate=8.0 * SCALE)
        run("ba1+refresh", seed=seed, ba_every_kf=1, reassoc_mode=2, reassoc_gate=8.0 * SCALE)


def acceptance(rows) -> bool:
    on = [r for r in rows if r["config"] == "baseline" and r["loop_closure"]]
    off = [r for r in rows if r["config"] == "baseline" and not r["loop_closure"]]
    return (all(r["lost_frames"] == 0 and r["loop_closures"] >= 1 for r in on)
            and all(a["ate_rmse_m"] < b["ate_rmse_m"] for a, b in zip(on, off)))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True, help="path of the JSON written")
    p.add_argument("--device", default="cuda")
    p.add_argument("--frames", type=int, default=N_FRAMES)
    args = p.parse_args(argv)

    from ra_slam_tpu_torch.eval.trajectory_bench import run_trajectory_eval

    t0 = time.monotonic()
    rows = []

    def run(tag, **kw):
        t = time.monotonic()
        r = run_trajectory_eval(n_frames=args.frames, width=W, height=H, scene_kw=HARD, device=args.device, **kw)
        r["config"] = tag
        r["seed"] = kw.get("seed", 0)
        rows.append(r)
        print(f"[{time.monotonic() - t0:6.0f}s] {tag} seed={r['seed']} loop={r['loop_closure']}: "
              f"ate {r['ate_rmse_m']} lost {r['lost_frames']} closures {r['loop_closures']} "
              f"({time.monotonic() - t:.0f}s)", flush=True)

    matrix(run)
    accept = acceptance(rows)
    out = {
        "description": (
            f"Trajectory eval at {W}x{H} on the hardened synthetic scene through ra_slam_tpu_torch on "
            f"{args.device}: 3 seeds x loop on/off, plus the local-BA observation-repair ablation "
            "(scripts/gen_eval.py's matrix)."
        ),
        "acceptance_pass": bool(accept),
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"acceptance_pass": accept, "n_rows": len(rows)}))
    return out


if __name__ == "__main__":
    main()
