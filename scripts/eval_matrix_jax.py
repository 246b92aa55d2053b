"""The trajectory matrix of `scripts/gen_eval.py` through the JAX
package as it stands, written to a path of the caller's choosing (the
round-5 script writes `EVAL_r05.json` in place). The rows, settings and
acceptance rule are `scripts/gen_eval_torch.py`'s, so that the JAX
package's rows and the port's can be set side by side.

    python3 scripts/eval_matrix_jax.py --out EVAL_jax.json [--rows 0,1]

`--rows` runs only those rows of the matrix (indices in its order:
seeds 0/1/2 x loop on/off, then ba1, ba1+drop, ba1+refresh), so that
parts can run in separate processes. Writes only --out.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gen_eval_torch as ev  # noqa: E402


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--rows", default=None, help="comma-separated row indices (default: all)")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from ra_slam_tpu.eval.trajectory_bench import run_trajectory_eval

    plan = []
    ev.matrix(lambda tag, **kw: plan.append((tag, kw)))
    keep = set(range(len(plan))) if args.rows is None else {int(i) for i in args.rows.split(",")}
    rows, t0 = [], time.monotonic()
    for i, (tag, kw) in enumerate(plan):
        if i not in keep:
            continue
        r = run_trajectory_eval(n_frames=ev.N_FRAMES, width=ev.W, height=ev.H, scene_kw=ev.HARD, **kw)
        r.update(config=tag, seed=kw.get("seed", 0), row=i)
        rows.append(r)
        print(f"[{time.monotonic() - t0:6.0f}s] row {i} {tag} seed={r['seed']} loop={r['loop_closure']}: "
              f"ate {r['ate_rmse_m']} lost {r['lost_frames']} closures {r['loop_closures']}", flush=True)
    out = {"description": "scripts/gen_eval.py's matrix through the JAX package (CPU backend)",
           "acceptance_pass": bool(ev.acceptance(rows)) if keep == set(range(len(plan))) else None,
           "rows": rows}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
