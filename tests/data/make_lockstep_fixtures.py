"""Write the carried-step fixtures of tests/test_torch_lockstep.py and
tests/test_torch_cuda_slam.py: `lockstep_<row>_f<frame>.npz`.

The JAX package tracks a row of the EVAL matrix (hardened VGA scene,
seed 0; `ba1` by default: BA at every keyframe) jitted, as it runs.
At each chosen frame it keeps the state before the frame, then steps
that frame once more op by op (`jax.disable_jit()`: the JAX source's
own float32 operations, without XLA's contracted multiply-adds) and
stores what that step gives. The jitted run goes on from its own state.
Each file holds:

- `before.<path>`: the JAX `SlamState` before the frame (numpy leaves,
  keyed by their tree path: the layout `slam_state_from_numpy` reads);
- `after.<path>`: the op-by-op step's state after it (the tracker,
  landmark, keyframe and pose-graph fields the lockstep compares);
- `info.<field>` and `jit.<field>`: the op-by-op and the jitted step's
  `FrameInfo` fields; `meta.frame`, `meta.row`.

Frames: 17 (the first after the BA of a keyframe, where the jitted and
the op-by-op steps part), the first relocalization of the jitted run,
and the first keyframe with its windowed BA after it; `--frames` adds
others.

    JAX_PLATFORMS=cpu python tests/data/make_lockstep_fixtures.py [--row ba1] [--frames 61]

About 1 min of jitted tracking and 1-2 min for each op-by-op step on a
CPU.
"""

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

import lockstep_torch_jax as ls  # noqa: E402

KEEP_AFTER = ls.STATE_EXACT + tuple(k for k, _ in ls.STATE_CLOSE)


def path_of(row: str, frame: int) -> str:
    return os.path.join(HERE, f"lockstep_{row.replace('+', '_')}_f{frame:03d}.npz")


def write(row, frame, before, after, info, jit_info) -> str:
    arrays = {f"before.{k}": v for k, v in before.items()}
    arrays.update({f"after.{k}": after[k] for k in KEEP_AFTER})
    for prefix, src in (("info", info), ("jit", jit_info)):
        arrays.update({f"{prefix}.{k}": np.asarray(src[k]) for k in ls.DISCRETE + ls.CONTINUOUS + ("R", "t")})
    arrays["meta.frame"], arrays["meta.row"] = np.asarray(frame), np.asarray(row)
    path = path_of(row, frame)
    np.savez_compressed(path, **arrays)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--row", default="ba1")
    p.add_argument("--frames", default="", help="more frames, comma-separated")
    args = p.parse_args(argv)

    import jax

    from ra_slam_tpu.core.se3 import SE3

    jax.config.update("jax_platforms", "cpu")
    kw = ls.rows()[args.row]
    ds, js = ls.jax_setup(kw)
    template = js.state
    extra = {int(x) for x in args.frames.split(",") if x}
    wanted = {17} | extra
    reloc = ba_after = None
    i = 0
    while reloc is None or ba_after is None or i <= max(wanted):
        fr = ds.frame(i)
        before = ls.flat_jax(js.state)
        hint = SE3.from_matrix(jax.numpy.asarray(fr.cam_T_world)) if i == 0 else None
        jit_info = ls.jax_info(js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint))
        if reloc is None and jit_info["relocalized"]:
            reloc = i
            wanted.add(i)
        elif reloc is not None and ba_after is None and jit_info["inserted_keyframe"] and np.isfinite(
                jit_info["ba_rmse"]):
            ba_after = i
            wanted.add(i)
        if i in wanted:
            after_jit = js.state
            js.state = ls.jax_state(before, template)
            js._frames = []
            with jax.disable_jit():
                info = ls.jax_info(js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint))
            path = write(args.row, i, before, ls.flat_jax(js.state), info, jit_info)
            js.state = after_jit
            print(f"frame {i}: op by op {info['num_matches']}/{info['num_inliers']} relocalized "
                  f"{info['relocalized']}, jitted {jit_info['num_matches']}/{jit_info['num_inliers']} relocalized "
                  f"{jit_info['relocalized']} -> {path} ({os.path.getsize(path)} bytes)", flush=True)
        i += 1
        if i >= ls.ev.N_FRAMES:
            break


if __name__ == "__main__":
    main()
