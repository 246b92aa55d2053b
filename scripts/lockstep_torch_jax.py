"""Frame-by-frame lockstep of the port's SLAM system against the JAX
package's, on a row of the EVAL matrix (`scripts/gen_eval_torch.py`),
both on the CPU. It needs both packages, so it runs where JAX is
installed, never on a machine with the port alone.

    python3 scripts/lockstep_torch_jax.py --mode free --row ba1 --out runs/ls
    python3 scripts/lockstep_torch_jax.py --mode free-op-by-op --row ba1 --out runs/ls_obo
    python3 scripts/lockstep_torch_jax.py --mode carried --row ba1 --out runs/ls --frames 0-74
    python3 scripts/lockstep_torch_jax.py --mode explain [--op-by-op] --row ba1 --out runs/ls --frames 17,67
    python3 scripts/lockstep_torch_jax.py --mode traces --row ba1 --out runs/ls --traces traces.json

Rows: `ba1` (BA at every keyframe, seed 0; the default), `ba1+drop`,
`ba1+refresh`, `baseline` (seed 0, loop closing on) and
`baseline-loop-off`. Both packages track the frames of the JAX
package's `SyntheticBoxDataset`, checked equal to the port's.

`free`: each system from its own state, the JAX one jitted as the JAX
package runs it. Per frame the `FrameInfo` fields of both and the pose
gap; the first frame at which a discrete field parts, each package's
first relocalization, the gap's growth across each BA step, each row's
ATE. It saves the JAX `SlamState` before every frame (and after the
last), numpy leaves keyed by their tree path, under
`<out>/<row>/states/`. `free-op-by-op`: the JAX package alone, op by op
(`jax.disable_jit()`: its source's own float32 operations; XLA's CPU
backend contracts multiply-adds under jit), its states saved alike.

`carried`: for each frame i (`--frames a-b`, or a list) the port's state
is built from the saved JAX state before i and stepped once through
`SlamSystem.feed_rgbd_frame`, and held to the jitted JAX step from the
same state (checked to repeat the free run's bits): discrete fields
exactly, the tracker pose and keyframe poses within 1e-5, landmarks
2e-5, stored pixels 1e-3, the BA rmse 1e-4 (tests/test_torch_slam_ba.py's
bounds). Where it parts, JAX steps the frame again op by op (the
referee), and where that parts too, op by op on the port's own
keypoints, with the ORB and loop-verification quantities that part and
their margins. A frame is `jit`, `op_by_op` (the referee only),
`orb_op_by_op` (only on the port's keypoints) or `fault`. Frames are
independent once the states are saved, so a sweep splits over processes
(each writes `carried_<a>-<b>.json`).

`explain`: for each frame, the first decision that parts from the jitted
(or, `--op-by-op`, the op-by-op) JAX step and its margin: the keypoints
(FAST scores, their non-maximum-suppression neighbours, BRIEF pairs),
then the tracker's stages from one set of keypoints (matches with their
gate distances, the GN poses and the first solve's conditioning,
inliers with their residuals against the gate).

`traces`: the discrete traces (a few integers a frame) and the rows of a
row's free runs (`free.json`, and `free_op_by_op.json` where present in
the same directory) merged into `--traces`; `chip_smoke.py` phase 20c
compares the card with them.

On an 8-core CPU at VGA the port takes ~11-13 s a frame, jitted JAX
~0.5 s, JAX op by op ~5 s once warm (its first frame ~2 min). Writes
only under --out (and --traces).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gen_eval_torch as ev  # noqa: E402

DISCRETE = ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized",
            "loop_cand", "loop_inliers", "loop_closed", "ba_dropped")
CONTINUOUS = ("ba_rmse", "ba_shift", "track_rmse")
# tests/test_torch_slam_ba.py:42-45
POSE_TOL, POINT_TOL, UV_TOL, RMSE_TOL = 1e-5, 2e-5, 1e-3, 1e-4
# integer and flag fields of the state, held exactly
STATE_EXACT = (
    "track.kf_counter", "track.frames_since_kf", "track.initialized", "track.lost", "track.bad_streak",
    "track.lms.valid", "track.lms.n_obs", "track.lms.last_seen", "track.lms.anchor", "track.lms.desc",
    "kfs.valid", "kfs.frame_id", "kfs.obs_lm", "kfs.obs_w", "kfs.desc",
    "edges.i", "edges.j", "n_edges", "n_loops", "n_relocs", "loop_prev_cand", "loop_streak", "n_frames",
    "fs_ref", "fs_tracked",
)
STATE_CLOSE = (
    ("track.pose.R", POSE_TOL), ("track.pose.t", POSE_TOL), ("track.last_kf_pose.R", POSE_TOL),
    ("track.last_kf_pose.t", POSE_TOL), ("track.velocity", POSE_TOL), ("track.lms.pos", POINT_TOL),
    ("kfs.R", POSE_TOL), ("kfs.t", POSE_TOL), ("kfs.obs_uv", UV_TOL), ("kfs.obs_z", POINT_TOL),
    ("edges.t", POSE_TOL), ("edges.R", POSE_TOL), ("edges.weight", 0.0), ("kfs.embed", POSE_TOL),
    ("kfs.timestamp", 0.0), ("fs_relR", POSE_TOL), ("fs_relt", POSE_TOL),
)


def rows() -> dict:
    """Name -> keyword arguments of the rows this harness runs."""
    out = {}

    def run(tag, **kw):
        if tag == "baseline" and not kw.get("loop_closure", True):
            tag = "baseline-loop-off"
        out[tag] = kw

    ev.matrix(run, seeds=(0,), ablation_seeds=(0,))
    return out


def frame_list(spec: str | None, n: int) -> list:
    if not spec:
        return list(range(n))
    if "-" in spec and "," not in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(x) for x in spec.split(",")]


# ----------------------------------------------------------------- set-up

def jax_dataset(seed: int):
    """The JAX package's hardened VGA scene, as its trajectory bench makes it."""
    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    spec = SyntheticCameraSpec(fx=ev.W / 2.0, fy=ev.W / 2.0, cx=ev.W / 2 - 0.5, cy=ev.H / 2 - 0.5,
                               width=ev.W, height=ev.H)
    return SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, seed=seed, **ev.HARD)


def jax_setup(kw: dict):
    """(dataset, jitted SlamSystem) of the JAX package, built as
    `ra_slam_tpu.eval.trajectory_bench.run_trajectory_eval` builds them."""
    from ra_slam_tpu.core.config import FeatureConfig, TrackingConfig
    from ra_slam_tpu.slam.system import SlamSystem

    kw = dict(kw)
    seed, loop = kw.pop("seed", 0), kw.pop("loop_closure", True)
    s = ev.W / 320.0
    ds = jax_dataset(seed)
    slam = SlamSystem(
        ds.camera, fcfg=FeatureConfig(max_num_keypoints=600, num_levels=4),
        tcfg=TrackingConfig(min_inliers=15, match_radius=30.0).scaled(s),
        ba_window=6, ba_max_points=2048, ba_iterations=5, loop_every_kf=1, loop_min_inliers=20,
        loop_min_gap=15 if loop else 10**6, loop_max_rmse=3.0 * s, reloc_max_rmse=3.0 * s, **kw,
    )
    return ds, slam


def port_setup(kw: dict):
    """(dataset, SlamSystem on the CPU) of the port's bench."""
    from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup

    kw = dict(kw)
    seed, loop = kw.pop("seed", 0), kw.pop("loop_closure", True)
    return tracking_setup(ev.W, ev.H, 0.005, seed, ev.HARD, "cpu", loop, **kw)


def checked_frame(jds, tds, i: int):
    """Frame i of the JAX dataset, asserted equal to the port's."""
    a, b = jds.frame(i), tds.frame(i)
    for name in ("rgb", "depth", "cam_T_world"):
        if not np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name))):
            raise AssertionError(f"frame {i}: the datasets' {name} differ")
    assert a.timestamp == b.timestamp
    return a


# ---------------------------------------------------------------- states

def flat_jax(state) -> dict:
    """The JAX state as {dotted path: numpy leaf}."""
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves}


def flat_port(state) -> dict:
    from ra_slam_tpu_torch.utils.convert import slam_state_to_numpy

    out = {}

    def walk(ns, prefix):
        for k, v in vars(ns).items():
            if isinstance(v, SimpleNamespace):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = np.asarray(v)

    walk(slam_state_to_numpy(state), "")
    return out


def nested(flat: dict) -> SimpleNamespace:
    """{dotted path: leaf} -> nested SimpleNamespace (the layout
    `slam_state_from_numpy` reads)."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    return ns(root)


def save_state(path: str, flat: dict) -> None:
    np.savez_compressed(path, **flat)


def load_state(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def jax_state(flat: dict, template):
    """A JAX SlamState with the leaves of `flat`, in `template`'s tree."""
    import jax
    import jax.numpy as jnp

    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    vals = [jnp.asarray(flat[jax.tree_util.keystr(p).lstrip(".")]) for p, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, vals)


# ----------------------------------------------------------------- infos

def jax_info(info) -> dict:
    h = info._pull()
    out = {k: int(getattr(h, k)) for k in DISCRETE}
    out.update({k: float(getattr(h, k)) for k in CONTINUOUS})
    out["R"], out["t"] = np.asarray(h.R).tolist(), np.asarray(h.t).tolist()
    return out


def port_info(info) -> dict:
    out = {k: int(getattr(info, k)) for k in DISCRETE}
    out.update({k: float(getattr(info, k)) for k in CONTINUOUS})
    out["R"], out["t"] = info.pose.R.numpy().tolist(), info.pose.t.numpy().tolist()
    return out


def pose_gap(a: dict, b: dict) -> tuple:
    """(|t_a - t_b| in m, max |R_a - R_b|)."""
    return (float(np.linalg.norm(np.subtract(a["t"], b["t"]))),
            float(np.abs(np.subtract(a["R"], b["R"])).max()))


def _nan_close(x, y, tol) -> bool:
    return (np.isnan(x) and np.isnan(y)) or abs(x - y) <= tol


def compare(port_flat: dict, pinfo: dict, ref_flat: dict, rinfo: dict) -> list:
    """What parts between the port's step and a reference step: a list
    of (quantity, difference, bound); empty where they agree."""
    bad = []
    for k in DISCRETE:
        if pinfo[k] != rinfo[k]:
            bad.append((f"info.{k}", f"{pinfo[k]} vs {rinfo[k]}", "exact"))
    for k, tol in (("ba_rmse", RMSE_TOL), ("ba_shift", POSE_TOL)):
        if not _nan_close(pinfo[k], rinfo[k], tol):
            bad.append((f"info.{k}", abs(pinfo[k] - rinfo[k]), tol))
    for k in STATE_EXACT:
        a, b = port_flat[k], ref_flat[k]
        if a.dtype != b.dtype and a.itemsize == b.itemsize:  # int32 words against uint32
            a = a.view(b.dtype)
        if not np.array_equal(a, b):
            bad.append((k, f"{int(np.sum(a != b))} entries differ", "exact"))
    for k, tol in STATE_CLOSE:
        d = float(np.abs(port_flat[k].astype(np.float64) - ref_flat[k].astype(np.float64)).max()) \
            if port_flat[k].size else 0.0
        if not d <= tol:
            bad.append((k, d, tol))
    return bad


# ------------------------------------------------------------------ modes

def run_free(name, kw, out_dir, n_frames):
    import jax
    import torch

    from ra_slam_tpu.core.se3 import SE3 as JSE3
    from ra_slam_tpu_torch.core.se3 import SE3 as TSE3

    jds, js = jax_setup(kw)
    tds, ts = port_setup(kw)
    sdir = os.path.join(out_dir, "states")
    os.makedirs(sdir, exist_ok=True)
    frames, t0 = [], time.monotonic()
    for i in range(n_frames):
        fr = checked_frame(jds, tds, i)
        save_state(os.path.join(sdir, f"f{i:04d}.npz"), flat_jax(js.state))
        jh = JSE3.from_matrix(jax.numpy.asarray(fr.cam_T_world)) if i == 0 else None
        th = TSE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        tj = time.monotonic()
        ji = jax_info(js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=jh))
        tp = time.monotonic()
        pi = port_info(ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=th))
        te = time.monotonic()
        gt, gr = pose_gap(ji, pi)
        split = [k for k in DISCRETE if ji[k] != pi[k]]
        frames.append({"frame": i, "jax": ji, "port": pi, "gap_t": gt, "gap_R": gr, "split": split,
                       "jax_s": tp - tj, "port_s": te - tp})
        print(f"[{time.monotonic() - t0:6.0f}s] {name} frame {i}: jax {ji['num_matches']}/{ji['num_inliers']} "
              f"port {pi['num_matches']}/{pi['num_inliers']} gap {gt:.2e} m"
              + (f" SPLIT {split}" if split else ""), flush=True)
    save_state(os.path.join(sdir, f"f{n_frames:04d}.npz"), flat_jax(js.state))
    from ra_slam_tpu.eval.ate import ate_rmse as jax_ate
    from ra_slam_tpu_torch.eval.ate import ate_rmse as port_ate

    gt = [(i, np.asarray(jds.frame(i).cam_T_world)[:3, :4]) for i in range(n_frames)]
    summary = summarize(frames)
    summary["ate_rmse_m"] = {"jax": float(jax_ate(js.trajectory(), gt)["ate_rmse"]),
                             "port": float(port_ate(ts.trajectory(), gt)["ate_rmse"])}
    summary.update(row=name, kw=kw, n_frames=n_frames, seconds=time.monotonic() - t0,
                   jax_relocalizations=int(js.num_relocalizations), port_relocalizations=int(ts.num_relocalizations),
                   jax_keyframes=int(js.state.track.kf_counter), port_keyframes=int(ts.state.track.kf_counter))
    out = {"summary": summary, "frames": frames}
    with open(os.path.join(out_dir, "free.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary))
    return out


def run_free_op_by_op(name, kw, out_dir, n_frames):
    """The JAX package alone, free-running op by op (`jax.disable_jit()`):
    the reference's own float32 operations over the whole row."""
    import jax

    from ra_slam_tpu.core.se3 import SE3 as JSE3
    from ra_slam_tpu.eval.ate import ate_rmse as jax_ate

    jds, js = jax_setup(kw)
    sdir = os.path.join(out_dir, "states")
    os.makedirs(sdir, exist_ok=True)
    frames, gt, t0 = [], [], time.monotonic()
    with jax.disable_jit():
        for i in range(n_frames):
            fr = jds.frame(i)
            save_state(os.path.join(sdir, f"f{i:04d}.npz"), flat_jax(js.state))
            jh = JSE3.from_matrix(jax.numpy.asarray(fr.cam_T_world)) if i == 0 else None
            frames.append({"frame": i, "jax": jax_info(js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i,
                                                                          pose_hint=jh))})
            gt.append((i, np.asarray(fr.cam_T_world)[:3, :4]))
            f = frames[-1]["jax"]
            print(f"[{time.monotonic() - t0:6.0f}s] {name} frame {i} op by op: {f['num_matches']}/{f['num_inliers']}"
                  f" tracked {f['tracked']} relocalized {f['relocalized']}", flush=True)
        traj = js.trajectory()
    save_state(os.path.join(sdir, f"f{n_frames:04d}.npz"), flat_jax(js.state))
    summary = {"row": name, "kw": kw, "n_frames": n_frames, "seconds": time.monotonic() - t0,
               "ate_rmse_m": float(jax_ate(traj, gt)["ate_rmse"]),
               "lost": sum(not f["jax"]["tracked"] for f in frames),
               "relocalizations": int(js.num_relocalizations), "keyframes": int(js.state.track.kf_counter),
               "loop_closures": int(js.num_loop_closures)}
    out = {"summary": summary, "frames": frames}
    with open(os.path.join(out_dir, "free_op_by_op.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary))
    return out


def summarize(frames) -> dict:
    first_split = next((f["frame"] for f in frames if f["split"]), None)
    first_reloc = {p: next((f["frame"] for f in frames if f[p]["relocalized"]), None) for p in ("jax", "port")}
    first_lost = {p: next((f["frame"] for f in frames if not f[p]["tracked"]), None) for p in ("jax", "port")}
    growth = []
    for a, b in zip(frames, frames[1:]):
        if a["jax"]["inserted_keyframe"] and np.isfinite(a["jax"]["ba_rmse"]) and a["gap_t"] > 0:
            growth.append({"keyframe_frame": a["frame"], "gap": a["gap_t"], "next_gap": b["gap_t"],
                           "factor": b["gap_t"] / a["gap_t"]})
    return {"first_split": first_split, "first_reloc": first_reloc, "first_lost": first_lost,
            "split_frames": [f["frame"] for f in frames if f["split"]],
            "lost": {p: sum(not f[p]["tracked"] for f in frames) for p in ("jax", "port")},
            "relocs": {p: sum(f[p]["relocalized"] for f in frames) for p in ("jax", "port")},
            "ba_growth": growth}


TRACE_KEYS = ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized", "loop_closed")


def write_traces(path, name, free, op_by_op=None) -> None:
    """Merge a free run's two discrete traces (one list of TRACE_KEYS a
    frame) and rows (ATE, lost frames, relocalizations, keyframes,
    closures), and the JAX package's op-by-op run's where given, into
    the JSON at `path`."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.setdefault("keys", list(TRACE_KEYS))
    frames, s = free["frames"], free["summary"]
    row = {"summary": {}}
    for side, p in (("jax_jit_cpu", "jax"), ("port_cpu", "port")):
        row[side] = [[int(f[p][k]) for k in TRACE_KEYS] for f in frames]
        row["summary"][side] = {
            "ate_rmse_m": round(s["ate_rmse_m"][p], 4), "lost_frames": s["lost"][p],
            "relocalizations": s[f"{p}_relocalizations"], "keyframes": s[f"{p}_keyframes"],
            "loop_closures": sum(f[p]["loop_closed"] for f in frames)}
    if op_by_op is not None:
        s = op_by_op["summary"]
        row["jax_op_by_op_cpu"] = [[int(f["jax"][k]) for k in TRACE_KEYS] for f in op_by_op["frames"]]
        row["summary"]["jax_op_by_op_cpu"] = {
            "ate_rmse_m": round(s["ate_rmse_m"], 4), "lost_frames": s["lost"], "relocalizations": s["relocalizations"],
            "keyframes": s["keyframes"], "loop_closures": s["loop_closures"]}
    data.setdefault("rows", {})[name] = row
    with open(path, "w") as f:
        json.dump(data, f, separators=(",", ":"))


class Stepper:
    """Steps one frame from a saved JAX state: the port on the CPU, the
    JAX package jitted or op by op."""

    def __init__(self, kw):
        self.jds, self.js = jax_setup(kw)
        self.tds, self.ts = port_setup(kw)
        self._template = self.js.state

    def frame(self, i):
        return checked_frame(self.jds, self.tds, i)

    def port(self, flat_before, i, fr):
        import torch

        from ra_slam_tpu_torch.core.se3 import SE3 as TSE3
        from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy

        self.ts.state = slam_state_from_numpy(nested(flat_before), "cpu")
        self.ts._frames = []
        th = TSE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        info = port_info(self.ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=th))
        return flat_port(self.ts.state), info

    def jax(self, flat_before, i, fr, jit=True):
        """The JAX package's step of frame i: jitted (the program the
        free run ran: the same bits as its step), or op by op."""
        import contextlib

        import jax

        from ra_slam_tpu.core.se3 import SE3 as JSE3

        self.js.state = jax_state(flat_before, self._template)
        self.js._frames = []
        with contextlib.nullcontext() if jit else jax.disable_jit():
            jh = JSE3.from_matrix(jax.numpy.asarray(fr.cam_T_world)) if i == 0 else None
            info = jax_info(self.js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=jh))
        return flat_jax(self.js.state), info

    def jax_op_by_op_on_port_keypoints(self, flat_before, i, fr):
        """The JAX step op by op, fed the port's ORB keypoints of the
        frame: everything after detection, held apart from it."""
        import jax
        import jax.numpy as jnp
        import torch

        from ra_slam_tpu.core.se3 import SE3 as JSE3
        from ra_slam_tpu.features.orb import Keypoints as JKP
        from ra_slam_tpu_torch.features.orb import detect_and_describe
        from ra_slam_tpu_torch.features.pyramid import rgb_to_gray

        kt = detect_and_describe(rgb_to_gray(torch.as_tensor(fr.rgb)), self.ts.fcfg)
        kp = JKP(**{f: jnp.asarray(getattr(kt, f).numpy().view(np.uint32) if f == "desc" else getattr(kt, f).numpy())
                    for f in JKP._fields})
        self.js.state = jax_state(flat_before, self._template)
        self.js._frames = []
        with jax.disable_jit():
            jh = JSE3.from_matrix(jnp.asarray(fr.cam_T_world)) if i == 0 else None
            info = jax_info(self.js._feed(kp, jnp.asarray(fr.depth, jnp.float32), fr.timestamp, i, jh))
        return flat_jax(self.js.state), info


def _fmt(bad) -> list:
    return [[k, d if isinstance(d, str) else float(d), t] for k, d, t in bad]


def run_carried(name, kw, out_dir, frames):
    sdir = os.path.join(out_dir, "states")
    st = Stepper(kw)
    results, t0 = [], time.monotonic()
    for i in frames:
        fr = st.frame(i)
        before = load_state(os.path.join(sdir, f"f{i:04d}.npz"))
        after, jinfo = st.jax(before, i, fr)
        nxt = os.path.join(sdir, f"f{i + 1:04d}.npz")
        # the jitted step again from the saved state: the free run's bits
        same = all(np.array_equal(v, after[k], equal_nan=v.dtype.kind == "f")
                   for k, v in load_state(nxt).items()) if os.path.exists(nxt) else None
        tp = time.monotonic()
        pflat, pinfo = st.port(before, i, fr)
        port_s = time.monotonic() - tp
        bad = compare(pflat, pinfo, after, jinfo)
        r = {"frame": i, "port_s": port_s, "port": {k: pinfo[k] for k in DISCRETE + CONTINUOUS},
             "jax_jit": {k: jinfo[k] for k in DISCRETE + CONTINUOUS}, "vs_jit": _fmt(bad),
             "pose_vs_jit": pose_gap(pinfo, jinfo), "jit_repeats_free_run": same}
        verdict = "jit"
        if bad:
            tr = time.monotonic()
            rflat, rinfo = st.jax(before, i, fr, jit=False)
            r["referee_s"] = time.monotonic() - tr
            rbad = compare(pflat, pinfo, rflat, rinfo)
            r["jax_op_by_op"] = {k: rinfo[k] for k in DISCRETE + CONTINUOUS}
            r["vs_op_by_op"] = _fmt(rbad)
            r["pose_vs_op_by_op"] = pose_gap(pinfo, rinfo)
            # how far XLA's jit moved the reference's own step
            r["jit_vs_op_by_op"] = _fmt(compare(rflat, rinfo, after, jinfo))
            verdict = "op_by_op" if not rbad else "fault"
            if rbad:
                # the step after detection, from the port's keypoints in both
                sflat, sinfo = st.jax_op_by_op_on_port_keypoints(before, i, fr)
                r["vs_op_by_op_same_keypoints"] = _fmt(compare(pflat, pinfo, sflat, sinfo))
                r["orb_vs_op_by_op"] = orb_compare(fr.rgb, st.ts.fcfg, jit=False)
                if not r["vs_op_by_op_same_keypoints"]:
                    verdict = "orb_op_by_op"
                elif any(b[0].startswith("info.loop") for b in r["vs_op_by_op_same_keypoints"]):
                    r["loop_verify"] = loop_verify_compare(st, sflat)
        r["verdict"] = verdict
        results.append(r)
        print(f"[{time.monotonic() - t0:6.0f}s] {name} carried frame {i}: {verdict} "
              f"port {pinfo['num_matches']}/{pinfo['num_inliers']} jit {jinfo['num_matches']}/{jinfo['num_inliers']}"
              + (f" op-by-op {r['jax_op_by_op']['num_matches']}/{r['jax_op_by_op']['num_inliers']}"
                 if "jax_op_by_op" in r else "")
              + (f" vs jit {[b[0] for b in r['vs_jit']]}" if bad else "")
              + (f" vs op-by-op {r['vs_op_by_op']}" if r.get("vs_op_by_op") else ""), flush=True)
    out = {"row": name, "frames": results,
           "counts": {v: sum(r["verdict"] == v for r in results)
                      for v in ("jit", "op_by_op", "orb_op_by_op", "fault")}}
    path = os.path.join(out_dir, f"carried_{frames[0]}-{frames[-1]}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"row": name, "file": path, **out["counts"]}))
    return out


# ---------------------------------------------------------------- explain

def _port_track_stages(track, kp, depth, cam, tcfg) -> dict:
    """The tracker's stages (`slam/tracker.py:track_frame`) in the port,
    each output kept."""
    import torch

    from ra_slam_tpu_torch.core.se3 import exp_se3
    from ra_slam_tpu_torch.ops.hamming import hamming_matrix
    from ra_slam_tpu_torch.slam import tracker as tt
    from ra_slam_tpu_torch.slam.pnp import motion_only_gn

    pose_pred = exp_se3(track.velocity) @ track.pose
    d_kp, has_depth = tt.keypoint_depth(depth, kp, tcfg)
    d_obs = torch.where(has_depth, d_kp, 0.0)
    dist = hamming_matrix(kp.desc, track.lms.desc)
    idx1, ok1 = tt._gated_match(dist, kp, track.lms, pose_pred, cam, tcfg, tcfg.match_radius, track.kf_counter)
    pos = track.lms.pos
    res1 = motion_only_gn(pose_pred, pos[idx1.clamp(min=0).long()], kp.uv, ok1.float(), cam,
                          iterations=tcfg.gn_iterations, huber_delta=tcfg.huber_delta)
    idx2, ok2 = tt._gated_match(dist, kp, track.lms, res1.pose, cam, tcfg, tcfg.rematch_radius, track.kf_counter)
    res = motion_only_gn(res1.pose, pos[idx2.clamp(min=0).long()], kp.uv, ok2.float(), cam,
                         iterations=tcfg.gn_iterations, huber_delta=tcfg.huber_delta,
                         depth_obs=d_obs, depth_weight=tcfg.track_depth_weight)
    n = lambda x: x.cpu().numpy()
    # how well the first solve's normal equations are conditioned, at the
    # prediction (float64)
    from ra_slam_tpu_torch.slam.pnp import _huber_weight, reprojection_residuals

    r, J, okr = reprojection_residuals(pose_pred, pos[idx1.clamp(min=0).long()], kp.uv, cam)
    w = (ok1.double() * okr.double() * _huber_weight(torch.sum(r * r, -1), tcfg.huber_delta).double()).numpy()
    Jn = J.double().numpy()
    H = np.einsum("nri,nrj->ij", Jn * w[:, None, None], Jn)
    return {"pose_pred": (n(pose_pred.R), n(pose_pred.t)), "lm_idx1": n(idx1), "pose1": (n(res1.pose.R), n(res1.pose.t)),
            "lm_idx2": n(idx2), "pose2": (n(res.pose.R), n(res.pose.t)), "inlier": n(res.inliers & ok2),
            "dist": n(dist), "matches1": int(ok1.sum()), "cond1": float(np.linalg.cond(H))}


def _jax_track_stages(track, kp, depth, cam, tcfg, jit=True) -> dict:
    """The same stages in the JAX package, jitted as one program or op
    by op."""
    import jax
    import jax.numpy as jnp

    from ra_slam_tpu.core.se3 import exp_se3
    from ra_slam_tpu.features.matching import hamming_matrix
    from ra_slam_tpu.slam import tracker as jt
    from ra_slam_tpu.slam.pnp import motion_only_gn

    def stages(track, kp, depth):
        pose_pred = exp_se3(track.velocity) @ track.pose
        d_kp, has_depth = jt.keypoint_depth(depth, kp, tcfg)
        d_obs = jnp.where(has_depth, d_kp, 0.0)
        dist = hamming_matrix(kp.desc, track.lms.desc)
        idx1, ok1 = jt._gated_match(dist, kp, track.lms, pose_pred, cam, tcfg, tcfg.match_radius, track.kf_counter)
        pos = track.lms.pos
        res1 = motion_only_gn(pose_pred, pos[jnp.maximum(idx1, 0)], kp.uv, ok1.astype(jnp.float32), cam,
                              iterations=tcfg.gn_iterations, huber_delta=tcfg.huber_delta)
        idx2, ok2 = jt._gated_match(dist, kp, track.lms, res1.pose, cam, tcfg, tcfg.rematch_radius,
                                    track.kf_counter)
        res = motion_only_gn(res1.pose, pos[jnp.maximum(idx2, 0)], kp.uv, ok2.astype(jnp.float32), cam,
                             iterations=tcfg.gn_iterations, huber_delta=tcfg.huber_delta,
                             depth_obs=d_obs, depth_weight=tcfg.track_depth_weight)
        return ((pose_pred.R, pose_pred.t), idx1, (res1.pose.R, res1.pose.t), idx2, (res.pose.R, res.pose.t),
                res.inliers & ok2)

    if jit:
        out = jax.device_get(jax.jit(stages)(track, kp, depth))
    else:
        with jax.disable_jit():
            out = jax.device_get(stages(track, kp, depth))
    keys = ("pose_pred", "lm_idx1", "pose1", "lm_idx2", "pose2", "inlier")
    return {k: jax.tree.map(np.asarray, v) for k, v in zip(keys, out)}


def _project64(R, t, pos, cam):
    p = pos.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    z = p[:, 2]
    return np.stack([p[:, 0] / z * cam.fx + cam.cx, p[:, 1] / z * cam.fy + cam.cy], -1), z


def _gate_rows(stage, radius, pose_key, a, b, kp_uv, pos, cam) -> list:
    """Rows whose matched landmark differs between the port (a) and
    JAX (b): each candidate's pixel distance at both sides' gate
    poses against the gate radius (float64)."""
    rows = []
    for k in np.flatnonzero(a[stage] != b[stage])[:8]:
        cands = sorted({int(x) for x in (a[stage][k], b[stage][k]) if x >= 0})
        entry = {"feature": int(k), "port": int(a[stage][k]), "jax": int(b[stage][k]), "candidates": []}
        for lm in cands:
            c = {"landmark": lm, "hamming": float(a["dist"][k, lm])}
            for side, s in (("port", a), ("jax", b)):
                uv, z = _project64(*s[pose_key], pos[lm:lm + 1], cam)
                d = float(np.linalg.norm(uv[0] - kp_uv[k]))
                c[f"px_{side}"] = d
                c[f"gate_margin_px_{side}"] = radius - d
                c[f"edge_margin_px_{side}"] = float(min(uv[0, 0], cam.width - 1 - uv[0, 0], uv[0, 1],
                                                        cam.height - 1 - uv[0, 1]))
            entry["candidates"].append(c)
        rows.append(entry)
    return rows


def orb_compare(rgb, fcfg, jit: bool) -> dict:
    """The port's ORB against the JAX package's, jitted or op by op, on
    one frame: how many keypoint slots differ, and level by level each
    keypoint one side selects and the other does not (its FAST score on
    both sides, the 3x3 non-maximum-suppression neighbour, and where the
    segment test itself flips, the circle pixel nearest its threshold),
    then for keypoints found by both whose descriptors differ, the
    steered-BRIEF pair that flips: both points' blurred values (read in
    bf16, as the JAX package reads them) on both sides."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import torch

    from ra_slam_tpu.features import fast as jfast
    from ra_slam_tpu.features.orb import detect_and_describe as jdetect
    from ra_slam_tpu.features.pyramid import build_pyramid as jpyr
    from ra_slam_tpu.features.pyramid import gaussian_blur as jblur
    from ra_slam_tpu.features.pyramid import rgb_to_gray as jgray
    from ra_slam_tpu_torch.features import fast as tfast
    from ra_slam_tpu_torch.features import orb as torb
    from ra_slam_tpu_torch.features.pyramid import build_pyramid as tpyr
    from ra_slam_tpu_torch.features.pyramid import gaussian_blur as tblur
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray as tgray

    cell = int(fcfg.cell_size)
    quotas = torb.level_quotas(fcfg)
    ini, lo = float(fcfg.ini_fast_threshold), float(fcfg.min_fast_threshold)

    def jax_side(rgb):
        gray = jgray(rgb.astype(jnp.float32))
        out = []
        for img, q in zip(jpyr(gray, fcfg.num_levels, fcfg.scale_factor), quotas):
            raw = jfast.fast_score(img, ini)
            has = jax.lax.reduce_window(raw, 0.0, jax.lax.max, (cell, cell), (cell, cell), "SAME")
            has = jnp.repeat(jnp.repeat(has > 0.0, cell, axis=0), cell, axis=1)[:img.shape[0], :img.shape[1]]
            raw = jnp.where(has, raw, jfast.fast_score(img, lo))
            uv, vals, valid = jfast.fast_corners(img, ini, q, min_threshold=lo, cell_size=cell)
            out.append((img, jblur(img), raw, uv, vals, valid))
        return out, jdetect(gray, cfg=fcfg)

    with contextlib.nullcontext() if jit else jax.disable_jit():
        run = jax.jit(jax_side) if jit else jax_side
        jout, kj = jax.device_get(run(jnp.asarray(rgb)))
    kt = torb.detect_and_describe(tgray(torch.as_tensor(rgb)), fcfg)
    n = lambda x: x.numpy()
    res = {"valid_differ": int((n(kt.valid) != np.asarray(kj.valid)).sum()),
           "uv_differ": int((np.abs(n(kt.uv) - np.asarray(kj.uv)).max(-1) > 0).sum()),
           "desc_differ": int((n(kt.desc).view(np.uint32) != np.asarray(kj.desc)).any(-1).sum()),
           "keypoints": [], "brief": []}
    start = 0
    for lvl, (img_t, q) in enumerate(zip(tpyr(tgray(torch.as_tensor(rgb)), fcfg.num_levels, fcfg.scale_factor),
                                         quotas)):
        img_j, blur_j, raw_j, uv_j, vals_j, valid_j = (np.asarray(x) for x in jout[lvl])
        raw_t = tfast.fast_score(img_t, ini)
        raw_t = torch.where(tfast._cell_has_corner(raw_t, cell), raw_t, tfast.fast_score(img_t, lo)).numpy()
        uv_t, vals_t, valid_t = (x.numpy() for x in tfast.fast_corners(img_t, ini, q, min_threshold=lo,
                                                                        cell_size=cell))
        blur_t = tblur(img_t).numpy()
        img_t = img_t.numpy()
        ldiff = float(np.abs(img_t - img_j).max())
        pix = lambda uv, ok: {(int(round(u)), int(round(v))) for u, v in uv[ok]}
        pt, pj = pix(uv_t, valid_t), pix(uv_j, valid_j)
        for side, only in (("port", pt - pj), ("jax", pj - pt)):
            for u, v in sorted(only):
                e = {"level": lvl, "pixel": [u, v], "selected_by": side, "level_max_diff": ldiff,
                     "score_port": float(raw_t[v, u]), "score_jax": float(raw_j[v, u]),
                     "last_selected_score": {"port": float(vals_t[valid_t].min()) if valid_t.any() else 0.0,
                                             "jax": float(vals_j[valid_j].min()) if valid_j.any() else 0.0}}
                for name, raw in (("port", raw_t), ("jax", raw_j)):
                    nb = raw[max(v - 1, 0):v + 2, max(u - 1, 0):u + 2].copy()
                    nb[min(v, 1), min(u, 1)] = -np.inf
                    # 3x3 non-maximum suppression keeps score >= the neighbours' max
                    e[f"nms_neighbour_ulps_{name}"] = int(round((float(nb.max()) - float(raw[v, u]))
                                                                / float(np.spacing(np.float32(raw[v, u])))))
                if (raw_t[v, u] > 0) != (raw_j[v, u] > 0):
                    # the segment test flipped: the circle pixel nearest its threshold
                    e["segment_test_margin_grey"] = min(
                        abs(abs(float(img_t[v + dy, u + dx]) - float(img_t[v, u])) - t)
                        for t in (ini, lo) for dx, dy in jfast._CIRCLE)
                    e["moved_grey_nearby"] = float(np.abs(img_t[v - 3:v + 4, u - 3:u + 4]
                                                          - img_j[v - 3:v + 4, u - 3:u + 4]).max())
                res["keypoints"].append(e)
        # descriptors of keypoints both sides found at the same place
        sl = slice(start, start + q)
        start += q
        same = (n(kt.valid)[sl] & np.asarray(kj.valid)[sl]
                & (np.abs(n(kt.uv)[sl] - np.asarray(kj.uv)[sl]).max(-1) == 0))
        bits_t = np.unpackbits(n(kt.desc)[sl].view(np.uint32).view(np.uint8), axis=1, bitorder="little")
        bits_j = np.unpackbits(np.asarray(kj.desc)[sl].view(np.uint8), axis=1, bitorder="little")
        for k in np.flatnonzero(same & (bits_t != bits_j).any(1))[:4]:
            b = int(np.flatnonzero(bits_t[k] != bits_j[k])[0])
            s = fcfg.scale_factor ** lvl
            uv = torch.as_tensor(n(kt.uv)[sl][k:k + 1] / s)
            ang = torch.as_tensor(n(kt.angle)[sl][k:k + 1])
            pat = torb._pattern()[b].astype(np.float32)
            ca, sa = float(torch.cos(ang)), float(torch.sin(ang))
            pts = [(int(round(float(uv[0, 0]) + ca * x - sa * y)), int(round(float(uv[0, 1]) + sa * x + ca * y)))
                   for x, y in ((pat[0], pat[1]), (pat[2], pat[3]))]
            bf = lambda a: float(torch.tensor(a).to(torch.bfloat16).float())
            res["brief"].append({
                "level": lvl, "keypoint_uv": n(kt.uv)[sl][k].tolist(), "bits_differ": int((bits_t[k] != bits_j[k]).sum()),
                "bit": b, "angle_diff": float(abs(n(kt.angle)[sl][k] - np.asarray(kj.angle)[sl][k])),
                "pair_f32_port": [float(blur_t[y, x]) for x, y in pts],
                "pair_f32_jax": [float(blur_j[y, x]) for x, y in pts],
                "pair_bf16_port": [bf(blur_t[y, x]) for x, y in pts],
                "pair_bf16_jax": [bf(blur_j[y, x]) for x, y in pts]})
    return res


def explain_frame(st: "Stepper", before: dict, i: int, fr, jit=True) -> dict:
    """Where the port's step of frame i and JAX's (jitted, or op by op)
    part first."""
    import jax
    import jax.numpy as jnp
    import torch

    from ra_slam_tpu.features.orb import Keypoints as JKP
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.slam.tracker import TrackState
    from ra_slam_tpu_torch.utils.convert import tree_from_numpy

    out = {"frame": i, "against": "jit" if jit else "op_by_op", "orb": orb_compare(fr.rgb, st.ts.fcfg, jit=jit)}
    kt = detect_and_describe(rgb_to_gray(torch.as_tensor(fr.rgb)), st.ts.fcfg)
    n = lambda x: x.numpy()
    state = nested(before)
    if not bool(state.track.initialized):
        out["first_parting"] = "orb"
        return out
    # the tracker's stages from one set of keypoints, the port's
    kpj = JKP(uv=jnp.asarray(n(kt.uv)), level=jnp.asarray(n(kt.level)), score=jnp.asarray(n(kt.score)),
              angle=jnp.asarray(n(kt.angle)), desc=jnp.asarray(n(kt.desc).view(np.uint32)),
              valid=jnp.asarray(n(kt.valid)))
    jtrack = jax_state(before, st._template).track
    depth = np.asarray(fr.depth, np.float32)
    tcfg_t, cam_t = st.ts.tcfg, st.ts.cam
    a = _port_track_stages(tree_from_numpy(TrackState, state.track, "cpu"), kt, torch.from_numpy(depth), cam_t, tcfg_t)
    b = _jax_track_stages(jtrack, kpj, jnp.asarray(depth), st.js.cam, st.js.tcfg, jit=jit)
    pos, kp_uv = np.asarray(state.track.lms.pos), n(kt.uv)
    stages = []
    for name in ("pose_pred", "lm_idx1", "pose1", "lm_idx2", "pose2", "inlier"):
        if name.startswith("pose"):
            d = max(float(np.abs(np.asarray(a[name][0]) - b[name][0]).max()),
                    float(np.abs(np.asarray(a[name][1]) - b[name][1]).max()))
            stages.append({"stage": name, "max_abs_diff": d})
        else:
            flips = int((a[name] != b[name]).sum())
            entry = {"stage": name, "rows_differ": flips}
            if flips and name == "lm_idx1":
                entry["rows"] = _gate_rows(name, tcfg_t.match_radius, "pose_pred", a, b, kp_uv, pos, cam_t)
            elif flips and name == "lm_idx2":
                entry["rows"] = _gate_rows(name, tcfg_t.rematch_radius, "pose1", a, b, kp_uv, pos, cam_t)
            elif flips:
                thr = 5.991 * tcfg_t.huber_delta
                rows = []
                for k in np.flatnonzero(a[name] != b[name])[:8]:
                    lm = int(a["lm_idx2"][k])
                    e = {"feature": int(k), "landmark": lm, "port": bool(a[name][k]), "jax": bool(b[name][k])}
                    for side, s in (("port", a), ("jax", b)):
                        uv, _ = _project64(*s["pose2"], pos[max(lm, 0):max(lm, 0) + 1], cam_t)
                        r2 = float(np.sum((uv[0] - kp_uv[k]) ** 2))
                        e[f"r2_{side}"], e[f"chi2_margin_px2_{side}"] = r2, thr - r2
                    rows.append(e)
                entry["rows"] = rows
            stages.append(entry)
    out["track"] = stages
    out["first_solve"] = {"matches": a["matches1"], "condition_number": a["cond1"]}
    out["first_track_stage"] = next((s["stage"] for s in stages
                                     if s.get("rows_differ", 0) or s.get("max_abs_diff", 0) > POSE_TOL), None)
    o = out["orb"]
    # where the jitted stages alone agree with the port, the fused
    # program's keyframe, BA, loop or relocalization part differs
    out["first_parting"] = ("orb" if o["valid_differ"] or o["uv_differ"] or o["desc_differ"]
                            else out["first_track_stage"] or "after tracking")
    return out


def loop_verify_compare(st: "Stepper", after: dict) -> dict:
    """The loop check of the newest keyframe (`detect_loop`), from one
    state after the step, in the port and in the JAX package op by op:
    the candidate, the mutual matches it is verified on, and for each
    match whose GN inlier decision parts, its squared residual at each
    side's solved pose against the inlier gate (float64)."""
    import jax
    import jax.numpy as jnp
    import torch

    from ra_slam_tpu.slam import loop_closure as jlc
    from ra_slam_tpu_torch.slam import loop_closure as tlc
    from ra_slam_tpu_torch.slam.keyframes import Keyframes
    from ra_slam_tpu_torch.slam.landmarks import Landmarks
    from ra_slam_tpu_torch.utils.convert import tree_from_numpy

    p = st.js.params
    state = nested(after)
    kfc = int(state.track.kf_counter)
    slot = kfc - 1
    js = jax_state(after, st._template)
    with jax.disable_jit():
        cand, _ = jlc.retrieve_candidate(js.kfs, jnp.int32(slot), jnp.int32(kfc), p.loop_min_gap, p.loop_min_score)
        jv = jlc.verify_candidate(js.kfs, js.track.lms, jnp.int32(slot), cand, st.js.cam, st.js.tcfg,
                                  min_inliers=p.loop_min_inliers, max_rmse=p.loop_max_rmse)
    kfs, lms = tree_from_numpy(Keyframes, state.kfs, "cpu"), tree_from_numpy(Landmarks, state.track.lms, "cpu")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    tv = tlc.verify_candidate(kfs, lms, i32(slot), i32(int(cand)), st.ts.cam, st.ts.tcfg,
                              min_inliers=p.loop_min_inliers, max_rmse=p.loop_max_rmse)
    safe = max(int(cand), 0)
    w, pts = tlc._match_candidate(kfs, lms, kfs.desc[slot], kfs.obs_w[slot] > 0, i32(safe), st.ts.tcfg)
    w, pts = w.numpy(), pts.numpy()
    uv = np.asarray(state.kfs.obs_uv)[slot]
    cam = st.ts.cam
    gate = 5.991 * st.ts.tcfg.huber_delta
    poses = {"port": (tv.rel_pose @ kfs.pose(torch.tensor(safe))), "jax": None}
    jpose = jax.device_get(jv.rel_pose @ type(jv.rel_pose)(js.kfs.R[safe], js.kfs.t[safe]))
    r2 = {}
    for side, (R, t) in (("port", (poses["port"].R.numpy(), poses["port"].t.numpy())),
                         ("jax", (np.asarray(jpose.R), np.asarray(jpose.t)))):
        proj, _ = _project64(R, t, pts, cam)
        r2[side] = np.sum((proj - uv) ** 2, -1)
    matched = np.flatnonzero(w > 0)
    return {"query_slot": slot, "candidate": int(cand), "verified_against": safe, "matches": int(matched.size),
            "num_inliers": {"port": int(tv.num_inliers), "jax": int(jv.num_inliers)},
            "rmse": {"port": float(tv.rmse), "jax": float(jv.rmse)}, "inlier_gate_px2": gate,
            "pose_diff": float(np.abs(poses["port"].t.numpy() - np.asarray(jpose.t)).max()),
            "rows": [{"feature": int(k), "r2_port": float(r2["port"][k]), "r2_jax": float(r2["jax"][k]),
                      "margin_px2": gate - float(r2["port"][k])} for k in matched]}


def run_explain(name, kw, out_dir, frames, jit=True):
    sdir = os.path.join(out_dir, "states")
    st = Stepper(kw)
    results = []
    for i in frames:
        fr = st.frame(i)
        r = explain_frame(st, load_state(os.path.join(sdir, f"f{i:04d}.npz")), i, fr, jit=jit)
        results.append(r)
        print(json.dumps(r), flush=True)
    path = os.path.join(out_dir, f"explain_{'jit' if jit else 'op_by_op'}_{frames[0]}-{frames[-1]}.json")
    with open(path, "w") as f:
        json.dump({"row": name, "frames": results}, f, indent=1)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=("free", "free-op-by-op", "carried", "explain", "traces"), required=True)
    p.add_argument("--row", default="ba1", choices=sorted(rows()))
    p.add_argument("--out", required=True, help="directory; the row's files go to <out>/<row>/")
    p.add_argument("--frames", default=None, help="free: how many (default 150); else a-b or i,j,k")
    p.add_argument("--op-by-op", action="store_true", help="explain: against JAX op by op, not jitted")
    p.add_argument("--traces", default=None,
                   help="traces: the JSON to merge the row's traces into (from its free.json, free_op_by_op.json)")
    args = p.parse_args(argv)

    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)  # several sweeps share the CPU
    kw = rows()[args.row]
    out_dir = os.path.join(args.out, args.row)
    os.makedirs(out_dir, exist_ok=True)
    if args.mode == "free":
        return run_free(args.row, kw, out_dir, int(args.frames or ev.N_FRAMES))
    if args.mode == "free-op-by-op":
        return run_free_op_by_op(args.row, kw, out_dir, int(args.frames or ev.N_FRAMES))
    if args.mode == "traces":
        with open(os.path.join(out_dir, "free.json")) as f:
            free = json.load(f)
        obo = os.path.join(out_dir, "free_op_by_op.json")
        if os.path.exists(obo):
            with open(obo) as f:
                return write_traces(args.traces, args.row, free, json.load(f))
        return write_traces(args.traces, args.row, free)
    frames = frame_list(args.frames, ev.N_FRAMES)
    if args.mode == "carried":
        return run_carried(args.row, kw, out_dir, frames)
    return run_explain(args.row, kw, out_dir, frames, jit=not args.op_by_op)


if __name__ == "__main__":
    main()
