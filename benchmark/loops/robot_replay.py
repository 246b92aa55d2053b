"""Replay the robot's two cameras into the program, as its `live_camera`
runs them, in one thread and in the order the cameras deliver: sessions
of the pre-rendered streams (`harness/robot.py`), each on a fresh
`RaSlamSystem` (an empty map), closed loop.

Each ZED pair is split and rectified by `StereoRectifier.rectify` on the
raw views, as `ZedNativeCamera.get_stereo_frame` does, and tracked by
`RaSlamSystem.feed_stereo_frame`, whose `tracked` flag the loop reads on
the host. Each L515 frame goes to `feed_rgbd_frame(rgb, depth, t)` with
no pose, segmented, once the first ZED pair at or past its timestamp
has been tracked: the facade fuses it at the pose buffer's pose of its
timestamp, composed with the extrinsics, with the L515's own
intrinsics. Its depth is converted to float metres on the host first,
as `RealSenseCamera.get_rgbd_frame` does. A cycle is one L515 frame and
the ZED pairs tracked before it.

After the window the last session is checked against the reference
(`benchmark/reference/rig.py`): a sample of the rectified pairs against
its remap, each fused pose against its hand-off of the program's own
tracked poses, and the map against its replay of the fused frames at
the poses the program fused them at (so that the map judges
segmentation and fusion alone). The tracked poses are judged against
the walk's truth.

With `--trace 1` the program's span registry is on for the whole run;
the per-layer quantities are means over the calls outside the profiled
cycles. The fused frames of the profiled cycles are counted
(`traced_fused`), with the fusion's work of each (`traced_work`: the
reference's replay of the session's fused frames at the program's poses),
as `rgbd_replay` counts its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from benchmark.harness import inputs, robot, spans
from benchmark.harness.dev import peak_bytes, reset_peak, sync as dev_sync
from benchmark.harness.scene import seed_bits
from benchmark.harness.trace import Tracer
from benchmark.reference import compare, fusion, rig, track

COUNTERS = ("rectify.calls", "pose_buffer.interpolated")


def system_config(config: dict, rectifier):
    """The facade's config: the rectified ZED as the tracking camera, the
    L515 as the depth camera, the extrinsics. Raises where the program
    has no depth camera apart from the tracking camera (it would fuse the
    L515's frames with the ZED's intrinsics)."""
    from ra_slam_tpu_torch.core.config import CameraConfig, FeatureConfig, SystemConfig, TsdfConfig
    from ra_slam_tpu_torch.core.rectify import rewrite_camera_config

    if "depth_camera" not in {f.name for f in dataclasses.fields(SystemConfig)}:
        raise RuntimeError("this program has no SystemConfig.depth_camera: it cannot fuse the L515 "
                           "with its own intrinsics beside the ZED")
    l5, m, t = config["l515"], config["map"], config["tracking"]
    z = config["zed"]
    return rewrite_camera_config(SystemConfig(
        camera=CameraConfig(width=z["width"], height=z["height"], fps=z["fps"]),
        depth_camera=CameraConfig(fx=l5["fx"], fy=l5["fy"], cx=l5["cx"], cy=l5["cy"], width=l5["width"],
                                  height=l5["height"], fps=l5["fps"], depthmap_factor=1.0 / l5["depth_scale"]),
        tsdf=TsdfConfig(
            voxel_size=m["voxel_size"], truncation=m["truncation"], max_depth=m["max_depth"],
            min_depth=m["min_depth"], max_weight=m["max_weight"], carve_threshold=m["carve_threshold"],
            log2_num_blocks=m["log2_num_blocks"], log2_hash_size=m["log2_hash_size"],
            max_visible_blocks=m["max_visible_blocks"], max_new_blocks=m["max_new_blocks"],
            width=m["width"], height=m["height"],
        ),
        feature=FeatureConfig(max_num_keypoints=t["max_num_keypoints"], num_levels=t["num_levels"],
                              scale_factor=t["scale_factor"]),
        extrinsics=robot.l515_T_zed(config).reshape(-1).tolist(),
    ), rectifier)


def map_spec(config: dict) -> fusion.MapSpec:
    f32 = lambda x: float(np.float32(x))  # the program holds intrinsics in float32
    m = config["map"]
    size = (m["width"], m["height"])
    fx, fy, cx, cy = rig.scaled_intrinsics(config["l515"], size)
    return fusion.MapSpec(
        voxel_size=m["voxel_size"], truncation=m["truncation"], max_depth=m["max_depth"],
        min_depth=m["min_depth"], max_weight=m["max_weight"], carve_threshold=m["carve_threshold"],
        max_new_blocks=m["max_new_blocks"], max_visible_blocks=m["max_visible_blocks"],
        alloc_stride=m["alloc_stride"], fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy), width=size[0],
        height=size[1])


def _program_blocks(m):
    """(sorted keys, tsdf, weight, prob, rgb) of the program's active blocks."""
    idx = torch.nonzero(m.active).squeeze(1)
    keys = m.block_key[idx].to(torch.int64)
    order = torch.argsort(keys)
    rows = idx[order]
    return keys[order], m.tsdf[rows], m.weight[rows], m.prob[rows], m.rgb[rows]


def _matrix(R, t) -> np.ndarray:
    """[4, 4] float64 of an (R, t) pair of tensors or arrays."""
    host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else a
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = host(R), host(t)
    return m


def _counters() -> dict:
    from ra_slam_tpu_torch.utils.profiling import TRACE

    have = TRACE.counters()
    return {k: have[k] for k in COUNTERS if k in have}


def run(ctx):
    from ra_slam_tpu_torch.core.rectify import CalibMono, CalibStereo, StereoRectifier
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
    from ra_slam_tpu_torch.utils.profiling import TRACE

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    left, right, rot, trans, size = robot.calibration(cfg)
    mono = lambda c: CalibMono(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], distortion=list(c["distortion"]))
    rectifier = StereoRectifier(size, CalibStereo(mono(left), mono(right), list(rot), list(trans)), dev)
    sys_cfg = system_config(cfg, rectifier)

    t = time.perf_counter()
    data = robot.make_inputs(cfg, tr, ctx.seed, dev)
    ckpt = str(ctx.work / "segmentation.msgpack")
    wts = inputs.make_segmentation_weights(cfg, ctx.seed, dev, ckpt)
    dev_sync(dev)
    ctx.setup_parts["generate"] = time.perf_counter() - t
    ctx.setup_parts["render"] = data.render_s
    reset_peak(dev)  # the peak is the program's: its set-up and the window

    def new_system():
        return RaSlamSystem(sys_cfg, dev, segmentation_model=ckpt, enable_tracking=True,
                            alloc_stride=cfg["map"]["alloc_stride"])

    # the ZED pair each L515 frame waits for: the first at or past its timestamp
    need = np.searchsorted(data.zed_t, data.l515_t, side="left")
    n_zed, n_l515 = len(data.zed_t), len(data.l515_t)
    scale = np.float32(cfg["l515"]["depth_scale"])
    half = data.zed_raw.shape[2] // 2
    rf = torch.profiler.record_function if ctx.trace else (lambda name: contextlib.nullcontext())
    clock, clock_ns = time.perf_counter, time.perf_counter_ns

    def zed_step(system, i, rec):
        a = clock_ns()
        with rf("bench.rectify"):
            raw = data.zed_raw[i]
            l, r = rectifier.rectify(raw[:, :half], raw[:, half:])
        b = clock_ns()
        with rf("bench.track"):
            info = system.feed_stereo_frame(l, r, float(data.zed_t[i]))
            tracked = bool(info.tracked)
        c = clock_ns()
        rec.append(dict(kind="zed", index=i, start=a, end=c, rect=(b - a) * 1e-9, track=(c - b) * 1e-9,
                        tracked=tracked, pose=(info.pose.R.detach().clone(), info.pose.t.detach().clone()),
                        rectified=(l, r)))
        return tracked

    def l515_step(system, j, rec):
        a = clock_ns()
        with rf("bench.feed_rgbd"):
            depth = data.l515_z16[j].astype(np.float32) * scale  # the camera's host conversion
            stats = system.feed_rgbd_frame(data.l515_rgb[j], depth, float(data.l515_t[j]))
        b = clock_ns()
        fused = "skipped" not in stats
        p = system.last_pose if fused else None
        rec.append(dict(kind="l515", index=j, start=a, end=b, feed=(b - a) * 1e-9, fused=fused,
                        pose=(p.R, p.t) if fused else None, visible=stats.get("num_visible", 0)))
        return fused

    def cycle(system, j, zi, rec, stop_at=None):
        """Track the ZED pairs up to the one L515 frame j waits for, then
        feed it; returns the next ZED pair, and whether the window ran out."""
        while zi <= min(need[j], n_zed - 1):
            zed_step(system, zi, rec)
            zi += 1
            if stop_at is not None and clock() >= stop_at:
                return zi, True
        l515_step(system, j, rec)
        return zi, stop_at is not None and clock() >= stop_at

    tracing = ctx.trace
    if tracing:
        TRACE.enable()
    # warm-up: the cell's own shapes, on a system built as the window builds them
    t = clock()
    system, zi = new_system(), 0
    for j in range(min(tr["warmup_cycles"], n_l515)):
        zi, _ = cycle(system, j, zi, [])
    dev_sync(dev)
    system = None
    gc.collect()
    ctx.setup_parts["warmup"] = clock() - t
    if tracing:
        TRACE.drain()

    tracer = Tracer(ctx.trace, tr["trace_after_cycles"], tr["trace_cycles"], dev)
    records, session = [], []
    sessions = cycles = 0
    before = _counters()
    ctx.window_open()
    t0 = clock()
    stop = False
    while not stop:
        system = None
        session = []
        gc.collect()  # the last session's map is freed before the next allocates its pool
        system = new_system()
        sessions += 1
        zi = 0
        for j in range(n_l515):
            tracer.before_frame(cycles)
            traced = tracer.active()
            start = len(session)
            zi, stop = cycle(system, j, zi, session, t0 + ctx.seconds)
            for r in session[start:]:
                r["traced"], r["session"] = traced, sessions
            tracer.after_frame()
            cycles += 1
            if stop:
                break
        records += session
    dev_sync(dev)
    window_s = clock() - t0
    tracer.stop()
    trace = tracer.reduce()
    peak = peak_bytes(dev)
    after = _counters()
    program = _program_quantities(records, TRACE.drain()) if tracing else {}
    if tracing:
        TRACE.enable(False)

    zed = [r for r in records if r["kind"] == "zed"]
    l515 = [r for r in records if r["kind"] == "l515"]
    fused = sum(r["fused"] for r in l515)
    lost = sum(not r["tracked"] for r in zed)
    e2e = {"fused_fps": fused / window_s, "peak_mem_gib": peak / 2**30,
           "track_ms_p95": float(np.percentile([1e3 * r["track"] for r in zed], 95))}
    untraced = [r for r in records if not r["traced"]]
    spans_out = {"stereo_call": [r["track"] for r in untraced if r["kind"] == "zed"]}
    counters = {"zed_calls": len(zed), "l515_frames": len(l515), "frames_fused": fused, "zed_lost": lost,
                "sessions": sessions, "cycles": cycles, "window_s": window_s,
                "last_session_zed": sum(r["kind"] == "zed" for r in session),
                "last_session_l515": sum(r["kind"] == "l515" for r in session),
                "visible_max": max([r["visible"] for r in l515] or [0]),
                "traced_zed": sum(r["traced"] for r in zed), "traced_l515": sum(r["traced"] for r in l515),
                "track_ms_mean": 1e3 * float(np.mean([r["track"] for r in zed])),
                "rectify_ms_mean": 1e3 * float(np.mean([r["rect"] for r in zed])),
                "feed_ms_mean": 1e3 * float(np.mean([r["feed"] for r in l515])) if l515 else 0.0}
    counters.update({k: after[k] - before[k] for k in after if k in before})
    counters["traced_fused"] = sum(r["traced"] and r["fused"] for r in l515)
    work_frames = _traced_session(l515) if tracing else []

    # --- the check, after the window: the program's map, then its state freed
    prog = _program_blocks(system.map)
    system = None
    records = zed = l515 = None
    numbers = check(cfg, tr, ctx.seed, dev, data, wts, session, prog, lost / max(counters["zed_calls"], 1))
    if work_frames:
        counters["traced_work"] = fusion_work(cfg, dev, data, work_frames)
    return dict(e2e=e2e, attempted=counters["zed_calls"] + counters["l515_frames"],
                failed=lost + counters["l515_frames"] - fused, spans=spans_out, program=program,
                counters=counters, trace=trace, numbers=numbers, peak_bytes=peak)


def _traced_session(l515) -> list:
    """(index, cam_T_world [4, 4], traced) of the fused L515 frames of the
    session that holds the profiled cycles, from its start to its last
    traced frame."""
    traced = [r for r in l515 if r["traced"] and r["fused"]]
    if not traced:
        return []
    frames = [r for r in l515 if r["session"] == traced[0]["session"] and r["fused"]]
    frames = frames[:frames.index(traced[-1]) + 1]
    return [(r["index"], _matrix(*r["pose"]), r["traced"]) for r in frames]


def fusion_work(cfg, dev, data, frames) -> list:
    """(visible blocks, updated voxels) of each traced frame of `frames`
    (`_traced_session`'s): the reference's replay of the geometry alone
    from the session's start (which voxels a frame updates depends on
    depth and pose, not on colour or segmentation)."""
    m = cfg["map"]
    size = (m["width"], m["height"])
    rm = fusion.RefMap(map_spec(cfg), dev)
    zero = torch.zeros((size[1], size[0], 3), device=dev)
    one = torch.ones((size[1], size[0]), device=dev)
    work = []
    for j, pose, traced in frames:
        _, depth = rig.l515_frame(data.l515_rgb[j], data.l515_z16[j], cfg["l515"]["depth_scale"], size)
        n = rm.integrate(torch.from_numpy(depth).to(dev), zero, one, one,
                         torch.as_tensor(pose, dtype=torch.float32, device=dev))
        if traced:
            work.append(n)
    return work


def _program_quantities(records, recs) -> dict:
    """Means, in ms, of the program's spans over the calls outside the
    profiled cycles: `slam.stereo_depth` and `rectify.remap` +
    `rectify.to_host` a ZED pair, `facade.feed_rgbd` a fused L515 frame."""
    totals = [spans.frame_totals(x) for x in spans.assign(recs, [(r["start"], r["end"]) for r in records])]
    zed = [tot for r, tot in zip(records, totals) if r["kind"] == "zed" and not r["traced"]]
    fed = [tot for r, tot in zip(records, totals) if r["kind"] == "l515" and r["fused"] and not r["traced"]]
    mean = lambda xs: 1e3 * sum(xs) / len(xs) if xs else None
    return {"stereo_depth_ms": mean([t.get("slam.stereo_depth", 0.0) for t in zed if "facade.feed_stereo" in t]),
            "rectify_ms": mean([t.get("rectify.remap", 0.0) + t.get("rectify.to_host", 0.0)
                                for t in zed if "rectify.remap" in t]),
            "feed_rgbd_ms": mean([t["facade.feed_rgbd"] for t in fed if "facade.feed_rgbd" in t])}


def _replay(cfg, dev, data, wts, frames, control: bool = False) -> fusion.RefMap:
    """The reference map after the fused L515 frames `frames` (index,
    cam_T_world [4, 4]): each frame made by the reference (its depth
    conversion and resizes), segmented by the float32 UNet and fused;
    `control` at the precision below the configuration's (bf16 payload,
    depth and pose, fp8 convolutions, 7-bit colour)."""
    m = cfg["map"]
    rm = fusion.RefMap(map_spec(cfg), dev, dtype=torch.bfloat16 if control else torch.float32)
    levels = len(cfg["segmentation"]["widths"])
    for j, pose in frames:
        rgb, depth = rig.l515_frame(data.l515_rgb[j], data.l515_z16[j], cfg["l515"]["depth_scale"],
                                    (m["width"], m["height"]), control)
        rgb_t = torch.from_numpy(rgb).to(dev)
        ht, lt = rig.segment(wts, rgb_t, levels, conv_dtype="fp8" if control else None)
        pose = track.bf16(pose) if control else pose
        rm.integrate(torch.from_numpy(depth).to(dev), rgb_t.float(), ht, lt,
                     torch.as_tensor(pose, dtype=torch.float32, device=dev))
    return rm


def _reference_maps(cfg, dev):
    """The reference's (map_x, map_y) of the left and the right view."""
    left, right, rot, trans, size = robot.calibration(cfg)
    R1, R2, P1, P2 = rig.rectification(left, right, rot, trans, size)
    return [tuple(torch.from_numpy(a).to(dev) for a in rig.rectify_maps(c, R, P, size))
            for c, R, P in ((left, R1, P1), (right, R2, P2))]


def check(cfg, tr, seed, dev, data, wts, session, prog, lost_share: float):
    """The numbers of the last session (its records as `run` keeps them):
    `frame_rect` the largest |difference| in levels of a sample of
    rectified pairs (drawn from the seed) against the reference's remap;
    `pose_handoff` the largest |difference| of a fused pose's entries
    against the reference's hand-off of the tracked poses before it;
    `l515_dropped` the L515 frames not fused though the ZED pairs on both
    sides of them tracked; the map against the reference's replay; the
    tracked poses against the truth and the share lost in the window."""
    maps = _reference_maps(cfg, dev)
    zed = [r for r in session if r["kind"] == "zed"]
    rng = np.random.default_rng(seed_bits(seed + 3))
    sample = rng.choice(len(zed), size=min(tr["check_rect_pairs"], len(zed)), replace=False)
    half = data.zed_raw.shape[2] // 2
    worst, means = 0.0, []
    for k in sample:
        r = zed[int(k)]
        raw = torch.from_numpy(data.zed_raw[r["index"]]).to(dev)
        for view, (mx, my), got in zip((raw[:, :half], raw[:, half:]), maps, r["rectified"]):
            want = rig.remap(view, mx, my)
            d = (torch.as_tensor(np.asarray(got), device=dev).to(torch.int32) - want.to(torch.int32)).abs()
            worst, _ = max(worst, float(d.max())), means.append(float(d.float().mean()))

    E = robot.l515_T_zed(cfg)
    handoff, dropped, frames, seen = 0.0, 0, [], []
    for r in session:  # in the order the program was fed
        if r["kind"] == "zed":
            seen.append(r)
            continue
        j = r["index"]
        if not r["fused"]:
            around = seen[-2:]
            dropped += (len(around) == 2 and all(z["tracked"] for z in around)
                        and data.zed_t[around[0]["index"]] < data.l515_t[j] <= data.zed_t[around[1]["index"]])
            continue
        ok = [z for z in seen if z["tracked"]]
        got = _matrix(*r["pose"])
        want = rig.handoff([float(data.zed_t[z["index"]]) for z in ok], [_matrix(*z["pose"]) for z in ok],
                           float(data.l515_t[j]), E)
        handoff = max(handoff, float(np.abs(got - want).max()))
        frames.append((j, got))

    rm = _replay(cfg, dev, data, wts, frames)
    numbers = {"frame_rect": worst, "frame_rect_mean": float(np.mean(means)) if means else 0.0,
               "pose_handoff": handoff, "l515_dropped": float(dropped), "ref_overflow": float(rm.overflow)}
    numbers.update(compare.map_numbers(prog, rm.blocks()))
    numbers["track_lost"] = float(lost_share)
    est = np.stack([_matrix(*r["pose"]) for r in zed])
    numbers.update(track.combine([track.pose_errors(est, np.array([r["tracked"] for r in zed]),
                                                    data.zed_truth[[r["index"] for r in zed]])]))
    return numbers


def control_session(cfg, dev, data, wts, frames: int):
    """The control in the program's place over the first `frames` cycles
    of a session: the reference's remap on bfloat16 maps, the walk's
    truth in the first camera's frame as the tracked poses and its
    hand-off, both in bfloat16. Returns (session records, map) as `run`
    hands the program's to `check`."""
    maps = _reference_maps(cfg, dev)
    half = data.zed_raw.shape[2] // 2
    need = np.searchsorted(data.zed_t, data.l515_t, side="left")
    E, w0 = robot.l515_T_zed(cfg), np.linalg.inv(data.zed_truth[0])
    session, fused, zi = [], [], 0
    for j in range(min(frames, len(data.l515_t))):
        while zi <= min(need[j], len(data.zed_t) - 1):
            raw = torch.from_numpy(data.zed_raw[zi]).to(dev)
            rect = [rig.remap(v, mx, my, torch.bfloat16).cpu().numpy()
                    for v, (mx, my) in zip((raw[:, :half], raw[:, half:]), maps)]
            cTw = track.bf16(np.linalg.inv(w0 @ data.zed_truth[zi]))
            session.append(dict(kind="zed", index=zi, tracked=True, pose=(cTw[:3, :3], cTw[:3, 3]),
                                rectified=tuple(rect)))
            zi += 1
        ok = [r for r in session if r["kind"] == "zed"]
        pose = rig.handoff([float(data.zed_t[r["index"]]) for r in ok], [_matrix(*r["pose"]) for r in ok],
                           float(data.l515_t[j]), E, control=True)
        session.append(dict(kind="l515", index=j, fused=True, pose=(pose[:3, :3], pose[:3, 3])))
        fused.append((j, pose))
    return session, _replay(cfg, dev, data, wts, fused, control=True).blocks()


def control(cell, seed: int, frames: int, device) -> dict:
    """The numbers of the control in the program's place over the first
    `frames` cycles of a session."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="bench_control_") as work:
        data = robot.make_inputs(cell.config, cell.traffic, seed, device)
        wts = inputs.make_segmentation_weights(cell.config, seed, device, str(Path(work) / "w.msgpack"))
        session, blocks = control_session(cell.config, device, data, wts, frames)
        return check(cell.config, cell.traffic, seed, device, data, wts, session, blocks, 0.0)
