"""Replay a recorded RGB-D sequence into the program, as `offline_eval`
does: sessions of the whole `.sens` file, one frame at a time (a closed
loop), each session on a fresh `RaSlamSystem` (an empty map).

Each frame is read by `SensReader.frame` and fused by
`RaSlamSystem.feed_rgbd_frame`, segmented by the program's UNet: at the
frame's recorded pose, or (traffic `"use_slam": true`) at the pose that
`feed_tracking_frame` tracked, whose `tracked` flag the loop reads on the
host before it goes on; a frame that tracking loses is not fused and
counts as failed.

After the window, the map that the program holds (the last session's,
after the frames it had fused) is checked against the reference
(`benchmark/reference/`), which replays the same frames. The reference
reads depth and pose from the file itself; it takes the colour that the
program decoded, and judges that decode apart, against libjpeg's, on a
sample of frames drawn from the seed. Tracked poses are judged against
the walk's ground truth.
"""

from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.dev import peak_bytes, reset_peak, sync as dev_sync
from benchmark.harness.scene import seed_bits
from benchmark.harness.trace import Tracer
from benchmark.reference import compare, fusion, sens, track, unet


def _system_config(config: dict):
    from ra_slam_tpu_torch.core.config import CameraConfig, SystemConfig, TsdfConfig

    fx, fy, cx, cy, w, h = inputs.depth_camera(config)
    m = config["map"]
    return SystemConfig(
        camera=CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h, fps=config["fps"],
                            depthmap_factor=config["depth"]["shift"]),
        tsdf=TsdfConfig(
            voxel_size=m["voxel_size"], truncation=m["truncation"], max_depth=m["max_depth"],
            min_depth=m["min_depth"], max_weight=m["max_weight"], carve_threshold=m["carve_threshold"],
            log2_num_blocks=m["log2_num_blocks"], log2_hash_size=m["log2_hash_size"],
            max_visible_blocks=m["max_visible_blocks"], max_new_blocks=m["max_new_blocks"],
            width=w, height=h,
        ),
    )


def map_spec(config: dict) -> fusion.MapSpec:
    f32 = lambda x: float(np.float32(x))  # the program holds intrinsics in float32
    fx, fy, cx, cy, w, h = inputs.depth_camera(config)
    m = config["map"]
    return fusion.MapSpec(
        voxel_size=m["voxel_size"], truncation=m["truncation"], max_depth=m["max_depth"],
        min_depth=m["min_depth"], max_weight=m["max_weight"], carve_threshold=m["carve_threshold"],
        max_new_blocks=m["max_new_blocks"], max_visible_blocks=m["max_visible_blocks"],
        alloc_stride=m["alloc_stride"], fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy), width=w, height=h)


def _program_blocks(m):
    """(sorted keys, tsdf, weight, prob, rgb) of the program's active blocks."""
    idx = torch.nonzero(m.active).squeeze(1)
    keys = m.block_key[idx].to(torch.int64)
    order = torch.argsort(keys)
    rows = idx[order]
    return keys[order], m.tsdf[rows], m.weight[rows], m.prob[rows], m.rgb[rows]


def run(ctx):
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.io.sens import SensReader
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    use_slam = bool(tr["use_slam"])
    t = time.perf_counter()
    seq = inputs.make_rgbd_sequence(cfg, tr, ctx.seed, dev, str(ctx.work / "sequence.sens"))
    ckpt = str(ctx.work / "segmentation.msgpack")
    wts = inputs.make_segmentation_weights(cfg, ctx.seed, dev, ckpt)
    dev_sync(dev)
    ctx.setup_parts["generate"] = time.perf_counter() - t
    ctx.setup_parts["render"] = seq.render_s
    reset_peak(dev)  # the peak is the program's: its set-up and the window
    sys_cfg = _system_config(cfg)
    alloc_stride = cfg["map"]["alloc_stride"]
    def new_system():
        return RaSlamSystem(sys_cfg, dev, segmentation_model=ckpt, enable_tracking=use_slam,
                            alloc_stride=alloc_stride)

    reader = SensReader(seq.path)
    n_frames = len(reader)
    rf = torch.profiler.record_function if ctx.trace else (lambda name: contextlib.nullcontext())
    clock = time.perf_counter

    def step(system, i, rec):
        """One frame; returns (fused, tracked) and appends its spans."""
        a = clock()
        with rf("bench.read"):
            f = reader.frame(i)
        b = clock()
        pose = tracked_pose = None
        tracked, c = True, b
        if use_slam:
            with rf("bench.track"):
                info = system.feed_tracking_frame(f.rgb, f.depth, f.timestamp)
                tracked = bool(info.tracked)
            c = clock()
            tracked_pose = (info.pose.R.detach().clone(), info.pose.t.detach().clone())
        fused = False
        stats = {}
        if tracked:
            with rf("bench.feed_rgbd"):
                given = None if use_slam else SE3.from_matrix(torch.from_numpy(f.cam_T_world))
                stats = system.feed_rgbd_frame(f.rgb, f.depth, f.timestamp, pose=given)
            fused = "skipped" not in stats
            if use_slam and fused:  # the pose the frame was fused at: the pose buffer's
                q = system.query_camera_pose(f.timestamp)
                pose = (q.R.detach().clone(), q.t.detach().clone())
        d = clock()
        rec.append(dict(index=i, read=b - a, track=c - b, feed=d - c, fused=fused, tracked=tracked,
                        visible=stats.get("num_visible", 0), alloc_failures=stats.get("alloc_failures", 0),
                        frame=f, pose=pose, tracked_pose=tracked_pose))
        return fused, tracked

    # warm-up: the cell's own shapes, on a system built as the window builds them
    t = clock()
    system = new_system()
    warm = []
    for i in range(min(tr["warmup_frames"], n_frames)):
        step(system, i, warm)
    dev_sync(dev)
    system, warm = None, None
    gc.collect()
    ctx.setup_parts["warmup"] = clock() - t

    tracer = Tracer(ctx.trace, tr["trace_after_frames"], tr["trace_frames"], dev)
    records, session_start = [], 0
    attempted = fused = failed = sessions = 0
    ctx.window_open()
    t0 = clock()
    stop = False
    while not stop:
        system = None
        gc.collect()  # the last session's map is freed before the next allocates its pool
        system = new_system()
        sessions += 1
        session_start = len(records)
        for i in range(n_frames):
            tracer.before_frame(len(records))
            traced = tracer.active()
            ok, _ = step(system, i, records)
            records[-1]["traced"] = traced
            tracer.after_frame()
            attempted += 1
            fused += ok
            failed += not ok
            if clock() - t0 >= ctx.seconds:
                stop = True
                break
    dev_sync(dev)
    window_s = clock() - t0
    tracer.stop()
    trace = tracer.reduce()
    peak = peak_bytes(dev)

    session = records[session_start:]
    e2e = {"fused_fps": fused / window_s, "peak_mem_gib": peak / 2**30}
    track_ms = [r["track"] * 1e3 for r in records]
    if use_slam:
        e2e["track_ms_p95"] = float(np.percentile(track_ms, 95))

    untraced = [r for r in records if not r.get("traced")]
    spans = {"read": [r["read"] for r in untraced], "feed_rgbd": [r["feed"] for r in untraced if r["fused"]],
             "track": [r["track"] for r in untraced]}
    counters = {"frames_fused": fused, "sessions": sessions, "session_frames": n_frames,
                "last_session_frames": len(session), "window_s": window_s,
                "visible_max": max(r["visible"] for r in records),
                "traced_index": [r["index"] for r in records if r.get("traced") and r["fused"]],
                "traced_fused": sum(1 for r in records if r.get("traced") and r["fused"]),
                "alloc_failures": max(r["alloc_failures"] for r in records),
                "read_ms_mean": 1e3 * float(np.mean([r["read"] for r in records])),
                "feed_ms_mean": 1e3 * float(np.mean([r["feed"] for r in records])),
                "track_ms_mean": 1e3 * float(np.mean([r["track"] for r in records]))}

    lost_share = sum(not r["tracked"] for r in records) / len(records)

    # --- the check, after the window: the program's map, then its state freed
    prog = _program_blocks(system.map)
    system = None
    records = None
    numbers = check(cfg, tr, ctx.seed, dev, seq, wts, session, prog, lost_share)
    if ctx.trace and not use_slam and counters["traced_index"]:
        counters["traced_work"] = fusion_work(cfg, dev, seq.path, counters["traced_index"])
    return dict(e2e=e2e, attempted=attempted, failed=failed, spans=spans, counters=counters,
                trace=trace, numbers=numbers, peak_bytes=peak)


def _replay(cfg, dev, ref, wts, session, control: bool = False) -> fusion.RefMap:
    """The reference map after the session's fused frames: depth, colour
    and (unless tracked) pose read by the reference's own reader, the
    UNet and the fusion in plain PyTorch; `control` at the precision
    below the configuration's (bf16 payload, fp8 convolutions, bf16
    depth and pose, 7-bit colour). The UNet segments the colour that the
    program decoded, so that the map's probabilities judge the
    segmentation alone, while its colours judge the decode (libjpeg's
    against the program's); the two channels do not mix in fusion. Fed
    libjpeg's colour, the UNet would carry the two decoders' rounding
    into the probabilities, and `map_prob` would judge both stages at
    once."""
    rm = fusion.RefMap(map_spec(cfg), dev, dtype=torch.bfloat16 if control else torch.float32)
    levels = len(cfg["segmentation"]["widths"])
    for j, r in enumerate(session):
        if not r["fused"]:
            continue
        rgb = torch.from_numpy(ref.color(j, control)).to(dev)
        # on the colour the program decoded: the stage alone
        seen = torch.from_numpy(np.ascontiguousarray(r["frame"].rgb)).to(dev)
        ht, lt = unet.segment(wts, seen, levels, conv_dtype="fp8" if control else None)
        if r["pose"] is None:
            pose = torch.from_numpy(ref.pose(j, control)).to(dev)
        else:  # the tracked pose the program fused at
            pose = torch.as_tensor(_as_matrix(r["pose"]), dtype=torch.float32, device=dev)
        rm.integrate(torch.from_numpy(ref.depth(j, control)).to(dev), rgb.float(), ht, lt, pose)
    return rm


def check(cfg, tr, seed, dev, seq, wts, session, prog, lost_share: float):
    """The numbers of the last session: the frames the program read
    against the reference reader's (depth and pose exactly; colour, a
    reading only, on a sample drawn from the seed: nvjpeg against
    libjpeg), and its map against the reference's replay of the same
    frames. A tracked replay adds the share of the window's frames that
    tracking lost (`lost_share`) and the tracked poses against the
    truth."""
    ref = sens.Sens(seq.path)
    depth_err = pose_err = 0.0
    for j, r in enumerate(session):
        f = r["frame"]
        depth_err = max(depth_err, float(np.abs(f.depth - ref.depth(j)).max()))
        pose_err = max(pose_err, float(np.abs(f.cam_T_world - ref.pose(j)).max()))
    rng = np.random.default_rng(seed_bits(seed + 3))
    sample = rng.choice(len(session), size=min(tr["check_color_frames"], len(session)), replace=False)
    rgb_err = float(np.mean([np.abs(session[j]["frame"].rgb.astype(np.int32)
                                    - ref.color(int(j)).astype(np.int32)).mean() for j in sample]))
    rm = _replay(cfg, dev, ref, wts, session)
    numbers = {"frame_depth": depth_err, "frame_pose": pose_err, "frame_rgb": rgb_err,
               "ref_overflow": float(rm.overflow)}
    numbers.update(compare.map_numbers(prog, rm.blocks()))
    if tr["use_slam"]:  # the frames lost, and the tracked poses against the walk's truth
        numbers["track_lost"] = float(lost_share)
        est = np.stack([_as_matrix(r["tracked_pose"]) for r in session])
        numbers.update(track.combine([track.pose_errors(est, np.array([r["tracked"] for r in session]),
                                                        seq.world_T_cam[:len(session)])]))
    return numbers


def fusion_work(cfg, dev, path: str, indices) -> list:
    """(visible blocks, updated voxels) of the fusion of each frame in
    `indices` at its recorded pose, from a session's start: the
    reference's replay of the geometry alone (which voxels a frame
    updates depends on depth and pose, not on colour or segmentation)."""
    ref = sens.Sens(path)
    rm = fusion.RefMap(map_spec(cfg), dev)
    h, w = ref.depth(0).shape
    zero, one = torch.zeros((h, w, 3), device=dev), torch.ones((h, w), device=dev)
    want, work = set(indices), {}
    for j in range(max(indices) + 1):
        n = rm.integrate(torch.from_numpy(ref.depth(j)).to(dev), zero, one, one,
                         torch.from_numpy(ref.pose(j)).to(dev))
        if j in want:
            work[j] = n
    return [work[j] for j in indices]


def _as_matrix(pose) -> np.ndarray:
    """[4, 4] float64 of an (R, t) pair of tensors or arrays."""
    m = np.eye(4)
    m[:3, :3] = np.asarray(pose[0].cpu() if torch.is_tensor(pose[0]) else pose[0], np.float64)
    m[:3, 3] = np.asarray(pose[1].cpu() if torch.is_tensor(pose[1]) else pose[1], np.float64)
    return m


def control_session(cfg, tr, seed, dev, seq, wts, frames: int):
    """The control in the program's place over the first `frames` frames
    of a session. Returns (session records, map) as `run` hands the
    program's to `check`."""
    ref = sens.Sens(seq.path)
    session = []
    for j in range(min(frames, len(ref))):
        pose = None
        if tr["use_slam"]:  # the truth in the first camera's frame, in bfloat16
            cTw = np.linalg.inv(np.linalg.inv(seq.world_T_cam[0]) @ seq.world_T_cam[j])
            pose = (track.bf16(cTw[:3, :3]), track.bf16(cTw[:3, 3]))
        session.append(dict(frame=SimpleNamespace(rgb=ref.color(j, True), depth=ref.depth(j, True),
                                                  cam_T_world=ref.pose(j, True)),
                            fused=True, tracked=True, pose=pose, tracked_pose=pose))
    return session, _replay(cfg, dev, ref, wts, session, control=True).blocks()


def control(cell, seed: int, frames: int, device) -> dict:
    """The numbers of the control in the program's place over the first
    `frames` frames of a session."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="bench_control_") as work:
        seq = inputs.make_rgbd_sequence(cell.config, cell.traffic, seed, device, str(Path(work) / "s.sens"))
        wts = inputs.make_segmentation_weights(cell.config, seed, device, str(Path(work) / "w.msgpack"))
        session, blocks = control_session(cell.config, cell.traffic, seed, device, seq, wts, frames)
        return check(cell.config, cell.traffic, seed, device, seq, wts, session, blocks, 0.0)
