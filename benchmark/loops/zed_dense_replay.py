"""Replay the ZED alone as the robot's RGB-D camera, as the reference's
`ZED::GetStereoAndRGBDFrame` feeds `DISINFSystem`: sessions of the
pre-rendered raw pairs, each on a fresh `RaSlamSystem` (an empty map),
one thread, closed loop.

Each raw side-by-side pair is split, uploaded and rectified on the card
by the program's `core/rectify.py:StereoRectifier` (the replay source,
as the UVC camera opened raw hands pairs to `ZedDepthCamera`), and goes
through the program's `io/cameras.py:ZedDepthCamera` over it; tracked by
`RaSlamSystem.feed_stereo_frame`, whose `tracked` flag the loop reads on
the host; its dense census depth computed on the card (`depth`, a device
tensor); then `feed_rgbd_frame(left, depth, t)` with no pose, segmented
and fused at the pose buffer's pose of the pair's own timestamp (an
exact entry, no interpolation). A cycle is one pair.

After the window the check (`check`): a sample of pairs drawn from the
seed (every `stride`-th pair of a session from a seeded offset, the last
computed of each kept on the card) is held against the reference's
remap (`reference/rig.py`) and against the reference's dense depth of
the program's own rectified pair (`reference/dense_stereo.py`); each
fused pose of the last session against its pair's tracked pose; the
tracked pairs not fused, and the pairs fused while lost, over the
window; the last session's map against the reference's fusion of the
reference's depth of the program's rectified pairs at the program's
fused poses (so that the map judges the dense depth, segmentation and
fusion). The program's rectification is repeated after the window for
that: the repeat of every fused pair of the last session is held to the
reference's remap, and to the window's on the sample; the tracked poses
are judged against the walk's truth.

With `--trace 1` the program's span registry is on for the whole run;
the per-layer quantities are means over the pairs outside the profiled
cycles, and the dense stage's device time is the profile's device time
of the work launched inside the program's `ra.stereo.dense` ranges. The
fusion's work of each profiled pair (`traced_work`) is the reference's
replay of that session's fused pairs, as `robot_replay` counts its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import inputs, robot, scene, spans
from benchmark.harness.dev import peak_bytes, reset_peak, sync as dev_sync
from benchmark.harness.trace import Tracer
from benchmark.loops.robot_replay import _matrix, _program_blocks
from benchmark.reference import compare, fusion, rig, track
from benchmark.reference import dense_stereo as ref_stereo

COUNTERS = ("rectify.calls", "pose_buffer.interpolated", "stereo.dense_calls", "stereo.dense_entries")
DENSE_SPAN = "ra.stereo.dense"
UPLOAD_SPAN = "ra.facade.upload"
# the program's ranges whose device time the traced run reports: the dense
# stage, the rectification, detection (ORB's graph) and the whole tracking
# call, the UNet and fusion
STAGES = (DENSE_SPAN, "ra.rectify.remap", "ra.slam.detect", "ra.facade.feed_stereo", "ra.seg.segment",
          "ra.map.integrate_frame")


class ZedInputs(NamedTuple):
    raw: np.ndarray  # [N, h, 2 w, 3] uint8 side-by-side, distorted, unrectified
    t: np.ndarray  # [N] seconds
    truth: np.ndarray  # [N, 4, 4] float64 world_T_cam of the rectified left camera
    render_s: float


def make_inputs(config: dict, traffic: dict, seed: int, device, batch: int = 8) -> ZedInputs:
    """The ZED's raw pairs along the walk, rendered on the device through
    the distortion as `harness/robot.py` renders the robot's ZED, and
    held on the host."""
    room = scene.make_room(config["room"]["half_extents"], config["room"]["clutter"])
    w = traffic["walk"]
    walk = scene.walk(traffic["lap_ticks"], w["radii"], w["height"])
    ticks = traffic["zed_every"] * np.arange(traffic["zed_pairs"])
    left, right, rot, trans, (zw, zh) = robot.calibration(config)
    raw_T_rect = np.eye(4)
    raw_T_rect[:3, :3] = rig.rectification(left, right, rot, trans, (zw, zh))[0].T
    right_T_left = np.eye(4)
    right_T_left[:3, :3], right_T_left[:3, 3] = rig.rodrigues(rot), trans
    at = lambda tk: walk[np.asarray(tk) % traffic["lap_ticks"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(scene.seed_bits(seed + 1))
    views = [(robot._raw_sampler(cam, (zw, zh), device), T)
             for cam, T in ((left, np.eye(4)), (right, np.linalg.inv(right_T_left)))]
    sigma = float(config["zed"]["pixel_noise"])
    n = len(ticks)
    raw = np.empty((n, zh, 2 * zw, 3), np.uint8)
    render_s = 0.0
    for lo in range(0, n, batch):
        t = time.perf_counter()
        wTl = at(ticks[lo:lo + batch])
        halves = []
        for (canvas, grid), T in views:
            wTc = torch.as_tensor(wTl @ T, dtype=torch.float64, device=device)
            img, _ = scene.render(room, wTc, *canvas, depth=False)
            x = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid.expand(len(wTc), -1, -1, -1),
                              mode="bilinear", padding_mode="border", align_corners=True)
            x = x + sigma * torch.randn(x.shape, generator=gen, device=device)
            halves.append(torch.round(x).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1))
        raw[lo:lo + batch] = torch.cat(halves, dim=2).cpu().numpy()
        render_s += time.perf_counter() - t
    return ZedInputs(raw=raw, t=ticks / float(traffic["clock_hz"]), truth=at(ticks) @ raw_T_rect, render_s=render_s)


class RectifiedPairs:
    """Pair `index`: the ZED's raw views as the UVC camera hands them over
    (`ZedNativeCamera` opened raw), uploaded and rectified on the device
    by the program's `rectifier`, as `ZedDepthCamera` does with the
    camera it opens."""

    def __init__(self, data: ZedInputs, rectifier, device):
        self.data, self.rectifier, self.device, self.index = data, rectifier, device, 0

    def get_stereo_frame(self):
        raw = self.data.raw[self.index]
        half = raw.shape[1] // 2
        up = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
        left, right = self.rectifier.rectify(up(raw[:, :half]), up(raw[:, half:]))
        return left, right, float(self.data.t[self.index])

    def close(self) -> None:
        pass


def system_config(config: dict, rectifier):
    """The facade's config: the rectified ZED as the tracking camera and,
    with `dense_stereo`, as the depth camera. Raises where the program
    cannot fuse the ZED's own depth."""
    from ra_slam_tpu_torch.core import config as pc
    from ra_slam_tpu_torch.core.rectify import rewrite_camera_config

    if "dense_stereo" not in {f.name for f in dataclasses.fields(pc.SystemConfig)}:
        raise RuntimeError("this program has no SystemConfig.dense_stereo: it cannot fuse the ZED's own dense "
                           "depth as its RGB-D frames")
    z, m, t, ds = config["zed"], config["map"], config["tracking"], config["dense_stereo"]
    dense = pc.DenseStereoConfig(**{f.name: ds[f.name] for f in dataclasses.fields(pc.DenseStereoConfig)})
    return rewrite_camera_config(pc.SystemConfig(
        camera=pc.CameraConfig(width=z["width"], height=z["height"], fps=z["fps"]),
        tsdf=pc.TsdfConfig(
            voxel_size=m["voxel_size"], truncation=m["truncation"], max_depth=m["max_depth"],
            min_depth=m["min_depth"], max_weight=m["max_weight"], carve_threshold=m["carve_threshold"],
            log2_num_blocks=m["log2_num_blocks"], log2_hash_size=m["log2_hash_size"],
            max_visible_blocks=m["max_visible_blocks"], max_new_blocks=m["max_new_blocks"],
            width=m["width"], height=m["height"],
        ),
        feature=pc.FeatureConfig(max_num_keypoints=t["max_num_keypoints"], num_levels=t["num_levels"],
                                 scale_factor=t["scale_factor"]),
        dense_stereo=dense,
    ), rectifier)


def _projections(config: dict):
    """(P1, P2) of the reference's rectification."""
    left, right, rot, trans, size = robot.calibration(config)
    return rig.rectification(left, right, rot, trans, size)[2:]


def _reference_maps(config: dict, dev):
    """The reference's float32 (map_x, map_y) of the left and the right
    view, on `dev`."""
    left, right, rot, trans, size = robot.calibration(config)
    R1, R2, P1, P2 = rig.rectification(left, right, rot, trans, size)
    return [tuple(torch.from_numpy(m).to(dev) for m in rig.rectify_maps(c, R, P, size))
            for c, R, P in ((left, R1, P1), (right, R2, P2))]


def map_spec(config: dict) -> fusion.MapSpec:
    """The map as the facade fuses the ZED's frames: the reference's
    rectified left camera at the map's size."""
    f32 = lambda x: float(np.float32(x))  # the program holds intrinsics in float32
    m, z = config["map"], config["zed"]
    P1 = _projections(config)[0]
    cam = dict(fx=P1[0, 0], fy=P1[1, 1], cx=P1[0, 2], cy=P1[1, 2], width=z["width"], height=z["height"])
    fx, fy, cx, cy = rig.scaled_intrinsics(cam, (m["width"], m["height"]))
    return fusion.MapSpec(
        voxel_size=m["voxel_size"], truncation=m["truncation"], max_depth=m["max_depth"],
        min_depth=m["min_depth"], max_weight=m["max_weight"], carve_threshold=m["carve_threshold"],
        max_new_blocks=m["max_new_blocks"], max_visible_blocks=m["max_visible_blocks"],
        alloc_stride=m["alloc_stride"], fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy), width=m["width"],
        height=m["height"])


# the caching allocator's calls to the driver (each cudaFree waits for the
# device), and its retries after a failed allocation
ALLOCATOR = {"num_device_alloc": "allocator.mallocs", "num_device_free": "allocator.frees",
             "num_alloc_retries": "allocator.retries"}


def _counters(dev=None) -> dict:
    from ra_slam_tpu_torch.utils.profiling import TRACE

    have = dict(TRACE.counters())
    if dev is not None and torch.device(dev).type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        have.update({v: stats[k] for k, v in ALLOCATOR.items() if k in stats})
    return {k: have[k] for k in COUNTERS + tuple(ALLOCATOR.values()) if k in have}


def kept_pairs(traffic: dict, seed: int) -> set:
    """The pairs of a session the check holds to the reference: every
    `stride`-th from an offset drawn from the seed."""
    n = traffic["zed_pairs"]
    stride = max(n // traffic["check_pairs"], 1)
    offset = int(np.random.default_rng(scene.seed_bits(seed + 3)).integers(stride))
    return set(range(offset, n, stride))


def run(ctx):
    from ra_slam_tpu_torch.core.rectify import CalibMono, CalibStereo, StereoRectifier
    from ra_slam_tpu_torch.io.cameras import ZedDepthCamera
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
    from ra_slam_tpu_torch.utils.profiling import TRACE

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    left, right, rot, trans, size = robot.calibration(cfg)
    mono = lambda c: CalibMono(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], distortion=list(c["distortion"]))
    rectifier = StereoRectifier(size, CalibStereo(mono(left), mono(right), list(rot), list(trans)), dev)
    sys_cfg = system_config(cfg, rectifier)

    t = time.perf_counter()
    data = make_inputs(cfg, tr, ctx.seed, dev)
    ckpt = str(ctx.work / "segmentation.msgpack")
    wts = inputs.make_segmentation_weights(cfg, ctx.seed, dev, ckpt)
    dev_sync(dev)
    ctx.setup_parts["generate"] = time.perf_counter() - t
    ctx.setup_parts["render"] = data.render_s
    reset_peak(dev)  # the peak is the program's: its set-up and the window

    source = RectifiedPairs(data, rectifier, dev)
    ds = sys_cfg.dense_stereo
    cam = ZedDepthCamera(None, rectifier.focal_x_baseline, device=dev, cam=source,
                         max_disparity=ds.max_disparity, max_depth=ds.max_depth)

    def new_system():
        system = RaSlamSystem(sys_cfg, dev, segmentation_model=ckpt, enable_tracking=True,
                              alloc_stride=cfg["map"]["alloc_stride"])
        if system.slam.max_disparity != cfg["keypoint_max_disparity"]:
            raise RuntimeError(f"the program searches keypoints over {system.slam.max_disparity} px, the "
                               f"configuration states {cfg['keypoint_max_disparity']}")
        return system

    n_pairs = len(data.t)
    keep = kept_pairs(tr, ctx.seed)
    kept: dict = {}  # pair -> (left, right, depth) on the card, the last computed
    rf = torch.profiler.record_function if ctx.trace else (lambda name: contextlib.nullcontext())
    clock, clock_ns = time.perf_counter, time.perf_counter_ns

    def cycle(system, i, rec, window=True):
        source.index = i
        a = clock_ns()
        with rf("bench.rectify"):
            l, r, ts = cam.get_stereo_frame()
        b = clock_ns()
        with rf("bench.track"):
            info = system.feed_stereo_frame(l, r, ts)
            tracked = bool(info.tracked)
        c = clock_ns()
        with rf("bench.depth"):
            depth = cam.depth(l, r)
        d = clock_ns()
        with rf("bench.feed_rgbd"):
            stats = system.feed_rgbd_frame(l, depth, ts)
        e = clock_ns()
        fused = "skipped" not in stats
        p = system.last_pose if fused else None
        rec.append(dict(index=i, start=a, end=e, rect=(b - a) * 1e-9, track=(c - b) * 1e-9, depth=(d - c) * 1e-9,
                        feed=(e - d) * 1e-9, tracked=tracked, fused=fused, visible=stats.get("num_visible", 0),
                        alloc_failures=stats.get("alloc_failures", 0),
                        pose=(info.pose.R.detach().clone(), info.pose.t.detach().clone()),
                        fused_pose=(p.R, p.t) if fused else None))
        if window and i in keep:
            kept[i] = (l, r, depth)

    tracing = ctx.trace
    if tracing:
        TRACE.enable()
    # warm-up: the cell's own shapes, on a system built as the window builds them
    t = clock()
    system = new_system()
    for i in range(min(tr["warmup_cycles"], n_pairs)):
        cycle(system, i, [], window=False)
    dev_sync(dev)
    system = None
    gc.collect()
    ctx.setup_parts["warmup"] = clock() - t
    if tracing:
        TRACE.drain()

    tracer = Tracer(ctx.trace, tr["trace_after_cycles"], tr["trace_cycles"], dev)
    records, session = [], []
    sessions = cycles = 0
    before = _counters(dev)
    ctx.window_open()
    t0 = clock()
    stop = False
    while not stop:
        system = None
        session = []
        gc.collect()  # the last session's map is freed before the next allocates its pool
        system = new_system()
        sessions += 1
        for i in range(n_pairs):
            tracer.before_frame(cycles)
            traced = tracer.active()
            cycle(system, i, session)
            session[-1]["traced"], session[-1]["session"] = traced, sessions
            tracer.after_frame()
            cycles += 1
            if clock() >= t0 + ctx.seconds:
                stop = True
                break
        records += session
    dev_sync(dev)
    window_s = clock() - t0
    tracer.stop()
    stages = _device_by_span(tracer.prof) if tracer.prof is not None and tracer.done else None
    trace = tracer.reduce()
    peak = peak_bytes(dev)
    after = _counters(dev)
    program = _program_quantities(records, TRACE.drain()) if tracing else {}
    if tracing:
        TRACE.enable(False)

    fused = sum(r["fused"] for r in records)
    lost = sum(not r["tracked"] for r in records)
    e2e = {"fused_fps": fused / window_s, "peak_mem_gib": peak / 2**30,
           "track_ms_p95": float(np.percentile([1e3 * r["track"] for r in records], 95))}
    untraced = [r for r in records if not r["traced"]]
    mean_ms = lambda k: 1e3 * float(np.mean([r[k] for r in records]))
    counters = {"zed_calls": len(records), "frames_fused": fused, "zed_lost": lost, "sessions": sessions,
                "cycles": cycles, "window_s": window_s, "last_session_zed": len(session),
                "traced_zed": sum(r["traced"] for r in records),
                "traced_fused": sum(r["traced"] and r["fused"] for r in records),
                "track_ms_mean": mean_ms("track"), "rectify_ms_mean": mean_ms("rect"),
                "depth_ms_mean": mean_ms("depth"), "feed_ms_mean": mean_ms("feed"),
                "visible_max": max(r["visible"] for r in records), "alloc_failures": session[-1]["alloc_failures"]}
    counters.update({k: after[k] - before[k] for k in after if k in before})
    if stages is not None:
        counters["traced_d2h"] = stages.pop("d2h")
        counters.update({f"device_ms.{k[3:]}": 1e3 * v["device_s"] / max(v["calls"], 1) for k, v in stages.items()})
    dropped = sum(r["tracked"] and not r["fused"] for r in records)
    fused_lost = sum(r["fused"] and not r["tracked"] for r in records)
    work_frames = _traced_session(records) if tracing else []

    # --- the check, after the window: the program's map, then its state freed
    prog = _program_blocks(system.map)
    system = None
    records = None
    half = data.raw.shape[2] // 2
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rectified = lambda i: rectifier.rectify(up(data.raw[i][:, :half]), up(data.raw[i][:, half:]))
    numbers = check(cfg, tr, dev, data, wts, rectified, kept, session, prog, lost / max(counters["zed_calls"], 1),
                    dropped, fused_lost)
    if work_frames:
        counters["traced_work"] = fusion_work(cfg, dev, rectified, work_frames)
    return dict(e2e=e2e, attempted=counters["zed_calls"], failed=counters["zed_calls"] - fused,
                spans={"stereo_call": [r["track"] for r in untraced]}, program=program, counters=counters,
                trace=trace, dense=stages and stages[DENSE_SPAN], numbers=numbers, peak_bytes=peak)


def _device_by_span(prof) -> dict:
    """Of the profiled cycles, for each of the program's ranges in
    `STAGES`: `calls`, its ranges on the host, and `device_s`, the device
    seconds of the work launched inside them (each device record is
    linked to the host operation that launched it, a replayed graph's to
    the range around the replay); and `d2h`, device-to-host copies
    launched inside `ra.stereo.dense` or `ra.facade.upload` (the depth's
    way to the fuse kernel)."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = {name: [(e.thread, e.time_range.start, e.time_range.end) for e in host if e.name == name]
              for name in STAGES + (UPLOAD_SPAN,)}

    def inside(e, name):
        return any(th == e.thread and a <= e.time_range.start and e.time_range.end <= b for th, a, b in ranges[name])

    out = {name: {"calls": len(ranges[name]), "device_s": 0.0} for name in STAGES}
    d2h = 0
    for e in host:
        # a legacy profiler's own device time of an event is named after it
        kernels = [k for k in e.kernels if k.name != e.name]
        if not kernels:
            continue
        for name in STAGES:
            if inside(e, name):
                out[name]["device_s"] += 1e-6 * sum(k.duration for k in kernels)
        if inside(e, DENSE_SPAN) or inside(e, UPLOAD_SPAN):
            d2h += sum("DtoH" in k.name for k in kernels)
    out["d2h"] = d2h
    return out


def _traced_session(records) -> list:
    """(index, fused cam_T_world [4, 4], traced) of the fused pairs of the
    session that holds the profiled cycles, from its start to its last
    traced pair."""
    traced = [k for k, r in enumerate(records) if r["traced"] and r["fused"]]
    if not traced:
        return []
    session = records[traced[0]]["session"]
    return [(r["index"], _matrix(*r["fused_pose"]), r["traced"]) for r in records[:traced[-1] + 1]
            if r["session"] == session and r["fused"]]


def fusion_work(cfg, dev, rectified, frames) -> list:
    """(visible blocks, updated voxels) of each traced pair of `frames`
    (`_traced_session`'s): the reference's replay of the geometry alone
    from the session's start, on the reference's dense depth of the
    program's rectified pairs (which voxels a pair updates depends on
    depth and pose, not on colour or segmentation)."""
    import cv2

    m = cfg["map"]
    size = (m["width"], m["height"])
    rm = fusion.RefMap(map_spec(cfg), dev)
    zero = torch.zeros((size[1], size[0], 3), device=dev)
    one = torch.ones((size[1], size[0]), device=dev)
    work = []
    for i, pose, traced in frames:
        l, r = rectified(i)
        depth, _ = reference_depth(cfg, ref_stereo.gray(l), ref_stereo.gray(r))
        depth = cv2.resize(depth.cpu().numpy(), size, interpolation=cv2.INTER_NEAREST)
        n = rm.integrate(torch.from_numpy(depth).to(dev), zero, one, one,
                         torch.as_tensor(pose, dtype=torch.float32, device=dev))
        if traced:
            work.append(n)
    return work


def _program_quantities(records, recs) -> dict:
    """Means, in ms, of the program's spans over the pairs outside the
    profiled cycles: `stereo.dense`, `slam.stereo_depth` and
    `rectify.remap` + `rectify.to_host` a pair, `facade.feed_rgbd` a fused
    pair."""
    totals = [spans.frame_totals(x) for x in spans.assign(recs, [(r["start"], r["end"]) for r in records])]
    pairs = [(r, tot) for r, tot in zip(records, totals) if not r["traced"]]
    mean = lambda xs: 1e3 * sum(xs) / len(xs) if xs else None
    return {"dense_ms": mean([t["stereo.dense"] for r, t in pairs if r["fused"] and "stereo.dense" in t]),
            "stereo_depth_ms": mean([t.get("slam.stereo_depth", 0.0) for _, t in pairs if "facade.feed_stereo" in t]),
            "rectify_ms": mean([t.get("rectify.remap", 0.0) + t.get("rectify.to_host", 0.0)
                                for _, t in pairs if "rectify.remap" in t]),
            "feed_rgbd_ms": mean([t["facade.feed_rgbd"] for r, t in pairs if r["fused"] and "facade.feed_rgbd" in t])}


def reference_depth(cfg, gray_l, gray_r, control: bool = False):
    """The reference's dense depth of a rectified pair of gray images, at
    its rectification's fx * baseline; `control`: its aggregated costs in
    bfloat16."""
    ds = cfg["dense_stereo"]
    fxb = float(abs(_projections(cfg)[1][0, 3]))
    return ref_stereo.depth(gray_l, gray_r, fxb, ds["max_disparity"], block=ds["block"],
                            census_radius=ds["census_radius"], min_depth=ds["min_depth"],
                            max_depth=ds["max_depth"], uniqueness=ds["uniqueness"],
                            agg_dtype=torch.bfloat16 if control else torch.float32)


def _rectify(dev, raw: np.ndarray, maps, maps_dtype=torch.float32):
    """The reference's rectified (left, right) uint8 [h, w, 3] of a raw
    pair, at `_reference_maps`'s maps."""
    half = raw.shape[1] // 2
    t = torch.from_numpy(raw).to(dev)
    return [rig.remap(v, mx, my, maps_dtype) for v, (mx, my) in zip((t[:, :half], t[:, half:]), maps)]


def _replay(cfg, dev, rectified, wts, frames, control: bool = False) -> fusion.RefMap:
    """The reference map after the fused pairs `frames` (index, cam_T_world
    [4, 4]): each pair's rectified images (`rectified(index)`), their
    dense depth, the left image and the depth resized to the map's size
    as the facade does (cv2 INTER_LINEAR / INTER_NEAREST), segmented by
    the float32 UNet and fused; `control` at the precision below (bf16
    costs, depth, pose and payload, fp8 convolutions, 7-bit colour)."""
    import cv2

    m = cfg["map"]
    size = (m["width"], m["height"])
    rm = fusion.RefMap(map_spec(cfg), dev, dtype=torch.bfloat16 if control else torch.float32)
    levels = len(cfg["segmentation"]["widths"])
    for i, pose in frames:
        l, r = rectified(i)
        depth, _ = reference_depth(cfg, ref_stereo.gray(l), ref_stereo.gray(r), control)
        colour = cv2.resize(l.cpu().numpy(), size, interpolation=cv2.INTER_LINEAR)
        depth = cv2.resize(depth.cpu().numpy(), size, interpolation=cv2.INTER_NEAREST)
        if control:
            colour = (colour & 0xFE).astype(np.uint8)
            depth = torch.from_numpy(depth).to(torch.bfloat16).float().numpy()
            pose = track.bf16(pose)
        rgb_t = torch.from_numpy(colour).to(dev)
        ht, lt = rig.segment(wts, rgb_t, levels, conv_dtype="fp8" if control else None)
        rm.integrate(torch.from_numpy(depth).to(dev), rgb_t.float(), ht, lt,
                     torch.as_tensor(pose, dtype=torch.float32, device=dev))
    return rm


def check(cfg, tr, dev, data, wts, rectified, kept, session, prog, lost_share: float, dropped: int,
          fused_lost: int):
    """The numbers that decide `correct`. `frame_rect`: the largest
    |difference| in levels from the reference's remap, of the kept pairs
    (pair -> the program's rectified left, right and depth of the window)
    and of the program's rectification repeated after the window
    (`rectified(pair)`, which the map's replay takes) of every fused pair
    of the last session. Of the kept pairs: `frame_repeat` the largest
    |difference| of the window's rectification from the repeat;
    `dense_valid` the share of pixels whose validity differs from
    the reference's dense depth of the program's rectified pair, and
    `dense_depth` the largest relative |difference| of depth where both
    are valid. Of the last session (its records as `run` keeps them):
    `pose_at_stamp` the largest |difference| of a fused cam_T_world's
    entries from its pair's tracked pose; the map against the
    reference's replay; the tracked poses against the truth. Over the
    window: `zed_dropped` the tracked pairs not fused, `zed_fused_lost`
    the pairs fused while lost, `track_lost` the share lost."""
    maps = _reference_maps(cfg, dev)
    as_t = lambda a: (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(dev)
    gap = lambda a, b: (a.to(torch.int32) - b.to(torch.int32)).abs()
    rect, repeat, rect_means, flips, pixels, rel = 0.0, 0.0, [], 0, 0, 0.0

    def judged(i, got=None):
        """The program's repeated rectification of pair `i` (or `got`),
        its gap from the reference's remap taken into `frame_rect`."""
        nonlocal rect
        got = rectified(i) if got is None else got
        for g, want in zip(got, _rectify(dev, data.raw[i], maps)):
            diff = gap(as_t(g), want)
            rect = max(rect, float(diff.max()))
            rect_means.append(float(diff.float().mean()))
        return got

    for i in sorted(kept):
        got_l, got_r, got_d = (as_t(a) for a in kept[i])
        judged(i, (got_l, got_r))
        for again, got in zip(rectified(i), (got_l, got_r)):
            repeat = max(repeat, float(gap(got, as_t(again)).max()))
        want_d, want_v = reference_depth(cfg, ref_stereo.gray(got_l), ref_stereo.gray(got_r))
        got_d = got_d.float()
        got_v = got_d > 0
        flips += int((got_v != want_v).sum())
        pixels += want_v.numel()
        both = got_v & want_v
        if bool(both.any()):
            rel = max(rel, float(((got_d - want_d).abs() / want_d)[both].max()))

    pose_gap, frames = 0.0, []
    for r in session:
        if r["fused"]:
            got = _matrix(*r["fused_pose"])
            pose_gap = max(pose_gap, float(np.abs(got - _matrix(*r["pose"])).max()))
            frames.append((r["index"], got))
    rm = _replay(cfg, dev, judged, wts, frames)
    numbers = {"frame_rect": rect, "frame_rect_mean": float(np.mean(rect_means)) if rect_means else 0.0,
               "rect_pairs": float(len(rect_means) // 2),
               "frame_repeat": repeat,
               "dense_valid": flips / pixels if pixels else float("nan"), "dense_depth": rel,
               "dense_pairs": float(len(kept)), "pose_at_stamp": pose_gap, "zed_dropped": float(dropped),
               "zed_fused_lost": float(fused_lost), "ref_overflow": float(rm.overflow)}
    numbers.update(compare.map_numbers(prog, rm.blocks()))
    numbers["track_lost"] = float(lost_share)
    est = np.stack([_matrix(*r["pose"]) for r in session])
    numbers.update(track.combine([track.pose_errors(est, np.array([r["tracked"] for r in session]),
                                                    data.truth[[r["index"] for r in session]])]))
    return numbers


def control_session(cfg, tr, seed: int, dev, data, wts, frames: int):
    """The control in the program's place over the first `frames` pairs
    of a session: the reference's remap on bfloat16 maps, its dense depth
    on bfloat16 aggregated costs, the walk's truth in the first camera's
    frame as the tracked poses and, in bfloat16, as the fused poses.
    Returns (its rectification, kept pairs, session records, map) as
    `run` hands the program's to `check`."""
    maps = _reference_maps(cfg, dev)
    rectified = lambda i: _rectify(dev, data.raw[i], maps, torch.bfloat16)
    n = min(frames, len(data.t))
    session, fused, kept = [], [], {}
    w0 = np.linalg.inv(data.truth[0])
    for i in range(n):
        cTw = np.linalg.inv(w0 @ data.truth[i])
        at = track.bf16(cTw)
        session.append(dict(index=i, tracked=True, fused=True, pose=(cTw[:3, :3], cTw[:3, 3]),
                            fused_pose=(at[:3, :3], at[:3, 3])))
        fused.append((i, at))
    for i in sorted(i for i in kept_pairs(tr, seed) if i < n) or [0]:
        l, r = rectified(i)
        d, _ = reference_depth(cfg, ref_stereo.gray(l), ref_stereo.gray(r), control=True)
        kept[i] = (l, r, d)
    return rectified, kept, session, _replay(cfg, dev, rectified, wts, fused, control=True).blocks()


def control(cell, seed: int, frames: int, device) -> dict:
    """The numbers of the control in the program's place over the first
    `frames` pairs of a session."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="bench_control_") as work:
        data = make_inputs(cell.config, cell.traffic, seed, device)
        wts = inputs.make_segmentation_weights(cell.config, seed, device, str(Path(work) / "w.msgpack"))
        rectified, kept, session, blocks = control_session(cell.config, cell.traffic, seed, device, data, wts,
                                                           frames)
        return check(cell.config, cell.traffic, device, data, wts, rectified, kept, session, blocks, 0.0, 0, 0)
