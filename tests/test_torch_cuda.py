"""Tests of the PyTorch port that need the GPU, for its kernels, its map
and its readers: the CUDA fuse and Hamming kernels against their plain
PyTorch versions, the fusion path, raycast, meshing, sharded fusion
(against the CPU, the single map and NCCL at world size 1), slab-sharded
meshing, resizing, the UNet, a training step, dense stereo and
rectification on the card against the same on the CPU, the `.sens`
reader's JPEG colour resized on the card, nvjpeg against cv2's pixels on
the JPEG fixture, and nvjpeg's encoder. Each case that names the main
path runs the configuration `offline_eval --synthetic` fuses at (VGA,
1 cm voxels, 2^17 blocks, 2^19 hash slots, 16384 visible blocks).

They skip where torch sees no CUDA device. This file imports no JAX, so
that it runs on a machine without it; tests/conftest.py does import JAX,
so run the card's tests there as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda*.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu_torch.map import voxel_map as vm
from ra_slam_tpu_torch.map.meshing import extract_mesh
from ra_slam_tpu_torch.map.raycast import raycast
from ra_slam_tpu_torch.map.synthetic_map import analytic_box_map
from ra_slam_tpu_torch.ops import hamming, tsdf_fuse
from ra_slam_tpu_torch.utils.convert import voxel_map_from_numpy, voxel_map_to_numpy

HERE = os.path.dirname(os.path.abspath(__file__))

# Every bound of this file.
TOL = {
    # kernel vs plain, and one frame's fusion card vs CPU: the same float32
    # operations in the same order (no FMA contraction, IEEE division), so
    # only the device's log/exp/log1p and the rigid transform's sums differ
    "tsdf": 2e-5, "weight": 2e-5, "prob": 2e-5, "rgb": 1e-3, "minabs": 2e-5,
    # card vs CPU after 12 frames of the small orbit: the log-odds' last
    # bits accumulate frame over frame
    "prob_12_frames": 1e-4,
    # the shards' union against the single map: each voxel's update is the
    # same operations on the same pixel, wherever the voxel lives
    "shard_union": 1e-5,
    # a slab-sharded mesh's triangle centroids against the gathered map's, m
    "slab_centroid_m": 1e-3,
    # raycast card vs CPU: splats within one 13-bit depth step may swap
    # winners on this share of the hits; elsewhere normal and rgba
    "ray_swapped_share": 1e-3, "ray_depth": 1e-5, "ray_normal": 1e-5, "ray_rgba": 1e-3,
    # meshing card vs CPU, in steps of the u16 dump
    "mesh_u16_steps": 1.001,
    # the bf16 UNet card vs CPU (tests/test_torch_segmentation.py's CPU-vs-
    # JAX bounds): prob, and flipped > 0.5 decisions, none of them where
    # the CPU's prob is farther than the prob bound from 0.5
    "seg_prob": 0.06, "seg_flip_share": 1e-3,
    # one float32 training step card vs CPU (TF32 off): the loss, and each
    # gradient's largest difference over its tensor's largest |g|
    "train_loss": 1e-5,
    # dense stereo card vs CPU: `valid` may differ only where a sentinel
    # cost (1e9, summed in another order) reaches the decision, left of
    # column 2 D + 8; depth is the same float32 division where both are
    # valid; against the analytic depth, coverage of the columns >= D and
    # the median relative error
    "dense_edge_share": 0.02, "dense_depth_rel": 1e-6, "dense_coverage": 0.5, "dense_median_rel": 0.05,
    # nvjpeg's pixels against cv2's (libjpeg) on the JPEG fixture: another
    # IDCT and chroma upsampling (measured on the H100: max 81 levels,
    # mean 3.11, at the fixture's block of noise)
    "jpeg_max": 96, "jpeg_mean": 4.0,
    # nvjpeg's encoder at quality 95: PSNR, and its gap to cv2's encoder
    "psnr_db": 35.0, "psnr_gap_db": 1.0,
}
PAYLOAD = ("tsdf", "weight", "prob", "rgb")
EXACT = ("block_key", "block_slot", "active", "free_stack", "free_top", "alloc_failures")
SHARDS = 4  # the main path's sharded cases: LocalMesh shards on the one card
SHARD_FRAMES = 60  # the main path's frames, sharded


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    # the rigid transforms are float32 matrix products: no TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _main_path():
    """(the VGA orbit `offline_eval --synthetic` reads, its TsdfConfig)."""
    from ra_slam_tpu_torch.pipeline import offline_eval

    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    return ds, offline_eval.system_config(ds.camera, args).tsdf


def _small_orbit(n=12):
    """(12 frames of the 160x120 orbit, its camera, a TsdfConfig at 4 cm)."""
    cfg = TsdfConfig(voxel_size=0.04, truncation=0.16, max_depth=6.0, raycast_min_weight=2.0,
                     log2_num_blocks=12, log2_hash_size=14, max_visible_blocks=2048,
                     max_new_blocks=4096, width=160, height=120)
    spec = SyntheticCameraSpec(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    ds = SyntheticBoxDataset(num_frames=n, cam=spec, radius=1.0, seed=0)
    return ds, PinholeCamera.create(80.0, 80.0, 79.5, 59.5, 160, 120), cfg


def _frame(ds, i, dev):
    """(rgb, depth, ht, lt, cam_T_world) of frame i as float32 tensors."""
    f = ds.frame(i)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(f.rgb), t(f.depth), t(f.ht), t(f.lt), SE3.from_matrix(t(f.cam_T_world))


def _payload_copy(m):
    return dataclasses.replace(m, tsdf=m.tsdf.clone(), weight=m.weight.clone(), prob=m.prob.clone(),
                               rgb=m.rgb.clone())


def _fuse_args(m, cfg, cam, rgb, depth, ht, lt, pose):
    """The fuse kernel's arguments for one frame into map `m` (allocated
    already): cull, prep and the image planes."""
    vis_idx, vis_mask, count = vm.visible_blocks(m, cam, pose, cfg)
    assert 0 < int(count) <= cfg.max_visible_blocks
    H, W = depth.shape
    pix, z, d2r, gate = vm.integrate_prep(m, vis_idx, vis_mask, H, W, cam, pose, cfg)
    return (vis_idx, vis_mask, vm.image_planes(rgb, depth, ht, lt), pix, z, d2r, gate, cfg)


def _fuse_random(dev):
    """A random pool of 300 blocks and random prep arrays for 128 slots,
    eight of them padding that points at live row 0."""
    rng = np.random.default_rng(0)
    N, V, HW = 300, 128, 5000
    cfg = TsdfConfig(log2_num_blocks=9, log2_hash_size=12, max_visible_blocks=V,
                     truncation=0.06, max_depth=6.0)
    m = vm.create_map(cfg, dev)
    m.tsdf.uniform_(-1, 1)
    m.weight.uniform_(1, 40)
    m.prob.uniform_(0, 1)
    m.rgb.uniform_(0, 255)
    t = lambda x: torch.as_tensor(x, device=dev)
    img6 = t(np.stack([rng.uniform(0.2, 6.5, HW), *rng.uniform(0, 255, (3, HW)),
                       *rng.uniform(0, 1, (2, HW))]).astype(np.float32))
    vis_idx = rng.choice(np.arange(1, N), V, replace=False).astype(np.int32)
    vis_idx[3] = 0
    vis_idx[-8:] = 0
    vis_mask = np.arange(V) < V - 8
    pix = rng.integers(0, HW, (V, 512)).astype(np.int32)
    d = img6[0].cpu().numpy()[pix]
    z = (d + rng.uniform(-0.15, 0.15, (V, 512))).astype(np.float32)
    d2r = rng.uniform(1, 1.5, (V, 512)).astype(np.float32)
    gate = ((rng.random((V, 512)) < 0.9) & vis_mask[:, None]).astype(np.float32)
    return m, (t(vis_idx), t(vis_mask), img6, t(pix), t(z), t(d2r), t(gate), cfg)


def _fuse_main_path(dev):
    """Frame 10 of the main path's orbit after frames 0-9 are fused."""
    ds, cfg = _main_path()
    m = vm.create_map(cfg, dev)
    for i in range(10):
        rgb, depth, ht, lt, pose = _frame(ds, i, dev)
        vm.integrate_frame(m, rgb, depth, ht, lt, ds.camera, pose, cfg, alloc_stride=2)
    rgb, depth, ht, lt, pose = _frame(ds, 10, dev)
    vm.allocate_from_depth(m, depth, ds.camera, pose, cfg, 2)
    return m, _fuse_args(m, cfg, ds.camera, rgb, depth, ht, lt, pose)


def _fuse_one_shard(dev):
    """Shard 0's share of frame 60 after the main path's 60 frames are
    fused over 4 hash shards: the kernel at one shard's sizes."""
    from ra_slam_tpu_torch.map.blocks import INVALID_KEY, owner_of
    from ra_slam_tpu_torch.parallel import LocalMesh, create_sharded_map, local_config, make_sharded_integrate_step

    ds, cfg = _main_path()
    mesh = LocalMesh(SHARDS, dev)
    shards = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2)
    for i in range(SHARD_FRAMES):
        rgb, depth, ht, lt, pose = _frame(ds, i, dev)
        shards, _ = step(shards, rgb, depth, ht, lt, ds.camera, pose)
    lcfg = local_config(cfg, SHARDS)
    rgb, depth, ht, lt, pose = _frame(ds, SHARD_FRAMES, dev)
    keys = vm.depth_to_candidate_keys(depth, ds.camera, pose, lcfg, 2)
    vm.allocate_keys(shards[0], torch.where(owner_of(keys, SHARDS) == 0, keys, INVALID_KEY))
    return shards[0], _fuse_args(shards[0], lcfg, ds.camera, rgb, depth, ht, lt, pose)


FUSE_CASES = {"random": _fuse_random, "main_path_frame_10": _fuse_main_path, "one_shard_of_4": _fuse_one_shard}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSE_CASES))
def test_tsdf_fuse_kernel_matches_plain(cuda, case):
    """The kernel and its plain version from the same state: the payload
    and each slot's least |tsdf| within TOL, zero for a masked slot, the
    same blocks released by the carve, some voxel updated and no row
    outside the unmasked slots touched; a random pool, the main path's
    frame 10, and one shard's share of a frame."""
    m, args = FUSE_CASES[case](cuda)
    vis_idx, vis_mask, cfg = args[0], args[1], args[-1]
    a, b = _payload_copy(m), _payload_copy(m)
    n0 = tsdf_fuse.LAUNCHES
    ka = tsdf_fuse.tsdf_fuse_(a, *args)
    kb = tsdf_fuse.tsdf_fuse_plain_(b, *args)
    torch.cuda.synchronize()
    assert tsdf_fuse.LAUNCHES == n0 + 1
    for name in PAYLOAD:
        err = (getattr(a, name) - getattr(b, name)).abs().max().item()
        assert err <= TOL[name], (name, err)
    assert (ka - kb).abs().max().item() <= TOL["minabs"]
    assert (ka[~vis_mask] == 0).all()
    assert torch.equal(vis_mask & (ka >= cfg.carve_threshold), vis_mask & (kb >= cfg.carve_threshold))
    rows = vis_idx[vis_mask].long()
    assert (a.weight[rows] != m.weight[rows]).any()
    untouched = torch.ones(m.tsdf.shape[0], dtype=torch.bool, device=cuda)
    untouched[rows] = False
    for name in PAYLOAD:
        assert torch.equal(getattr(a, name)[untouched], getattr(m, name)[untouched]), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["orbit_160x120_12_frames", "main_path_3_frames"])
def test_integrate_frame_cuda_matches_cpu(cuda, case):
    """The fusion path on the card (CUDA kernel) against the same path on
    the CPU (plain version): 12 frames of the small orbit, and the main
    path's configuration over the VGA orbit's first 3 frames. The stats
    of every frame equal; keys, slots, the free stack, the counters and
    the hash table exactly, the payload within TOL."""
    if case == "main_path_3_frames":
        ds, cfg = _main_path()
        cam, n, prob_bound = ds.camera, 3, TOL["prob"]
    else:
        ds, cam, cfg = _small_orbit()
        n, prob_bound = 12, TOL["prob_12_frames"]
    maps = {dev: vm.create_map(cfg, dev) for dev in ("cpu", cuda)}
    n0 = tsdf_fuse.LAUNCHES
    for i in range(n):
        stats = {}
        for dev, m in maps.items():
            rgb, depth, ht, lt, pose = _frame(ds, i, dev)
            _, st = vm.integrate_frame(m, rgb, depth, ht, lt, cam, pose, cfg, alloc_stride=2)
            stats[str(dev)] = {k: int(v) for k, v in st.items()}
        assert stats["cpu"] == stats[str(cuda)], (i, stats)
    assert tsdf_fuse.LAUNCHES == n0 + n
    c, g = maps["cpu"], maps[cuda]
    for name in EXACT:
        assert torch.equal(getattr(c, name).to(cuda), getattr(g, name)), name
    assert torch.equal(c.table.key.to(cuda), g.table.key) and torch.equal(c.table.value.to(cuda), g.table.value)
    for name in PAYLOAD:
        err = (getattr(c, name).to(cuda) - getattr(g, name)).abs().max().item()
        assert err <= (prob_bound if name == "prob" else TOL[name]), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb", [
    (1000, 20000), (130, 300), (1, 1), (64, 128), (0, 17), (5, 0),
    (600, 20000),  # the tracking shape
    (17, 20001), (130, 301),  # kb % 4 != 0: rows not 16-byte aligned, 4-byte stores
    (1001, 129),  # ka not a multiple of 16, over more than one 128-row tile
    (128, 128),  # one exact 128 x 128 tile
    (0, 20000), (130, 0),  # an empty side at the bench's and a ragged width
    pytest.param(None, None, id="tracking"),  # a frame's descriptors against the landmark map
])
def test_hamming_kernel_matches_plain(cuda, ka, kb):
    """Exact: both count bits, so every distance must agree. The edge
    cases follow csrc/hamming.cu's 128 x 128 tiles; random words carry a
    planted zero and 256. `tracking`: the next frame's descriptors against
    the landmarks after 5 tracked frames of the VGA orbit."""
    if ka is None:
        a, b = _tracking_descriptors(cuda)
        ka, kb, planted = a.shape[0], b.shape[0], False
    else:
        rng = np.random.default_rng(ka * 7 + kb)
        a = torch.as_tensor(rng.integers(-2**31, 2**31, (ka, 8), dtype=np.int64).astype(np.int32), device=cuda)
        b = torch.as_tensor(rng.integers(-2**31, 2**31, (kb, 8), dtype=np.int64).astype(np.int32), device=cuda)
        planted = True
        if ka and kb:
            b[0] = a[0]  # a zero distance
        if ka and kb > 1:
            b[-1] = ~a[-1]  # the largest, 256
    n0 = hamming.LAUNCHES
    k = hamming.hamming_matrix(a, b)
    p = hamming.hamming_matrix_plain(a, b)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == n0 + (1 if ka and kb else 0)
    assert k.dtype == torch.float32 and k.shape == (ka, kb)
    assert torch.equal(k, p)
    if planted and ka and kb:
        assert k[0, 0] == 0
    if planted and ka and kb > 1:
        assert k[-1, -1] == 256


def _tracking_descriptors(dev):
    from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray

    ds, slam = tracking_setup(640, 480, device=dev)
    for i in range(5):
        fr = ds.frame(i)
        hint = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint)
    kp = detect_and_describe(rgb_to_gray(torch.as_tensor(ds.frame(5).rgb).to(dev)), slam.fcfg)
    assert int(slam.state.track.lms.valid.sum()) > 0
    return kp.desc, slam.state.track.lms.desc


def _analytic_room(cfg, dev, half_extents, rgb):
    """The analytic box room with a probability field that varies (and,
    with `rgb`, a colour field), the same on every device."""
    kw = {} if half_extents is None else {"half_extents": half_extents}
    m = analytic_box_map(cfg, dev, **kw)
    x = torch.arange(512, device=m.device)
    act = m.active[:, None]
    m.prob.copy_(torch.where(act, (x % 97).to(torch.float32) / 96.0, m.prob))
    if rgb:
        for c in range(3):
            m.rgb[:, c].copy_(torch.where(act, ((x * (7 + c)) % 256).to(torch.float32), m.rgb[:, c]))
    return m


# the analytic room of the readers' card-vs-CPU cases at VGA
ROOM_CFG = dict(voxel_size=0.04, truncation=0.12, log2_num_blocks=14, log2_hash_size=16)
MESH_CASES = {
    "room_4x3x4_chunked": (dict(ROOM_CFG), (2.0, 1.5, 2.0), False, 1000),
    "room_6x4x6_rgb": (dict(ROOM_CFG, max_visible_blocks=1 << 14, width=640, height=480), None, True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_extract_mesh_cuda_matches_cpu(cuda, case):
    """The analytic room built and meshed on each device: counts and
    indices exactly equal (the merge and first-use numbering do not
    depend on the device's sort or scatter order), vertices and
    probabilities within one u16 step; a 4 x 3 x 4 m room in chunks of
    1000 blocks, and the 6 x 4 x 6 m room with colour in one."""
    cfg_kw, he, rgb, chunk = MESH_CASES[case]
    cfg = TsdfConfig(**cfg_kw)
    out = {}
    for dev in ("cpu", cuda):
        m = _analytic_room(cfg, dev, he, rgb)
        out[str(dev)] = extract_mesh(m, cfg) if chunk is None else extract_mesh(m, cfg, chunk=chunk)
    (cv, ci, cp), (gv, gi, gp) = out["cpu"], out[str(cuda)]
    assert len(ci) > 10000
    assert ci.shape == gi.shape and cv.shape == gv.shape
    np.testing.assert_array_equal(ci, gi)
    step = (cv.max(0) - cv.min(0)) / 65535.0
    assert (np.abs(cv - gv) / step).max() <= TOL["mesh_u16_steps"]
    assert np.abs(cp - gp).max() * 65535.0 <= TOL["mesh_u16_steps"]


def _raycast_orbit(dev):
    """12 frames of the small orbit fused on the CPU, rendered at three of
    its poses."""
    ds, cam, cfg = _small_orbit()
    m = vm.create_map(cfg, "cpu")
    for i in range(12):
        rgb, depth, ht, lt, pose = _frame(ds, i, "cpu")
        vm.integrate_frame(m, rgb, depth, ht, lt, cam, pose, cfg, alloc_stride=2)
    return m, cam, cfg, [ds.frame(i).cam_T_world for i in (0, 4, 9)]


def _raycast_room(dev):
    """The 6 x 4 x 6 m analytic room with colour, rendered at frame 0's
    pose of the main path's VGA orbit."""
    ds, _ = _main_path()
    cfg = TsdfConfig(**MESH_CASES["room_6x4x6_rgb"][0])
    pose = np.linalg.inv(ds.world_T_cam(0).astype(np.float64)).astype(np.float32)
    return _analytic_room(cfg, "cpu", None, True), ds.camera, cfg, [pose]


RAYCAST_CASES = {"orbit_160x120": _raycast_orbit, "room_vga": _raycast_room}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RAYCAST_CASES))
def test_raycast_cuda_matches_cpu(cuda, case):
    """A map on the CPU carried to the card and rendered on both: hit mask
    and dropped count equal; depth within 1e-5 but where two splats within
    one 13-bit step swap (<= 0.1% of hits, within one step); normal 1e-5
    and rgba 1e-3 away from those pixels. The small orbit fused over 12
    frames at three poses, and the analytic room at a VGA pose."""
    m, cam, cfg, poses = RAYCAST_CASES[case](cuda)
    maps = {"cpu": m, str(cuda): voxel_map_from_numpy(voxel_map_to_numpy(m), cuda)}
    zstep = (cfg.max_depth - cfg.min_depth) / 8191
    for p in poses:
        outs = {}
        for dev, mm in maps.items():
            pose = SE3.from_matrix(torch.as_tensor(p, device=mm.device))
            outs[dev] = {k: v.cpu().numpy() for k, v in raycast(mm, cam, pose, cfg).items()}
        c, g = outs["cpu"], outs[str(cuda)]
        np.testing.assert_array_equal(c["hit"], g["hit"])
        assert int(c["dropped_splats"]) == int(g["dropped_splats"]) and c["hit"].sum() > 1000
        dz = np.abs(c["depth"] - g["depth"])
        flipped = dz > TOL["ray_depth"]
        assert flipped.sum() <= TOL["ray_swapped_share"] * c["hit"].sum() and dz.max() <= zstep + TOL["ray_depth"]
        near = flipped.copy()
        for ax in (0, 1):
            for sh in (-1, 1):
                near |= np.roll(flipped, sh, axis=ax)
        assert np.abs(c["normal"] - g["normal"])[~near].max() <= TOL["ray_normal"]
        assert np.abs(c["rgba"] - g["rgba"])[~near].max() <= TOL["ray_rgba"]


def test_hamming_rejects_bad_inputs():
    a = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        hamming.hamming_matrix(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a[:, :7], a)


# (height, width, channels or None, dtype) of the source, the target width
# and height; each resized both ways
RESIZE_CASES = {
    "u8_rgb_1296x968_to_640x480": ((968, 1296, 3), np.uint8, 640, 480),
    "u8_rgb_160x120_to_333x250": ((120, 160, 3), np.uint8, 333, 250),
    "f32_50x35_to_64x48": ((35, 50), np.float32, 64, 48),
    "u8_rgb_320x240_to_640x480": ((240, 320, 3), np.uint8, 640, 480),
    "f32_50x35_to_640x480": ((35, 50), np.float32, 640, 480),
    "f32_depth_1296x968_to_640x480": ((968, 1296), np.float32, 640, 480),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_resize_cuda_matches_cpu(cuda, case):
    """ops/resize.py on the card against the CPU, exactly, linear and
    nearest: integer sums (uint8) and separate float32 operations,
    indices from the host."""
    from ra_slam_tpu_torch.ops.resize import resize

    shape, dtype, w, h = RESIZE_CASES[case]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8 else rng.random(shape).astype(dtype)
    for how in ("linear", "nearest"):
        a = resize(torch.as_tensor(img), w, h, how)
        b = resize(torch.as_tensor(img, device=cuda), w, h, how)
        assert b.device.type == "cuda" and torch.equal(a, b.cpu()), how


RESIZE_SIZES = [
    ((968, 1296), (480, 640)),  # ScanNet's colour to its depth size
    ((480, 640), (240, 320)),
    ((240, 320), (480, 640)),  # upscale
    ((479, 641), (241, 320)),  # odd sizes both ways
    ((37, 1), (18, 5)),  # a 1-pixel-wide source
    ((376, 672), (188, 336)),  # the ZED's frames halved
]


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", RESIZE_SIZES, ids=[f"{s[1]}x{s[0]}->{d[1]}x{d[0]}" for s, d in RESIZE_SIZES])
def test_resize_on_card_matches_cpu_at_reader_sizes(cuda, src, dst):
    """uint8 INTER_LINEAR on the card against the CPU, bit for bit, RGB
    and grey, at the sizes the readers resize; the tables are uploaded
    once per sizes and device."""
    from ra_slam_tpu_torch.ops import resize as r

    (h, w), (H, W) = src, dst
    rng = np.random.default_rng(h * 7 + w)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb[: h // 2, : w // 2] = 255  # saturated corners: the largest sums
    rgb[h // 2:, w // 2:] = 0
    for img in (torch.as_tensor(rgb), torch.as_tensor(rgb[..., 1].copy())):
        k = r.resize_linear(img.to(cuda), W, H)
        assert k.device.type == "cuda" and k.dtype == torch.uint8
        assert torch.equal(k.cpu(), r.resize_linear(img, W, H))
    n = len(r._TABLES)
    r.resize_linear(torch.as_tensor(rgb, device=cuda), W, H)
    assert len(r._TABLES) == n


@pytest.mark.cuda
def test_jpeg_sens_resizes_on_the_card(cuda, tmp_path):
    """A JPEG `.sens` (colour 100x75, depth 64x48) read on the card:
    each frame's colour is nvjpeg's decode resized on the card, the
    bytes of that decode copied to the host and resized there; no host
    resize, by `frame` and by `prefetch`'s threads."""
    from ra_slam_tpu_torch.io import sens
    from ra_slam_tpu_torch.io.jpeg import decode_jpeg
    from ra_slam_tpu_torch.ops import resize as r

    rng = np.random.default_rng(3)
    vs, us = np.mgrid[0:75, 0:100]
    rgbs = [np.stack([us * 2 + i, vs * 3, rng.integers(0, 256, (75, 100))], -1).astype(np.uint8) for i in range(4)]
    depths = [rng.integers(500, 4000, (48, 64)).astype(np.uint16) for _ in range(4)]
    k = np.array([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]], np.float32)
    path = str(tmp_path / "j.sens")
    sens.write_sens(path, rgbs, depths, [np.eye(4, dtype=np.float32)] * 4, k,
                    color_compression=sens.COLOR_JPEG, device=cuda)
    reader = sens.SensReader(path)
    want = []
    for i in range(len(reader)):
        ofs, nbytes, _, _ = reader._blob_ofs[i]
        host = decode_jpeg(reader._blob(ofs, nbytes), cuda).cpu()
        want.append(r.resize_linear(host, 64, 48).numpy())
    for read in (lambda: [reader.frame(i) for i in range(len(reader))], lambda: list(reader.prefetch(2, 2))):
        h0 = sens.HOST_RESIZES
        frames = read()
        assert sens.HOST_RESIZES == h0
        for f, w in zip(frames, want):
            assert isinstance(f.rgb, np.ndarray) and f.rgb.dtype == np.uint8 and f.rgb.shape == (48, 64, 3)
            np.testing.assert_array_equal(f.rgb, w)
        assert len({f.rgb.ctypes.data for f in frames}) == 4  # each frame owns its colour
    reader.close()


@pytest.mark.cuda
def test_jpeg_fixture_decodes_through_nvjpeg(cuda):
    """The JPEG `.sens` fixture's colour through nvjpeg against cv2's
    pixels, within another IDCT's and chroma upsampling's bounds."""
    from ra_slam_tpu_torch.io.sens import SensReader

    data = os.path.join(HERE, "data")
    reader = SensReader(os.path.join(data, "jpeg_64x48.sens"))
    got = np.stack([reader.frame(i).rgb for i in range(len(reader))]).astype(np.int32)
    reader.close()
    d = np.abs(got - np.load(os.path.join(data, "jpeg_64x48_rgb.npy")).astype(np.int32))
    assert got.shape == (2, 48, 64, 3) and d.max() <= TOL["jpeg_max"] and d.mean() <= TOL["jpeg_mean"]


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


def _jpeg_images(case):
    """(colour frames, uint16 depths, intrinsics) of an encoder case."""
    if case == "smooth_64x48":
        vs, us = np.mgrid[0:48, 0:64]
        rgb = np.stack([us * 4, vs * 5, (us + vs) * 2], -1).astype(np.uint8)
        k = np.array([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]], np.float32)
        return [rgb], [(1000 + us * 7 + vs).astype(np.uint16)], k
    ds, _ = _main_path()
    idx = range(0, 120, 6)
    rgbs = [np.asarray(ds.frame(i).rgb).clip(0, 255).round().astype(np.uint8) for i in idx]
    depths = [np.round(np.asarray(ds.frame(i).depth) * 1000.0).astype(np.uint16) for i in idx]
    return rgbs, depths, np.array([[320.0, 0, 319.5], [0, 320.0, 239.5], [0, 0, 1]], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smooth_64x48", "orbit_vga_20_frames"])
def test_nvjpeg_encoder_round_trip(cuda, tmp_path, case):
    """Frames through nvjpeg's encoder (quality 95, 4:2:0) and decoder:
    baseline JFIF streams, each PSNR above 35 dB and within 1 dB of cv2's
    encoder at the same quality (both decoded by nvjpeg); a JPEG `.sens`
    written on the card reads back with the depth exact and the colour
    within the same bounds. A smooth 64x48 image, and 20 VGA orbit
    frames."""
    import cv2

    from ra_slam_tpu_torch.io import sens
    from ra_slam_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg

    rgbs, depths, k = _jpeg_images(case)
    p_cv = []
    for rgb in rgbs:
        data = encode_jpeg(rgb, 95, cuda)
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        back = decode_jpeg(data, cuda).cpu().numpy()
        ok, enc = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok
        p_cv.append(_psnr(decode_jpeg(enc.tobytes(), cuda).cpu().numpy(), rgb))
        assert back.shape == rgb.shape and _psnr(back, rgb) > TOL["psnr_db"]
        assert abs(_psnr(back, rgb) - p_cv[-1]) <= TOL["psnr_gap_db"]
    path = str(tmp_path / "j.sens")
    sens.write_sens(path, rgbs, depths, [np.eye(4, dtype=np.float32)] * len(rgbs), k,
                    color_compression=sens.COLOR_JPEG, device=cuda)
    r = sens.SensReader(path)
    assert r.color_compression == sens.COLOR_JPEG
    for i, (rgb, depth) in enumerate(zip(rgbs, depths)):
        np.testing.assert_array_equal(r._raw_depth(i), depth)
        p = _psnr(r.frame(i).rgb, rgb)
        assert p > TOL["psnr_db"] and p >= p_cv[i] - TOL["psnr_gap_db"]
    r.close()


def _shard_frames(case, dev):
    """(dataset, camera, config, shards, frame indices) of a sharded case."""
    if case == "orbit_2_shards":
        ds, cam, cfg = _small_orbit()
        return ds, cam, cfg, 2, range(0, 12, 2)
    ds, cfg = _main_path()
    return ds, ds.camera, cfg, SHARDS, range(SHARD_FRAMES)


def _active_rows(maps):
    """(sorted keys, payload rows) of the active blocks of `maps` together."""
    keys = torch.cat([m.block_key[m.active] for m in maps])
    order = torch.argsort(keys)
    return keys[order], {f: torch.cat([getattr(m, f)[m.active] for m in maps])[order] for f in PAYLOAD}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["orbit_2_shards", "main_path_4_shards"])
def test_sharded_fusion_cuda_matches_cpu(cuda, case):
    """LocalMesh sharded fusion on the card (the fuse kernel once per shard
    per frame, the shards' threads on one stream) against the same on the
    CPU: every shard's keys, table, free stack and counters exactly, the
    payload within the single-map test's 12-frame bounds; and on the card
    against the single map: as many active blocks, none failed, the
    shards' union within 1e-5 of it. 6 frames of the small orbit over 2
    shards, and the main path's 60 VGA frames over 4."""
    from ra_slam_tpu_torch.parallel import LocalMesh, create_sharded_map, make_sharded_integrate_step

    ds, cam, cfg, n, frames = _shard_frames(case, cuda)
    meshes = {dev: LocalMesh(n, dev) for dev in ("cpu", cuda)}
    shards = {dev: create_sharded_map(cfg, mesh) for dev, mesh in meshes.items()}
    steps = {dev: make_sharded_integrate_step(mesh, cfg, alloc_stride=2) for dev, mesh in meshes.items()}
    single = vm.create_map(cfg, cuda)
    n0 = tsdf_fuse.LAUNCHES
    for i in frames:
        stats = {}
        for dev in meshes:
            rgb, depth, ht, lt, pose = _frame(ds, i, dev)
            shards[dev], st = steps[dev](shards[dev], rgb, depth, ht, lt, cam, pose)
            stats[str(dev)] = {k: int(v) for k, v in st.items()}
        assert stats["cpu"] == stats[str(cuda)], (i, stats)
        rgb, depth, ht, lt, pose = _frame(ds, i, cuda)
        _, st1 = vm.integrate_frame(single, rgb, depth, ht, lt, cam, pose, cfg, alloc_stride=2)
    assert tsdf_fuse.LAUNCHES == n0 + (n + 1) * len(frames)
    for c, g in zip(shards["cpu"], shards[cuda]):
        for name in ("block_key", "block_slot", "active", "free_top", "alloc_failures"):
            assert torch.equal(getattr(c, name).to(cuda), getattr(g, name)), name
        assert torch.equal(c.table.key.to(cuda), g.table.key)
        top = int(c.free_top)
        assert torch.equal(c.free_stack[:top].to(cuda), g.free_stack[:int(g.free_top)])
        for name in PAYLOAD:
            err = (getattr(c, name).to(cuda) - getattr(g, name)).abs().max().item()
            assert err <= (TOL["prob_12_frames"] if name == "prob" else TOL[name]), (name, err)
    assert stats[str(cuda)]["num_active"] == int(st1["num_active"]) and stats[str(cuda)]["alloc_failures"] == 0
    keys_s, rows_s = _active_rows(shards[cuda])
    keys_1, rows_1 = _active_rows([single])
    assert torch.equal(keys_s, keys_1)
    for name in PAYLOAD:
        assert (rows_s[name] - rows_1[name]).abs().max().item() <= TOL["shard_union"], name


@pytest.mark.cuda
def test_process_group_mesh_over_nccl_matches_local_mesh(cuda):
    """One shard in this process (`LocalMesh(1)`) and over NCCL at world
    size 1 (`ProcessGroupMesh`) fuse the main path's 60 VGA frames into
    the same map bit for bit, with the same stats."""
    import torch.distributed as dist

    from ra_slam_tpu_torch.parallel import LocalMesh, ProcessGroupMesh, create_sharded_map, make_sharded_integrate_step
    from ra_slam_tpu_torch.pipeline.bench_scaling import free_port

    ds, cfg = _main_path()
    frames = [_frame(ds, i, cuda) for i in range(SHARD_FRAMES)]

    def fuse(mesh):
        shards = create_sharded_map(cfg, mesh)
        step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2)
        for rgb, depth, ht, lt, pose in frames:
            shards, stats = step(shards, rgb, depth, ht, lt, ds.camera, pose)
        return shards[0], {k: int(v) for k, v in stats.items()}

    one, st_one = fuse(LocalMesh(1, cuda))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        pg, st_pg = fuse(ProcessGroupMesh())
    finally:
        dist.destroy_process_group()
    assert st_one == st_pg
    assert torch.equal(one.table.key, pg.table.key) and torch.equal(one.table.value, pg.table.value)
    for f in dataclasses.fields(one):
        if f.name != "table":
            assert torch.equal(getattr(one, f.name), getattr(pg, f.name)), f.name


@pytest.mark.cuda
def test_slab_shards_mesh_as_the_gathered_map(cuda):
    """The main path's 60 VGA frames fused over 4 slab shards (cells of 2
    blocks), then meshed by `extract_mesh_sharded` in both modes: as many
    triangles as the gathered map's `extract_mesh`, nothing dropped by
    the gather or the halo export, every triangle's centroid within 1 mm
    of one of the other mesh's, both ways."""
    from scipy.spatial import cKDTree

    from ra_slam_tpu_torch.parallel import LocalMesh, create_sharded_map, make_gather_shards, make_sharded_integrate_step
    from ra_slam_tpu_torch.parallel.sharded_map import extract_mesh_sharded

    ds, cfg = _main_path()
    mesh = LocalMesh(SHARDS, cuda)
    slab = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2, owner_mode="slab", cell_log2=1)
    for i in range(SHARD_FRAMES):
        rgb, depth, ht, lt, pose = _frame(ds, i, cuda)
        slab, stats = step(slab, rgb, depth, ht, lt, ds.camera, pose)
    assert int(stats["alloc_failures"]) == 0
    g, dropped = make_gather_shards(mesh, cfg)[0](slab)
    assert int(dropped) == 0
    vg, tg, _ = extract_mesh(g, cfg)
    del g
    cg = vg[tg].mean(axis=1)
    tree_g = cKDTree(cg)
    for mode in ("parallel", "sequential"):
        v, t, _, info = extract_mesh_sharded(slab, mesh, cfg, cell_log2=1, mode=mode)
        assert len(t) == len(tg) and info["dropped"] == 0, (mode, info)
        cs = v[t].mean(axis=1)
        assert tree_g.query(cs, workers=-1)[0].max() < TOL["slab_centroid_m"], mode
        assert cKDTree(cs).query(cg, workers=-1)[0].max() < TOL["slab_centroid_m"], mode


# (weights, UNet widths, frames); the trained net's frames are held out
# from its training set, the random net's is the main path's first
UNET_CASES = {
    "trained_16_32_64": ("demo_seg", (16, 32, 64), "held_out"),
    "default_widths_random": ("__random__", (32, 64, 128, 256), "vga"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_cuda_matches_cpu(cuda, case):
    """The UNet on the card and on the CPU (bf16, TF32 off), the same
    weights: ht prob within 0.06, and no decision flipped where the CPU's
    prob is farther than that from 0.5. The committed (16, 32, 64)
    weights on two held-out 320x240 frames, at most 1e-3 of the decisions
    flipped; the default widths with random weights on a VGA frame."""
    from ra_slam_tpu_torch.models.segmentation import InferenceEngine

    model, widths, frames = UNET_CASES[case]
    if frames == "held_out":
        model = os.path.join(os.path.dirname(HERE), "ra_slam_tpu", "models", "demo_seg.msgpack")
        spec = SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5, width=320, height=240)
        ds = SyntheticBoxDataset(num_frames=16, cam=spec, radius=1.0, seed=3, clutter=4)
        rgbs = [ds.frame(i).rgb for i in (0, 1)]
    else:
        rgbs = [_main_path()[0].frame(0).rgb]
    h, w = rgbs[0].shape[:2]
    c, g = (np.stack([InferenceEngine(model, w, h, widths=widths, device=d).segment(torch.as_tensor(x))[0]
                      .cpu().numpy() for x in rgbs]) for d in ("cpu", cuda))
    flipped = (c > 0.5) != (g > 0.5)
    assert np.abs(c - g).max() <= TOL["seg_prob"]
    assert not (flipped & (np.abs(c - 0.5) > TOL["seg_prob"])).any()
    if frames == "held_out":
        assert flipped.mean() <= TOL["seg_flip_share"]
    assert torch.backends.cudnn.allow_tf32  # the engine restores the flag it clears for its call


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,f,d", [(240, 180, 120.0, 32), (672, 376, 350.0, 64)],
                         ids=["240x180_d32", "zed_672x376_d64"])
def test_dense_stereo_cuda_matches_cpu(cuda, w, h, f, d):
    """`dense_stereo_depth` of one synthetic pair (0.12 m baseline, the
    room's 0.125 m texture), card against CPU: `valid` equal where no
    sentinel cost reaches the decision (columns >= 2 D + 8), at most 2% of
    the pixels left of them differing, depth the same float32 division
    where both are valid; on the card, more than half the columns >= D
    covered and the median relative error against the analytic depth
    below 5%. At 240x180 with D = 32, and at the ZED's 672x376 with
    io/cameras.py's D = 64."""
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.features.stereo import dense_stereo_depth
    from ra_slam_tpu_torch.io.synthetic import look_at, render_box_room

    spec = SyntheticCameraSpec(fx=f, fy=f, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
    w_T_l = look_at(np.array([0.3, 0.0, 0.0]), np.array([0.0, 0.0, 1.5]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * 0.12
    he = np.array([2.0, 1.5, 2.0])
    (left, depth_gt, _, _), right = render_box_room(spec, w_T_l, he, checker=0.125), \
        render_box_room(spec, w_T_r, he, checker=0.125)[0]
    out = {}
    for dev in ("cpu", cuda):
        gl, gr = (rgb_to_gray(torch.as_tensor(a, device=dev)) for a in (left, right))
        out[str(dev)] = [t.cpu().numpy() for t in dense_stereo_depth(gl, gr, f * 0.12, max_disparity=d)]
    (cd, cv), (gd, gv) = out["cpu"], out[str(cuda)]
    edge = 2 * d + 8
    np.testing.assert_array_equal(cv[:, edge:], gv[:, edge:])
    assert (cv != gv)[:, :edge].mean() <= TOL["dense_edge_share"]
    both = cv & gv
    assert both.mean() > 0.3 and (np.abs(cd[both] - gd[both]) / cd[both]).max() <= TOL["dense_depth_rel"]
    assert gv[:, d:].mean() > TOL["dense_coverage"]
    assert np.median(np.abs(gd[gv] - depth_gt[gv]) / depth_gt[gv]) < TOL["dense_median_rel"]


# tests/test_capture.py's ZED factory calibration (HD)
ZED_CONF = """
[LEFT_CAM_HD]
fx=700.1
fy=700.2
cx=640.3
cy=360.4
k1=-0.17
k2=0.026
k3=0.0
p1=0.0001
p2=-0.0002

[RIGHT_CAM_HD]
fx=701.0
fy=701.1
cx=639.0
cy=361.0
k1=-0.171
k2=0.027

[STEREO]
Baseline=119.887
RX_HD=0.0021
CV_HD=0.0058
RZ_HD=-0.0009
"""


def _zed_calib(case, tmp_path, w, h):
    from ra_slam_tpu_torch.core import rectify

    if case == "zed_like":
        mono = rectify.CalibMono(367.6, 367.7, 336.2, 188.2, [-0.17, 0.026, 0.0001, -0.0002, 0.0])
        return rectify.CalibStereo(mono, mono, [0.0021, 0.0058, -0.0009], [-0.12, 0.0, 0.0])
    from ra_slam_tpu_torch.io.capture import parse_zed_conf

    path = tmp_path / "SN000.conf"
    path.write_text(ZED_CONF)
    c = parse_zed_conf(str(path), "720p")
    sx, sy = w / 1280, h / 720
    mono = lambda m: rectify.CalibMono(m["fx"] * sx, m["fy"] * sy, m["cx"] * sx, m["cy"] * sy,
                                       [m["k1"], m["k2"], m["p1"], m["p2"], m["k3"]])
    return rectify.CalibStereo(mono(c["left"]), mono(c["right"]), c["rotation"], [-c["baseline"], 0.0, 0.0])


@pytest.mark.cuda
@pytest.mark.parametrize("calib", ["zed_like", "zed_conf_720p_scaled"])
def test_remap_cuda_matches_cpu(cuda, tmp_path, calib):
    """`remap_linear` on the card equals the CPU exactly (float64 steps,
    each rounded to float32 as on the CPU), and a rectifier's uint8 pair
    at 672x376 too: from a ZED-like calibration, and from a ZED's
    factory `.conf` at 720p scaled to the pair's size."""
    from ra_slam_tpu_torch.core import rectify

    rng = np.random.default_rng(0)
    h, w = 376, 672
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mx = rng.uniform(-3, w + 2, (h, w)).astype(np.float32)
    my = rng.uniform(-3, h + 2, (h, w)).astype(np.float32)
    got = {}
    for dev in ("cpu", cuda):
        plan = rectify.remap_plan(torch.as_tensor(mx, device=dev), torch.as_tensor(my, device=dev), (h, w))
        got[str(dev)] = rectify.remap_linear(torch.as_tensor(img, device=dev), plan).cpu()
    assert torch.equal(got["cpu"], got[str(cuda)])
    rect = rectify.StereoRectifier((w, h), _zed_calib(calib, tmp_path, w, h), device=cuda)
    pair = [img, rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]
    a = rect.rectify(*(torch.as_tensor(x) for x in pair))
    b = rect.rectify(*(torch.as_tensor(x, device=cuda) for x in pair))
    assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))


def _load_script(name):
    """A module of scripts/ by file path (scripts/ is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(HERE), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_case(case):
    """(a float32 net's parameters as a state dict, a batch, the gradient
    bound, the learning rate) of a training-step case."""
    from ra_slam_tpu_torch.models.segmentation import SegmentationNet, init_params_

    if case == "net_16_32_64x96":
        rng = np.random.default_rng(0)
        x = rng.random((2, 3, 64, 96), dtype=np.float32)
        y = rng.integers(-1, 2, (2, 64, 96))
        ref = SegmentationNet((16, 32), dtype=torch.float32)
        init_params_(ref, torch.Generator().manual_seed(0))
        # sums of ~1e4 float32 terms in other orders (measured on the
        # H100: 8.2e-6 with TF32 off, 8.2e-4 for the control)
        return (lambda: SegmentationNet((16, 32), dtype=torch.float32)), ref.state_dict(), x, y, 1e-4, 3e-4
    trainer = _load_script("train_torch_semantic")
    x, y = trainer.batch_arrays(trainer.frames(seed=0, n=trainer.BATCH))
    ref = trainer.load_net(trainer.INIT, dtype=torch.float32)
    # the trainer's (16, 32, 64) net and batch: sums of ~3e5 terms, the
    # conv biases' mostly cancelling (measured on the H100: 2.76e-4 with
    # TF32 off, 1.17e-2 for the control)
    return (lambda: trainer.load_net(trainer.INIT, dtype=torch.float32)), ref.state_dict(), x, y, 1e-3, trainer.LR


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["net_16_32_64x96", "trainer_16_32_64"])
def test_train_step_cuda_matches_cpu(cuda, case):
    """One float32 training step (TF32 off) on the card and on the CPU
    from the same parameters and batch: the loss within 1e-5 and each
    gradient within the case's bound of its tensor's largest |g|, while
    the same gradients with cuDNN's TF32 on (the control) land above that
    bound somewhere. A (16, 32) net on a 64x96 batch, and
    scripts/train_torch_semantic.py's net from the committed JAX init on
    its own batch."""
    from ra_slam_tpu_torch.models.segmentation import make_train_step, masked_cross_entropy

    make_net, state, x, y, grad_tol, lr = _train_case(case)
    out = {}
    for dev in ("cpu", cuda, "tf32"):
        net = make_net()
        net.load_state_dict(state)
        d = cuda if dev == "tf32" else dev
        net.to(d)
        xd, yd = torch.as_tensor(x, device=d), torch.as_tensor(y, device=d)
        if dev == "tf32":
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                loss = masked_cross_entropy(net(xd), yd)
                loss.backward()
            finally:
                torch.backends.cudnn.allow_tf32 = saved
            loss = float(loss.detach())
        else:
            step = make_train_step(net, torch.optim.Adam(net.parameters(), lr=lr))
            loss = float(step(xd, yd))
        out[str(dev)] = loss, {n: p.grad.cpu() for n, p in net.named_parameters()}
    (lc, gc), (lg, gg), (_, gt) = out["cpu"], out[str(cuda)], out["tf32"]
    rel = {k: {n: float((gk[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)) for n, g in gc.items()}
           for k, gk in (("card", gg), ("tf32", gt))}
    print(f"card vs CPU worst {max(rel['card'].values()):.3g}, TF32 control worst {max(rel['tf32'].values()):.3g}")
    assert abs(lc - lg) <= TOL["train_loss"]
    for n, err in rel["card"].items():
        assert err <= grad_tol, (n, err)
    assert max(rel["tf32"].values()) > grad_tol, rel["tf32"]
