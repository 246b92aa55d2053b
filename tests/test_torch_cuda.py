"""Tests of the PyTorch port that need the GPU: the CUDA fuse and
Hamming kernels against their plain PyTorch versions, the `.sens`
reader's JPEG colour resized on the card, the fusion path,
raycast, meshing, resizing, the UNet, a training step, dense stereo and
rectification on the card against the same on the CPU, sharded fusion
on a LocalMesh on the card against the CPU, nvjpeg against cv2's pixels
on the JPEG fixture, and nvjpeg's encoder round trip. They
skip where torch sees no CUDA device. This file imports no JAX, so that it runs on a machine without
it; tests/conftest.py does import JAX, so run it there as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

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

# kernel vs plain: the same operations in the same order (no FMA
# contraction, IEEE division), so only the device's log/exp/log1p differ
TOL = {"tsdf": 2e-5, "weight": 2e-5, "prob": 2e-5, "rgb": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    # the rigid transforms are float32 matrix products: no TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


@pytest.mark.cuda
def test_tsdf_fuse_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    N, V, HW = 300, 128, 5000
    cfg = TsdfConfig(log2_num_blocks=9, log2_hash_size=12, max_visible_blocks=V,
                     truncation=0.06, max_depth=6.0)
    a = vm.create_map(cfg, cuda)
    a.tsdf.uniform_(-1, 1)
    a.weight.uniform_(1, 40)
    a.prob.uniform_(0, 1)
    a.rgb.uniform_(0, 255)
    before = voxel_map_to_numpy(a)
    b = vm.create_map(cfg, cuda)
    for name in ("tsdf", "weight", "prob", "rgb"):
        getattr(b, name).copy_(getattr(a, name))

    t = lambda x: torch.as_tensor(x, device=cuda)
    img6 = t(np.stack([rng.uniform(0.2, 6.5, HW), *rng.uniform(0, 255, (3, HW)),
                       *rng.uniform(0, 1, (2, HW))]).astype(np.float32))
    vis_idx = rng.choice(np.arange(1, N), V, replace=False).astype(np.int32)
    vis_idx[3] = 0
    vis_idx[-8:] = 0  # padding slots point at live row 0
    vis_mask = np.arange(V) < V - 8
    pix = rng.integers(0, HW, (V, 512)).astype(np.int32)
    d = img6[0].cpu().numpy()[pix]
    z = (d + rng.uniform(-0.15, 0.15, (V, 512))).astype(np.float32)
    d2r = rng.uniform(1, 1.5, (V, 512)).astype(np.float32)
    gate = ((rng.random((V, 512)) < 0.9) & vis_mask[:, None]).astype(np.float32)
    args = (t(vis_idx), t(vis_mask), img6, t(pix), t(z), t(d2r), t(gate), cfg)

    n0 = tsdf_fuse.LAUNCHES
    ka = tsdf_fuse.tsdf_fuse_(a, *args)
    kb = tsdf_fuse.tsdf_fuse_plain_(b, *args)
    torch.cuda.synchronize()
    assert tsdf_fuse.LAUNCHES == n0 + 1
    for name, bound in TOL.items():
        err = (getattr(a, name) - getattr(b, name)).abs().max().item()
        assert err <= bound, (name, err)
    assert (ka - kb).abs().max().item() <= 2e-5
    assert (ka[~args[1]] == 0).all()
    # rows of no unmasked slot are untouched
    untouched = np.setdiff1d(np.arange(N), vis_idx[vis_mask])
    after = voxel_map_to_numpy(a)
    for name in TOL:
        np.testing.assert_array_equal(getattr(after, name)[untouched], getattr(before, name)[untouched])


@pytest.mark.cuda
def test_integrate_frame_cuda_matches_cpu(cuda):
    """The fusion path on the card (CUDA kernel) against the same path on
    the CPU (plain version): 12 frames of the small synthetic orbit."""
    cfg = TsdfConfig(voxel_size=0.04, truncation=0.16, max_depth=6.0,
                     log2_num_blocks=12, log2_hash_size=14, max_visible_blocks=2048,
                     max_new_blocks=4096, width=160, height=120)
    spec = SyntheticCameraSpec(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    ds = SyntheticBoxDataset(num_frames=12, cam=spec, radius=1.0, seed=0)
    cam = PinholeCamera.create(80.0, 80.0, 79.5, 59.5, 160, 120)
    maps = {dev: vm.create_map(cfg, dev) for dev in ("cpu", cuda)}
    n0 = tsdf_fuse.LAUNCHES
    for i in range(12):
        f = ds.frame(i)
        stats = {}
        for dev, m in maps.items():
            tt = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
            pose = SE3.from_matrix(tt(f.cam_T_world))
            _, st = vm.integrate_frame(m, tt(f.rgb), tt(f.depth), tt(f.ht), tt(f.lt),
                                       cam, pose, cfg, alloc_stride=2)
            stats[str(dev)] = {k: int(v) for k, v in st.items()}
        assert stats["cpu"] == stats[str(cuda)], (i, stats)
    assert tsdf_fuse.LAUNCHES == n0 + 12
    c, g = voxel_map_to_numpy(maps["cpu"]), voxel_map_to_numpy(maps[cuda])
    for name in ("block_key", "block_slot", "active", "free_top", "alloc_failures"):
        np.testing.assert_array_equal(getattr(c, name), getattr(g, name), err_msg=name)
    np.testing.assert_array_equal(c.table.key, g.table.key)
    np.testing.assert_array_equal(c.table.value, g.table.value)
    for name, bound in {**TOL, "prob": 1e-4}.items():
        err = np.abs(getattr(c, name) - getattr(g, name)).max()
        assert err <= bound, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb", [
    (1000, 20000), (130, 300), (1, 1), (64, 128), (0, 17), (5, 0),
    (600, 20000),  # the tracking shape
    (17, 20001), (130, 301),  # kb % 4 != 0: rows not 16-byte aligned, 4-byte stores
    (1001, 129),  # ka not a multiple of 16, over more than one 128-row tile
    (128, 128),  # one exact 128 x 128 tile
])
def test_hamming_kernel_matches_plain(cuda, ka, kb):
    """Exact: both count bits, so every distance must agree. The edge
    cases follow csrc/hamming.cu's 128 x 128 tiles."""
    rng = np.random.default_rng(ka * 7 + kb)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (ka, 8), dtype=np.int64).astype(np.int32), device=cuda)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (kb, 8), dtype=np.int64).astype(np.int32), device=cuda)
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
    if ka and kb:
        assert k[0, 0] == 0
    if ka and kb > 1:
        assert k[-1, -1] == 256


@pytest.mark.cuda
def test_extract_mesh_cuda_matches_cpu(cuda):
    """The analytic room built and meshed on each device: counts and
    indices exactly equal (the merge and first-use numbering do not
    depend on the device's sort or scatter order), vertices and
    probabilities within one u16 step."""
    cfg = TsdfConfig(voxel_size=0.04, truncation=0.12, log2_num_blocks=14, log2_hash_size=16)
    out = {}
    for dev in ("cpu", cuda):
        m = analytic_box_map(cfg, dev, half_extents=(2.0, 1.5, 2.0))
        # a probability field that varies, the same on both devices
        x = (torch.arange(512, device=m.device) % 97).to(torch.float32) / 96.0
        m.prob.copy_(torch.where(m.active[:, None], x, m.prob))
        out[str(dev)] = extract_mesh(m, cfg, chunk=1000)
    (cv, ci, cp), (gv, gi, gp) = out["cpu"], out[str(cuda)]
    assert len(ci) > 10000
    assert ci.shape == gi.shape and cv.shape == gv.shape
    np.testing.assert_array_equal(ci, gi)
    step = (cv.max(0) - cv.min(0)) / 65535.0
    assert (np.abs(cv - gv) / step).max() <= 1.001
    assert np.abs(cp - gp).max() * 65535.0 <= 1.001


@pytest.mark.cuda
def test_raycast_cuda_matches_cpu(cuda):
    """12 frames of the small orbit fused on the CPU, the same map
    carried to the card, rendered at three poses on both: hit mask and
    dropped count equal; depth within 1e-5 but where two splats within
    one 13-bit step swap (<= 0.1% of hits, within one step); normal 1e-5
    and rgba 1e-3 away from those pixels."""
    cfg = TsdfConfig(voxel_size=0.04, truncation=0.16, max_depth=6.0, raycast_min_weight=2.0,
                     log2_num_blocks=12, log2_hash_size=14, max_visible_blocks=2048,
                     max_new_blocks=4096, width=160, height=120)
    spec = SyntheticCameraSpec(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    ds = SyntheticBoxDataset(num_frames=12, cam=spec, radius=1.0, seed=0)
    cam = PinholeCamera.create(80.0, 80.0, 79.5, 59.5, 160, 120)
    m = vm.create_map(cfg, "cpu")
    for i in range(12):
        f = ds.frame(i)
        tt = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        vm.integrate_frame(m, tt(f.rgb), tt(f.depth), tt(f.ht), tt(f.lt), cam,
                           SE3.from_matrix(tt(f.cam_T_world)), cfg, alloc_stride=2)
    maps = {"cpu": m, str(cuda): voxel_map_from_numpy(voxel_map_to_numpy(m), cuda)}
    zstep = (cfg.max_depth - cfg.min_depth) / 8191
    for i in (0, 4, 9):
        outs = {}
        for dev, mm in maps.items():
            pose = SE3.from_matrix(torch.as_tensor(ds.frame(i).cam_T_world, device=mm.device))
            outs[dev] = {k: v.cpu().numpy() for k, v in raycast(mm, cam, pose, cfg).items()}
        c, g = outs["cpu"], outs[str(cuda)]
        np.testing.assert_array_equal(c["hit"], g["hit"])
        assert int(c["dropped_splats"]) == int(g["dropped_splats"]) and c["hit"].sum() > 1000
        dz = np.abs(c["depth"] - g["depth"])
        flipped = dz > 1e-5
        assert flipped.sum() <= 1e-3 * c["hit"].sum() and dz.max() <= zstep + 1e-5
        near = flipped.copy()
        for ax in (0, 1):
            for sh in (-1, 1):
                near |= np.roll(flipped, sh, axis=ax)
        assert np.abs(c["normal"] - g["normal"])[~near].max() <= 1e-5
        assert np.abs(c["rgba"] - g["rgba"])[~near].max() <= 1e-3


def test_hamming_rejects_bad_inputs():
    a = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        hamming.hamming_matrix(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a[:, :7], a)


@pytest.mark.cuda
def test_resize_cuda_matches_cpu(cuda):
    """ops/resize.py on the card against the CPU, exactly: integer sums
    (uint8) and separate float32 operations, indices from the host."""
    from ra_slam_tpu_torch.ops.resize import resize

    rng = np.random.default_rng(0)
    for img, w, h in [(rng.integers(0, 256, (968, 1296, 3), dtype=np.uint8), 640, 480),
                      (rng.integers(0, 256, (120, 160, 3), dtype=np.uint8), 333, 250),
                      (rng.random((35, 50)).astype(np.float32), 64, 48)]:
        for how in ("linear", "nearest"):
            a = resize(torch.as_tensor(img), w, h, how)
            b = resize(torch.as_tensor(img, device=cuda), w, h, how)
            assert b.device.type == "cuda" and torch.equal(a, b.cpu()), (img.shape, how)


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
    pixels (chip_smoke.py's bounds: another IDCT and chroma upsampling)."""
    import os

    from ra_slam_tpu_torch.io.sens import SensReader

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    reader = SensReader(os.path.join(data, "jpeg_64x48.sens"))
    got = np.stack([reader.frame(i).rgb for i in range(len(reader))]).astype(np.int32)
    reader.close()
    d = np.abs(got - np.load(os.path.join(data, "jpeg_64x48_rgb.npy")).astype(np.int32))
    assert got.shape == (2, 48, 64, 3) and d.max() <= 96 and d.mean() <= 4.0


@pytest.mark.cuda
def test_nvjpeg_encoder_round_trip(cuda, tmp_path):
    """A smooth 64x48 image through nvjpeg's encoder (quality 95, 4:2:0)
    and decoder: a baseline JFIF stream, PSNR above 35 dB; and a JPEG
    `.sens` written on the card reads back with the depth exact and the
    colour within the same bound."""
    from ra_slam_tpu_torch.io import sens
    from ra_slam_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg

    vs, us = np.mgrid[0:48, 0:64]
    rgb = np.stack([us * 4, vs * 5, (us + vs) * 2], -1).astype(np.uint8)
    data = encode_jpeg(rgb, 95, cuda)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    back = decode_jpeg(data, cuda).cpu().numpy()

    def psnr(a):
        mse = np.mean((a.astype(np.float64) - rgb) ** 2)
        return 10 * np.log10(255.0**2 / max(mse, 1e-12))

    assert back.shape == rgb.shape and psnr(back) > 35.0
    depth = (1000 + us * 7 + vs).astype(np.uint16)
    path = str(tmp_path / "j.sens")
    k = np.array([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]], np.float32)
    sens.write_sens(path, [rgb], [depth], [np.eye(4, dtype=np.float32)], k,
                    color_compression=sens.COLOR_JPEG, device=cuda)
    r = sens.SensReader(path)
    fr = r.frame(0)
    assert r.color_compression == sens.COLOR_JPEG
    np.testing.assert_array_equal(r._raw_depth(0), depth)
    assert psnr(fr.rgb) > 35.0
    r.close()


@pytest.mark.cuda
def test_sharded_fusion_cuda_matches_cpu(cuda):
    """LocalMesh(2) sharded fusion on the card (the fuse kernel once per
    shard per frame, the shards' threads on one stream) against the same
    on the CPU, 6 frames of the small orbit: every shard's keys, table,
    free stack and counters exactly, the payload within the single-map
    test's bounds."""
    from ra_slam_tpu_torch.parallel import LocalMesh, create_sharded_map, make_sharded_integrate_step

    cfg = TsdfConfig(voxel_size=0.04, truncation=0.16, max_depth=6.0,
                     log2_num_blocks=12, log2_hash_size=14, max_visible_blocks=2048,
                     max_new_blocks=4096, width=160, height=120)
    spec = SyntheticCameraSpec(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    ds = SyntheticBoxDataset(num_frames=12, cam=spec, radius=1.0, seed=0)
    cam = PinholeCamera.create(80.0, 80.0, 79.5, 59.5, 160, 120)
    meshes = {dev: LocalMesh(2, dev) for dev in ("cpu", cuda)}
    shards = {dev: create_sharded_map(cfg, mesh) for dev, mesh in meshes.items()}
    steps = {dev: make_sharded_integrate_step(mesh, cfg, alloc_stride=2) for dev, mesh in meshes.items()}
    n0 = tsdf_fuse.LAUNCHES
    for i in range(0, 12, 2):
        f = ds.frame(i)
        stats = {}
        for dev in meshes:
            tt = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
            shards[dev], st = steps[dev](shards[dev], tt(f.rgb), tt(f.depth), tt(f.ht), tt(f.lt), cam,
                                         SE3.from_matrix(tt(f.cam_T_world)))
            stats[str(dev)] = {k: int(v) for k, v in st.items()}
        assert stats["cpu"] == stats[str(cuda)], (i, stats)
    assert tsdf_fuse.LAUNCHES == n0 + 2 * 6
    for c_shard, g_shard in zip(shards["cpu"], shards[cuda]):
        c, g = voxel_map_to_numpy(c_shard), voxel_map_to_numpy(g_shard)
        for name in ("block_key", "block_slot", "active", "free_top", "alloc_failures"):
            np.testing.assert_array_equal(getattr(c, name), getattr(g, name), err_msg=name)
        np.testing.assert_array_equal(c.table.key, g.table.key)
        np.testing.assert_array_equal(c.free_stack[:int(c.free_top)], g.free_stack[:int(g.free_top)])
        for name, bound in {**TOL, "prob": 1e-4}.items():
            err = np.abs(getattr(c, name) - getattr(g, name)).max()
            assert err <= bound, (name, err)


@pytest.mark.cuda
def test_unet_cuda_matches_cpu(cuda):
    """The committed (16, 32, 64) weights on a held-out 320x240 frame on
    the card and on the CPU (bf16, TF32 off): prob within 0.06, at most
    1e-3 of the decisions flipped (tests/test_torch_segmentation.py's
    CPU-vs-JAX bounds)."""
    import os

    from ra_slam_tpu_torch.models.segmentation import InferenceEngine

    weights = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ra_slam_tpu", "models", "demo_seg.msgpack")
    ds = SyntheticBoxDataset(num_frames=16, cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                                                                     width=320, height=240),
                             radius=1.0, seed=3, clutter=4)
    rgb = torch.as_tensor(ds.frame(0).rgb)
    c, g = (InferenceEngine(weights, 320, 240, widths=(16, 32, 64), device=d).segment(rgb)[0].cpu().numpy()
            for d in ("cpu", cuda))
    assert np.abs(c - g).max() <= 0.06 and ((c > 0.5) != (g > 0.5)).mean() <= 1e-3
    assert torch.backends.cudnn.allow_tf32  # the engine restores the flag it clears for its call


@pytest.mark.cuda
def test_dense_stereo_cuda_matches_cpu(cuda):
    """`dense_stereo_depth` of one synthetic pair at 240x180, D = 32:
    `valid` equal where no sentinel cost reaches the decision (columns >=
    2 D + 8), at most 2% of the pixels left of them differing, depth the
    same float32 division where both are valid."""
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.features.stereo import dense_stereo_depth
    from ra_slam_tpu_torch.io.synthetic import look_at, render_box_room

    spec = SyntheticCameraSpec(fx=120.0, fy=120.0, cx=119.5, cy=89.5, width=240, height=180)
    w_T_l = look_at(np.array([0.3, 0.0, 0.0]), np.array([0.0, 0.0, 1.5]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * 0.12
    he = np.array([2.0, 1.5, 2.0])
    pair = [render_box_room(spec, m, he, checker=0.125)[0] for m in (w_T_l, w_T_r)]
    out = {}
    for dev in ("cpu", cuda):
        gl, gr = (rgb_to_gray(torch.as_tensor(a, device=dev)) for a in pair)
        out[str(dev)] = [t.cpu().numpy() for t in dense_stereo_depth(gl, gr, 120.0 * 0.12, max_disparity=32)]
    (cd, cv), (gd, gv) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(cv[:, 72:], gv[:, 72:])
    assert (cv != gv)[:, :72].mean() <= 0.02
    both = cv & gv
    assert both.mean() > 0.3 and (np.abs(cd[both] - gd[both]) / cd[both]).max() <= 1e-6


@pytest.mark.cuda
def test_remap_cuda_matches_cpu(cuda):
    """`remap_linear` on the card equals the CPU exactly (float64 steps,
    each rounded to float32 as on the CPU), and a ZED-like rectifier's
    pair too."""
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
    mono = rectify.CalibMono(367.6, 367.7, 336.2, 188.2, [-0.17, 0.026, 0.0001, -0.0002, 0.0])
    rect = rectify.StereoRectifier((w, h), rectify.CalibStereo(mono, mono, [0.0021, 0.0058, -0.0009],
                                                               [-0.12, 0.0, 0.0]), device=cuda)
    a = rect.rectify(torch.as_tensor(img), torch.as_tensor(img))
    b = rect.rectify(torch.as_tensor(img, device=cuda), torch.as_tensor(img, device=cuda))
    assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))


@pytest.mark.cuda
def test_train_step_cuda_matches_cpu(cuda):
    """One float32 training step (TF32 off) of a (16, 32) net on the card
    and on the CPU from the same parameters and batch: the loss within
    1e-5 and each gradient within 1e-4 of its tensor's largest |g|, while
    the same gradients with cuDNN's TF32 on (the control) land above
    that bound somewhere. Measured on the H100: 8.2e-6 with TF32 off,
    8.2e-4 for the control (at this size the sums are shorter than in
    chip_smoke.py phase 11, whose bound is 1e-3)."""
    from ra_slam_tpu_torch.models.segmentation import (SegmentationNet, init_params_, make_train_step,
                                                       masked_cross_entropy)

    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 64, 96), dtype=np.float32)
    y = rng.integers(-1, 2, (2, 64, 96))
    ref = SegmentationNet((16, 32), dtype=torch.float32)
    init_params_(ref, torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda, "tf32"):
        net = SegmentationNet((16, 32), dtype=torch.float32)
        net.load_state_dict(ref.state_dict())
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
            step = make_train_step(net, torch.optim.Adam(net.parameters(), lr=3e-4))
            loss = float(step(xd, yd))
        out[str(dev)] = loss, {n: p.grad.cpu() for n, p in net.named_parameters()}
    (lc, gc), (lg, gg), (_, gt) = out["cpu"], out[str(cuda)], out["tf32"]
    rel = {k: {n: float((gk[n] - g).abs().max() / g.abs().max()) for n, g in gc.items()}
           for k, gk in (("card", gg), ("tf32", gt))}
    print(f"card vs CPU worst {max(rel['card'].values()):.3g}, TF32 control worst {max(rel['tf32'].values()):.3g}")
    assert abs(lc - lg) <= 1e-5
    for n, err in rel["card"].items():
        assert err <= 1e-4, (n, err)
    assert max(rel["tf32"].values()) > 1e-4, rel["tf32"]
