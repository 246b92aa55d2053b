"""Tests of the PyTorch port that need the GPU: the CUDA fuse kernel
against its plain PyTorch version, and the fusion path on the card
against the same path on the CPU. They skip where torch sees no CUDA
device. This file imports no JAX, so that it runs on a machine without
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
from ra_slam_tpu_torch.ops import tsdf_fuse
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

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
