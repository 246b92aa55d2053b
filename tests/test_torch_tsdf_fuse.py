"""The fuse of the PyTorch port (ra_slam_tpu_torch/ops/tsdf_fuse.py)
against the JAX package's, on the CPU.

Random tiles, pixel choices and pool state, as the TPU kernel sees them,
go through (1) the Pallas kernel itself, `tsdf_fuse_pallas`, in
interpret mode, and (2) the JAX package's f32 einsum branch of
`integrate`. The port reads the same samples from a "virtual image": the
tiles laid end to end as `img6 [6, V*256]`, voxel (b, i) at pixel
`b*256 + idx[b, i]`. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.core.config import TsdfConfig as JaxTsdfConfig
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.map import voxel_map as jvm
from ra_slam_tpu.ops.tsdf_pallas import tsdf_fuse_pallas
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.map.voxel_map import create_map
from ra_slam_tpu_torch.ops import tsdf_fuse

V, N = 32, 64  # visible slots (a multiple of the kernel's 16), pool rows
TRUNC, MAX_D, MAX_W = 0.16, 6.0, 40.0


def _inputs(seed=0):
    """Tiles [V,6,256], pixel choices [V,512] and old state, with the
    cases the update gate separates: inside and beyond the truncation
    band, invalid depth (0), depth beyond max_depth, gate 0, probability
    maps at 0 and 1."""
    rng = np.random.default_rng(seed)
    patch = np.empty((V, 6, 256), np.float32)
    patch[:, 0] = rng.uniform(0.3, 5.5, (V, 256))
    patch[:, 0][rng.random((V, 256)) < 0.05] = 0.0
    patch[:, 0][rng.random((V, 256)) < 0.05] = 6.5
    patch[:, 1:4] = rng.uniform(0, 255, (V, 3, 256))
    patch[:, 4:6] = rng.uniform(0, 1, (V, 2, 256))
    patch[:, 4][rng.random((V, 256)) < 0.05] = 0.0
    patch[:, 5][rng.random((V, 256)) < 0.05] = 1.0
    idx = rng.integers(0, 256, (V, 512)).astype(np.int32)
    d_sel = np.take_along_axis(patch[:, 0], idx, axis=1)
    z = (d_sel + rng.uniform(-2.5, 2.5, (V, 512)) * TRUNC).astype(np.float32)
    d2r = rng.uniform(1.0, 1.5, (V, 512)).astype(np.float32)
    gate = (rng.random((V, 512)) < 0.9).astype(np.float32)
    t_old = rng.uniform(-1, 1, (V, 512)).astype(np.float32)
    w_old = rng.uniform(1, MAX_W, (V, 512)).astype(np.float32)
    p_old = rng.uniform(0, 1, (V, 512)).astype(np.float32)
    c_old = rng.uniform(0, 255, (V, 3, 512)).astype(np.float32)
    return patch, idx, z, d2r, gate, t_old, w_old, p_old, c_old


def _virtual_image(patch, idx):
    img6 = np.ascontiguousarray(patch.transpose(1, 0, 2)).reshape(6, V * 256)
    pix = (np.arange(V, dtype=np.int32)[:, None] * 256 + idx).astype(np.int32)
    return torch.from_numpy(img6), torch.from_numpy(pix)


def test_fuse_reference_matches_pallas_interpret():
    patch, idx, z, d2r, gate, t_old, w_old, p_old, c_old = _inputs()
    out_j = tsdf_fuse_pallas(
        *map(jnp.asarray, (patch, idx, z, d2r, gate, t_old, w_old, p_old, c_old)),
        truncation=TRUNC, max_depth=MAX_D, max_weight=MAX_W, interpret=True,
    )
    img6, pix = _virtual_image(patch, idx)
    out_t = tsdf_fuse.tsdf_fuse_reference(
        img6, pix, *map(torch.from_numpy, (z, d2r, gate, t_old, w_old, p_old, c_old)),
        TRUNC, MAX_D, MAX_W,
    )
    # the Pallas kernel resolves appearance in one bf16 pass: the bounds
    # of tests/test_tpu_kernels.py
    tol = {"tsdf": 2e-5, "weight": 2e-5, "prob": 5e-3, "rgb": 1.5, "minabs": 2e-5}
    for name, a, b in zip(("tsdf", "weight", "prob", "rgb", "minabs"), out_j, out_t):
        err = np.abs(np.asarray(a) - b.numpy()).max()
        assert err <= tol[name], (name, err)
    upd = np.asarray(out_j[1]) != w_old  # the update gate opened...
    assert 0.2 < upd.mean() < 0.9  # ...for some voxels and not for others


def test_fuse_wrapper_matches_einsum_integrate(monkeypatch):
    """The CPU path of the wrapper `tsdf_fuse_` (gather, fuse, masked
    scatter into the pool) against `integrate`'s einsum branch on the
    same pool, with padded slots that point at live row 0."""
    patch, idx, z, d2r, gate, t_old, w_old, p_old, c_old = _inputs(1)
    rng = np.random.default_rng(2)
    vis_idx = rng.choice(np.arange(1, N), V, replace=False).astype(np.int32)
    vis_idx[3] = 0  # row 0 is visible ...
    vis_idx[-4:] = 0  # ... and is also what padded slots point at
    vis_mask = np.ones(V, bool)
    vis_mask[-4:] = False
    gate[-4:] = 0.0  # prep gates masked slots

    pool = {
        "tsdf": rng.uniform(-1, 1, (N, 512)).astype(np.float32),
        "weight": rng.uniform(1, MAX_W, (N, 512)).astype(np.float32),
        "prob": rng.uniform(0, 1, (N, 512)).astype(np.float32),
        "rgb": rng.uniform(0, 255, (N, 3, 512)).astype(np.float32),
    }
    rows = vis_idx.astype(np.int64)
    t_old, w_old, p_old = pool["tsdf"][rows], pool["weight"][rows], pool["prob"][rows]
    c_old = pool["rgb"][rows]

    kw = dict(truncation=TRUNC, max_depth=MAX_D, max_weight=MAX_W, log2_num_blocks=6,
              log2_hash_size=8, max_visible_blocks=V, width=16, height=16)
    jm = jvm.create_map(JaxTsdfConfig(**kw))._replace(**{k: jnp.asarray(v) for k, v in pool.items()})
    prep = tuple(map(jnp.asarray, (patch, idx, z, d2r, gate)))
    monkeypatch.setattr(jvm, "_integrate_prep", lambda *a, **k: prep)
    zero = jnp.zeros((16, 16), jnp.float32)
    cam = JaxCamera.create(10.0, 10.0, 8.0, 8.0, 16, 16)
    jm = jvm.integrate(
        jm, jnp.asarray(vis_idx), jnp.asarray(vis_mask),
        jnp.zeros((16, 16, 3), jnp.float32), zero, zero, zero,
        cam, JaxSE3.identity(), JaxTsdfConfig(**kw), carve=False,
    )

    tm = create_map(TsdfConfig(**kw), "cpu")
    for k, v in pool.items():
        getattr(tm, k).copy_(torch.from_numpy(v))
    img6, pix = _virtual_image(patch, idx)
    minabs = tsdf_fuse.tsdf_fuse_(
        tm, torch.from_numpy(vis_idx), torch.from_numpy(vis_mask), img6, pix,
        *map(torch.from_numpy, (z, d2r, gate)), TsdfConfig(**kw),
    )
    tol = {"tsdf": 2e-5, "weight": 2e-5, "prob": 2e-5, "rgb": 1e-3}
    for name, bound in tol.items():
        err = np.abs(np.asarray(getattr(jm, name)) - getattr(tm, name).numpy()).max()
        assert err <= bound, (name, err)
    # minabs: min |tsdf| of each fused block, 0 on masked slots
    want = np.abs(np.asarray(jm.tsdf)[rows]).min(axis=1)
    np.testing.assert_allclose(minabs.numpy()[vis_mask], want[vis_mask], atol=2e-5, rtol=0)
    assert (minabs.numpy()[~vis_mask] == 0).all()
    assert tsdf_fuse.LAUNCHES == 0  # the CPU path launches no kernel


def test_fuse_wrapper_rejects_bad_inputs():
    kw = dict(log2_num_blocks=4, log2_hash_size=8, max_visible_blocks=2)
    m = create_map(TsdfConfig(**kw), "cpu")
    vis_idx = torch.tensor([0, 1], dtype=torch.int32)
    vis_mask = torch.ones(2, dtype=torch.bool)
    img6 = torch.zeros(6, 100)
    pix = torch.zeros(2, 512, dtype=torch.int32)
    f = torch.zeros(2, 512)
    cfg = TsdfConfig(**kw)
    tsdf_fuse.tsdf_fuse_(m, vis_idx, vis_mask, img6, pix, f, f, f, cfg)  # well formed
    with pytest.raises(TypeError):
        tsdf_fuse.tsdf_fuse_(m, vis_idx.long(), vis_mask, img6, pix, f, f, f, cfg)
    with pytest.raises(ValueError):
        tsdf_fuse.tsdf_fuse_(m, vis_idx, vis_mask, img6, pix, f.t().contiguous().t(), f, f, cfg)
    with pytest.raises(IndexError):
        tsdf_fuse.tsdf_fuse_(m, vis_idx, vis_mask, img6, pix + 100, f, f, f, cfg)
    with pytest.raises(IndexError):
        tsdf_fuse.tsdf_fuse_(m, vis_idx + 15, vis_mask, img6, pix, f, f, f, cfg)
