"""Raycast rendering of the PyTorch port (ra_slam_tpu_torch/map/raycast.py)
against the JAX package's, on the CPU. Both read the same map: fused by
JAX over the small orbit of tests/torch_parity.py and carried into the
port with `voxel_map_from_numpy`. The JAX side runs op by op."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.map import raycast as jrc
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.io.synthetic import look_at
from ra_slam_tpu_torch.map import raycast as trc
from ra_slam_tpu_torch.map.synthetic_map import analytic_box_map
from ra_slam_tpu_torch.map.voxel_map import create_map
from ra_slam_tpu_torch.utils.convert import voxel_map_from_numpy

# 6 fused frames give weights of ~2-15: render from weight 2, as
# tests/test_raycast_meshing.py does
RENDER = dict(raycast_min_weight=2.0)
# one 13-bit depth step over [min_depth, max_depth] = [0.1, 6] m
ZSTEP = (6.0 - 0.1) / 8191
# bounds against JAX op by op, beside the largest difference measured
# over the three poses: depth 0 (bound 1e-5), normal 1.8e-7 (1e-5),
# rgba 2.3e-5 (1e-3), pixels whose winner flipped 0 (<= 0.1% of hits)
TOL = {"depth": 1e-5, "normal": 1e-5, "rgba": 1e-3}
MAX_FLIPPED = 1e-3


@pytest.fixture(scope="module")
def carried():
    jcfg = dataclasses.replace(tp.jax_cfg(), **RENDER)
    jn, ds = tp.jax_fused_map(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, jn), voxel_map_from_numpy(jn, "cpu"), ds


def _grow(mask: np.ndarray) -> np.ndarray:
    """mask dilated by one pixel (with wrap-around, as the normals)."""
    out = mask.copy()
    for ax in (0, 1):
        for s in (-1, 1):
            out |= np.roll(mask, s, axis=ax)
    return out


@pytest.mark.parametrize("frame,max_shell_blocks", [(0, None), (3, None), (7, None), (7, 64)])
def test_raycast_matches_jax(carried, frame, max_shell_blocks):
    """Hit mask and dropped count exact; depth, normal and rgba within
    TOL. A pixel whose winner differs (two splats within one 13-bit
    step, which float rounding may order either way) is counted, must
    stay within one step, and is left out of the normal/rgba check with
    its neighbours. `max_shell_blocks=64` drops shell blocks."""
    jcfg, jm, tm, ds = carried
    tcfg = dataclasses.replace(tp.torch_cfg(), **RENDER)
    pose = ds.frame(frame).cam_T_world
    with jax.disable_jit():
        jo = jrc.raycast(jm, ds.camera, JaxSE3.from_matrix(jnp.asarray(pose)), jcfg,
                         max_shell_blocks=max_shell_blocks)
    jo = {k: np.asarray(v) for k, v in jo.items()}
    to = {k: v.numpy() for k, v in trc.raycast(
        tm, tp.torch_cam(), SE3.from_matrix(torch.as_tensor(pose)), tcfg,
        max_shell_blocks=max_shell_blocks).items()}

    hit = jo["hit"]
    np.testing.assert_array_equal(to["hit"], hit)
    assert int(to["dropped_splats"]) == int(jo["dropped_splats"])
    assert hit.sum() > 1000 and (int(jo["dropped_splats"]) > 0) == (max_shell_blocks is not None)
    dz = np.abs(to["depth"] - jo["depth"])
    flipped = dz > TOL["depth"]
    assert flipped.sum() <= MAX_FLIPPED * hit.sum(), flipped.sum()
    assert dz.max() <= ZSTEP + TOL["depth"]
    keep = ~_grow(flipped)
    for name in ("normal", "rgba"):
        err = np.abs(to[name] - jo[name])[keep].max()
        assert err <= TOL[name], (name, err)


def test_raycast_empty_map():
    cfg = tp.torch_cfg()
    out = trc.raycast(create_map(cfg, "cpu"), tp.torch_cam(), SE3.identity("cpu"), cfg)
    assert not out["hit"].any() and (out["depth"] == 0).all() and (out["rgba"] == 0).all()
    assert int(out["dropped_splats"]) == 0


def _reference_zbuffer(pix, z, n_pix):
    """The JAX package's z-buffer in numpy: a stable sort of (pixel << 13
    | quantized depth), the first splat of each pixel wins."""
    zq = np.clip((z - np.float32(0.1)) * np.float32(8191) / np.float32(5.9), 0, 8191)
    zq = np.where(np.isfinite(z), zq, 8191).astype(np.int64)
    order = np.argsort((pix.astype(np.int64) << 13) | zq, kind="stable")
    ps = pix[order]
    first = np.concatenate([[True], ps[1:] != ps[:-1]]) & (ps < n_pix)
    depth = np.zeros(n_pix, np.float32)
    depth[ps[first]] = z[order][first]
    return depth, zq


def test_raycast_sensor_beyond_19_bits():
    """1024 x 576 = 589,824 pixels > 2^19, where the JAX package's uint32
    (pixel << 13 | depth) key overflows (it asserts): the int64 key
    renders, and every pixel takes the splat the stable-sort rule picks,
    ties included."""
    cfg = TsdfConfig(voxel_size=0.03, truncation=0.09, log2_num_blocks=14, log2_hash_size=16,
                     max_visible_blocks=8192, width=1024, height=576, raycast_min_weight=2.0)
    m = analytic_box_map(cfg, "cpu", half_extents=(2.0, 1.5, 2.0))
    cam = PinholeCamera.create(200.0, 200.0, 511.5, 287.5, 1024, 576)
    assert cam.width * cam.height > 1 << 19
    w_T_c = look_at(np.array([0.3, -0.2, -0.5]), np.array([1.5, 0.4, 1.5]))
    pose = SE3.from_matrix(torch.as_tensor(np.linalg.inv(w_T_c.astype(np.float64)).astype(np.float32)))
    out = trc.raycast(m, cam, pose, cfg)
    # one splat per voxel: a 3 cm voxel spans ~2-4 pixels here
    assert int(out["dropped_splats"]) == 0 and out["hit"].float().mean() > 0.1

    pix, z, _, _ = trc._splats(m, cam, pose, cfg, 0.5, 0)
    depth, zq = _reference_zbuffer(pix.numpy(), z.numpy(), cam.width * cam.height)
    np.testing.assert_array_equal(out["depth"].numpy().reshape(-1), depth)
    # the tie rule is exercised: 249 splats share a pixel and a depth
    # step with an earlier one
    pv = pix.numpy()
    live = pv < cam.width * cam.height
    key = pv[live].astype(np.int64) * 8192 + zq[live]
    assert len(key) - len(np.unique(key)) > 100
