"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

The small fusion configuration of tests/test_tpu_kernels.py (160x120
images, 4 cm voxels, 2^12 blocks, 2^14 hash slots, 2048 visible and 4096
new blocks per frame) and its synthetic orbit, built in both packages
from the same numbers. Data crosses between the packages as numpy.

The JAX side runs op by op (`jax.disable_jit()`): under `jit`, XLA's CPU
backend contracts `a*b + c` into fused multiply-adds, which rounds the
projection differently from the JAX source's own operations (about 40%
of the voxels' pixel coordinates differ in the last bit, a few of them
enough to pick another pixel). The port rounds every operation as the
source writes it, so it is held to the op-by-op results exactly.
"""

import numpy as np
import torch

from ra_slam_tpu.core.config import TsdfConfig as JaxTsdfConfig
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3

import jax.numpy as jnp

CFG_KW = dict(
    voxel_size=0.04, truncation=0.16, max_depth=6.0,
    log2_num_blocks=12, log2_hash_size=14,
    max_visible_blocks=2048, max_new_blocks=4096, width=160, height=120,
)
CAM_KW = dict(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
N_FRAMES = 12

# bounds of the fused payload against the JAX package's f32 path: the
# same operations in the same order, so only a few ulps
TOL = {"tsdf": 2e-5, "weight": 2e-5, "prob": 1e-4, "rgb": 1e-3}
EXACT = ("block_key", "block_slot", "active", "free_top", "alloc_failures")


def jax_cfg() -> JaxTsdfConfig:
    return JaxTsdfConfig(**CFG_KW)


def torch_cfg() -> TsdfConfig:
    return TsdfConfig(**CFG_KW)


def torch_cam() -> PinholeCamera:
    c = CAM_KW
    return PinholeCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"])


def jax_frame(f):
    """(rgb, depth, ht, lt, pose) of a Frame as JAX arrays."""
    return (
        jnp.asarray(f.rgb, jnp.float32), jnp.asarray(f.depth),
        jnp.asarray(f.ht), jnp.asarray(f.lt),
        JaxSE3.from_matrix(jnp.asarray(f.cam_T_world)),
    )


def torch_frame(f, device="cpu"):
    """(rgb, depth, ht, lt, pose) of a Frame as torch tensors."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (
        t(f.rgb), t(f.depth), t(f.ht), t(f.lt),
        SE3.from_matrix(t(f.cam_T_world)),
    )


def assert_maps_match(jax_np, port_np, tol=TOL):
    """JAX map state (numpy leaves) vs the port's (`voxel_map_to_numpy`):
    metadata, hash table and live free stack exactly, payload within
    `tol` on all rows."""
    for name in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(jax_np, name)), getattr(port_np, name), err_msg=name
        )
    np.testing.assert_array_equal(np.asarray(jax_np.table.key), port_np.table.key)
    np.testing.assert_array_equal(np.asarray(jax_np.table.value), port_np.table.value)
    top = int(jax_np.free_top)
    np.testing.assert_array_equal(
        np.asarray(jax_np.free_stack)[:top], port_np.free_stack[:top]
    )
    for name, bound in tol.items():
        err = np.abs(np.asarray(getattr(jax_np, name)) - getattr(port_np, name)).max()
        assert err <= bound, (name, err, bound)
