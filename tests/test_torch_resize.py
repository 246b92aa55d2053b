"""cv2.resize as torch functions (ra_slam_tpu_torch/ops/resize.py)
against cv2 itself, and the facade's resize branch against the JAX
facade's.

Bounds: INTER_NEAREST exact for every dtype; INTER_LINEAR exact for
uint8 (cv2's fixed point emulated); INTER_LINEAR float32 within 3
float32 ulps of the largest input magnitude (cv2's own float sums are
not reproduced bit for bit; 3 measured at 1296x968 -> 640x480 on values
up to 255, 2 elsewhere). The uint8 tables are cached per sizes and
device and give cv2's bytes from the cache."""

import cv2
import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.core import config as jcfg
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.pipeline.system import RaSlamSystem as JaxSystem
from ra_slam_tpu_torch.core import config as tcfg
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.ops import resize as resize_mod
from ra_slam_tpu_torch.ops.resize import resize
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

FLOAT_ULPS = 3

SHAPES = [
    ((968, 1296), (480, 640)),  # ScanNet colour to its depth size
    ((120, 160), (240, 320)),  # 2x upscale
    ((48, 64), (75, 100)),  # non-integer upscale
    ((240, 320), (120, 160)),  # 2x downscale (the facade test's frames)
    ((75, 100), (29, 37)),  # non-integer downscale
    ((479, 641), (241, 320)),  # odd sizes both ways
    ((376, 672), (188, 336)),  # the ZED's frames halved
]
# uint8 only: float32 INTER_LINEAR from one column parts from cv2's by 19
# ulps, a shape no caller resizes in float32
U8_SHAPES = SHAPES + [((37, 1), (18, 5))]  # a 1-pixel-wide source


def _images(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx * 7 + yy * 3) % 256, (xx * yy) % 256, rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
    return {
        "uint8 RGB": rgb,
        "uint8 grey": rgb[..., 2].copy(),
        "float32": (rng.random((h, w)) * 255).astype(np.float32),
        "float32 RGB": rng.random((h, w, 3)).astype(np.float32),
        "uint16": rng.integers(0, 65536, (h, w)).astype(np.uint16),
    }


@pytest.mark.parametrize("src,dst", SHAPES, ids=[f"{s[1]}x{s[0]}->{d[1]}x{d[0]}" for s, d in SHAPES])
def test_resize_matches_cv2(src, dst):
    (h, w), (H, W) = src, dst
    for name, img in _images(h, w).items():
        t = torch.as_tensor(img.astype(np.int32) if img.dtype == np.uint16 else img)
        near = resize(t, W, H, "nearest").numpy()
        np.testing.assert_array_equal(near, cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST),
                                      err_msg=f"{name} nearest")
        if img.dtype == np.uint16:
            continue  # depth is only ever resized with nearest
        lin, want = resize(t, W, H).numpy(), cv2.resize(img, (W, H))
        assert lin.dtype == want.dtype and lin.shape == want.shape
        if img.dtype == np.uint8:
            np.testing.assert_array_equal(lin, want, err_msg=f"{name} linear")
        else:
            ulps = np.abs(lin - want).max() / np.spacing(np.float32(np.abs(img).max()))
            assert ulps <= FLOAT_ULPS, (name, ulps)


@pytest.mark.parametrize("src,dst", U8_SHAPES, ids=[f"{s[1]}x{s[0]}->{d[1]}x{d[0]}" for s, d in U8_SHAPES])
def test_u8_tables_are_cached(src, dst):
    """The uint8 tables are built once per sizes and device: a second
    resize at the same sizes builds nothing new, and both give cv2's
    bytes (RGB and grey)."""
    (h, w), (H, W) = src, dst
    tabs = resize_mod._u8_tables(h, w, H, W, torch.device("cpu"))
    n = len(resize_mod._TABLES)
    assert [t.shape for t in tabs] == [(W,)] * 4 + [(H,)] * 4 and all(t.dtype == torch.int32 for t in tabs)
    for name in ("uint8 RGB", "uint8 grey"):
        img = _images(h, w)[name]
        for _ in range(2):
            out = resize_mod.resize_linear(torch.as_tensor(img), W, H).numpy()
            np.testing.assert_array_equal(out, cv2.resize(img, (W, H)), err_msg=name)
    assert resize_mod._u8_tables(h, w, H, W, torch.device("cpu")) is tabs and len(resize_mod._TABLES) == n


def test_resize_rejects_bad_input():
    with pytest.raises(TypeError):
        resize(torch.zeros(4, 4, dtype=torch.float64), 2, 2)
    with pytest.raises(ValueError):
        resize(torch.zeros(4), 2, 2)
    with pytest.raises(ValueError):
        resize(torch.zeros(4, 4), 2, 2, "cubic")


def _cfg(mod, tsdf):
    c = tp.CAM_KW
    return mod.SystemConfig(camera=mod.CameraConfig(**c), tsdf=tsdf)


def test_facade_resize_branch_matches_jax():
    """One frame of the orbit rendered at twice the map's size and fed to
    both facades at its pose (fake segmentation): colour resized with
    INTER_LINEAR, depth with INTER_NEAREST, then fused. The same stats,
    keys, table and free stack, the payload within tests/torch_parity.py's
    bounds. The JAX side runs op by op."""
    c = tp.CAM_KW
    big = SyntheticCameraSpec(fx=2 * c["fx"], fy=2 * c["fy"], cx=2 * c["cx"] + 0.5, cy=2 * c["cy"] + 0.5,
                              width=2 * c["width"], height=2 * c["height"])
    fr = SyntheticBoxDataset(num_frames=12, cam=big, radius=1.0, seed=0).frame(3)
    assert fr.rgb.shape == (240, 320, 3) and fr.rgb.dtype == np.uint8
    js = JaxSystem(_cfg(jcfg, tp.jax_cfg()), enable_tracking=False)
    ts = RaSlamSystem(_cfg(tcfg, tp.torch_cfg()), "cpu", enable_tracking=False)
    with jax.disable_jit():
        jst = js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp,
                                 pose=JaxSE3.from_matrix(jax.numpy.asarray(fr.cam_T_world)))
    tst = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, pose=SE3.from_matrix(torch.as_tensor(fr.cam_T_world)))
    assert tst == jst and tst["num_active"] > 0
    tp.assert_maps_match(jax.tree.map(np.asarray, js.map), voxel_map_to_numpy(ts.map))
