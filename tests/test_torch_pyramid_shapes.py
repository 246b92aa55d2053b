"""The port's ORB pyramid against the JAX package's at every input shape
the port runs: 640x480 at 8 levels (the facade's default `FeatureConfig`,
so `offline_eval --use-slam`) here; 672x376 at 8 (the ZED's VGA mode of
`live.run`) in tests/test_torch_pyramid_zed.py, the live cell's ORB in
tests/test_torch_orb_live.py, and 320x240 at 4 (the parity tests' images)
in tests/test_torch_features.py. The JAX side runs op by op (see
tests/torch_parity.py); each shape compiles its own ops, about 30 s.

XLA's CPU dot sums each resampling product in its own order (lanes and
splits of the contracted axis, `ra_slam_tpu_torch/features/pyramid.py:
_XLA_SUMS`, revealed by `scripts/probe_xla_sums.py`); summed in one
chain, 20% of the 672x376 noise image's level 1 was off, one pixel by
6.1e-5 (4 ulps), above LEVEL_TOL.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ra_slam_tpu.features import pyramid as jpyr
from ra_slam_tpu_torch.features import pyramid as tpyr
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

from test_torch_features import LEVEL_TOL


@functools.lru_cache()
def frame_gray(width: int, height: int, index: int) -> np.ndarray:
    """A frame of the EVAL scene at this size (fx = width / 2, as the
    ZED's 350 px at 672), grey through the JAX package."""
    f = width / 2.0
    spec = SyntheticCameraSpec(fx=f, fy=f, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0, width=width, height=height)
    rgb = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, clutter=6).frame(index).rgb
    with jax.disable_jit():
        return np.array(jpyr.rgb_to_gray(jnp.asarray(rgb, jnp.float32)))


def _noise(width: int, height: int) -> np.ndarray:
    return (np.random.default_rng(0).random((height, width)) * 255).astype(np.float32)


def check_pyramid(width: int, height: int, levels: int) -> None:
    """Uniform noise (numpy seed 0) and a frame of the EVAL scene: every
    level within LEVEL_TOL of the JAX package's, then bit-equal, and so
    is every level's blur."""
    for gray in (_noise(width, height), frame_gray(width, height, 1)):
        with jax.disable_jit():
            jl = [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(gray), levels, 1.2)]
            jb = [np.asarray(jpyr.gaussian_blur(x)) for x in jl]
        tl = [x.numpy() for x in tpyr.build_pyramid(torch.from_numpy(gray), levels, 1.2)]
        assert [x.shape for x in tl] == [x.shape for x in jl]
        for lvl, (a, b) in enumerate(zip(tl[1:], jl[1:]), 1):
            assert np.abs(a - b).max() <= LEVEL_TOL, (lvl, np.abs(a - b).max())
            np.testing.assert_array_equal(a, b, err_msg=f"level {lvl}")
        for lvl, (a, b) in enumerate(zip(tl, jb)):
            np.testing.assert_array_equal(tpyr.gaussian_blur(torch.from_numpy(a)).numpy(), b, err_msg=f"blur {lvl}")


def test_vga_pyramid_at_8_levels_equals_jax():
    check_pyramid(640, 480, 8)
