"""The live cell's ORB (`live.run` at the ZED's 672x376, 1000 keypoints on
3 levels) against the JAX package's op by op."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.features import orb as jorb
from ra_slam_tpu_torch.core.config import FeatureConfig
from ra_slam_tpu_torch.features import orb as torb

from test_torch_features import ANGLE_TOL
from test_torch_pyramid_shapes import frame_gray


def test_orb_equals_jax_at_the_live_shape():
    """The live cell's ORB (672x376, 1000 keypoints, 3 levels) on two
    frames of the EVAL scene: uv, level, score, descriptors and valid
    bit-equal to the JAX package's, the angle within ANGLE_TOL (its
    centroid sums run in another order)."""
    kw = dict(max_num_keypoints=1000, num_levels=3)
    for index in (1, 7):
        gray = frame_gray(672, 376, index)
        with jax.disable_jit():
            kj = jorb.detect_and_describe(jnp.asarray(gray), JaxFeatureConfig(**kw))
        kt = torb.detect_and_describe(torch.from_numpy(gray), FeatureConfig(**kw))
        for name in ("uv", "level", "score", "valid"):
            np.testing.assert_array_equal(getattr(kt, name).numpy(), np.asarray(getattr(kj, name)), err_msg=name)
        v = np.asarray(kj.valid)
        assert v.sum() >= 100
        np.testing.assert_array_equal(kt.desc.numpy().view(np.uint32)[v], np.asarray(kj.desc)[v])
        assert np.abs(kt.angle.numpy() - np.asarray(kj.angle))[v].max() <= ANGLE_TOL
