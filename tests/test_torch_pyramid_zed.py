"""The 672x376 pyramid of the ZED's VGA mode (`live.run`) at 8 levels
against the JAX package's op by op (tests/test_torch_pyramid_shapes.py).
Summed in one chain, 20% of the noise image's level 1 was off, one pixel
by 6.1e-5 (4 ulps), above LEVEL_TOL."""

from test_torch_pyramid_shapes import check_pyramid


def test_zed_pyramid_at_8_levels_equals_jax():
    check_pyramid(672, 376, 8)
