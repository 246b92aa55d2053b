"""Dense stereo depth of the PyTorch port (ra_slam_tpu_torch/features/
stereo.py `census_transform`, `dense_stereo_depth`) against the JAX
package's on the CPU, on tests/test_stereo.py's 240x180 pair with the
15 px wall texture, D = 32. The JAX side runs op by op.

Away from the sentinel the costs are integers and every window sum is
exact in float32, so `best_d`, `valid` and depth must equal JAX's
exactly. A window that reaches an out-of-range disparity (cost 1e9) sums
in an order-dependent way: those are the columns u < D + 4 (the window's
half width), where `valid` is False in both packages anyway (u >= D), and
whose costs can still feed a right-view argmin of a column to their
right: the left-right check of columns up to D + 4 + D. The test counts
the pixels that differ there and bounds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads)
from ra_slam_tpu.features import stereo as jstereo
from ra_slam_tpu.features.pyramid import rgb_to_gray as jax_gray
from ra_slam_tpu.io.synthetic import look_at, render_box_room
from ra_slam_tpu_torch.features import stereo as tstereo
from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
from test_stereo import BASELINE, FXB, HE, SPEC

D = 32
HALF = 4  # the 9x9 box's half width


@pytest.fixture(scope="module")
def pair():
    w_T_l = look_at(np.array([0.3, 0.0, 0.0]), np.array([0.0, 0.0, 1.5]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * BASELINE
    rgb_l, depth_gt, _, _ = render_box_room(SPEC, w_T_l, HE, checker=0.125)
    rgb_r, _, _, _ = render_box_room(SPEC, w_T_r, HE, checker=0.125)
    return rgb_l, rgb_r, depth_gt


def _gray(rgb):
    return rgb_to_gray(torch.as_tensor(rgb)).numpy()


def test_gray_matches_jax(pair):
    rgb_l = pair[0]
    np.testing.assert_array_equal(_gray(rgb_l), np.asarray(jax_gray(jnp.asarray(rgb_l, jnp.float32))))


@pytest.mark.parametrize("radius", [1, 2])
def test_census_matches_jax(pair, radius):
    g = _gray(pair[0])
    with jax.disable_jit():
        want = np.asarray(jstereo.census_transform(jnp.asarray(g), radius)).astype(np.int64)
    got = tstereo.census_transform(torch.as_tensor(g), radius).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_popcount_is_exact():
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 2**24, 5000), dtype=torch.int32)
    want = [bin(int(v)).count("1") for v in x]
    assert tstereo._popcount(x).tolist() == want


def test_dense_stereo_matches_jax(pair):
    """`valid` and depth exactly equal wherever no sentinel cost can
    reach the decision (columns >= 2 D + 2 * 4); elsewhere at most 2% of
    those columns' pixels differ, and `valid` stays False below D."""
    gl, gr = _gray(pair[0]), _gray(pair[1])
    with jax.disable_jit():
        jd, jv = jstereo.dense_stereo_depth(jnp.asarray(gl), jnp.asarray(gr), FXB, max_disparity=D)
    jd, jv = np.asarray(jd), np.asarray(jv)
    td, tv = tstereo.dense_stereo_depth(torch.as_tensor(gl), torch.as_tensor(gr), FXB, max_disparity=D)
    td, tv = td.numpy(), tv.numpy()
    clean = slice(2 * D + 2 * HALF, None)
    np.testing.assert_array_equal(tv[:, clean], jv[:, clean])
    np.testing.assert_array_equal(td[:, clean], jd[:, clean])
    assert not tv[:, :D].any() and not jv[:, :D].any()
    edge = (tv != jv)[:, : 2 * D + 2 * HALF]
    assert edge.mean() <= 0.02, edge.sum()
    assert tv.mean() > 0.3


def test_dense_stereo_accuracy(pair):
    """tests/test_stereo.py:158's gates on the port alone."""
    rgb_l, rgb_r, depth_gt = pair
    d, v = tstereo.dense_stereo_depth(torch.as_tensor(_gray(rgb_l)), torch.as_tensor(_gray(rgb_r)),
                                      FXB, max_disparity=D)
    d, v = d.numpy(), v.numpy()
    assert v[:, 40:].mean() > 0.5, v[:, 40:].mean()
    rel = np.abs(d[v] - depth_gt[v]) / depth_gt[v]
    assert np.median(rel) < 0.05 and (rel < 0.1).mean() > 0.9


def test_dense_stereo_rejects_flat_regions():
    """tests/test_stereo.py:187: no confident depth on a flat image."""
    flat = torch.full((120, 160), 100.0)
    _, valid = tstereo.dense_stereo_depth(flat, flat, FXB, max_disparity=D)
    assert valid.float().mean().item() < 0.2


def test_census_radius_beyond_int32_raises():
    with pytest.raises(ValueError, match="bits"):
        tstereo.census_transform(torch.zeros(8, 8), radius=3)
