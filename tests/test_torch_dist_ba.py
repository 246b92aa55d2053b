"""Distributed bundle adjustment of the PyTorch port (ra_slam_tpu_torch/
parallel/dist_ba.py) against the JAX package on the CPU.

The problem is tests/test_dist_ba.py's: tests/test_ba.py's 6 keyframes
and 120 points, perturbed, one window of 8 rows and 256 landmark slots,
8 iterations. The JAX reference is JAX's own shard body (`_solve_shard`)
op by op, the two shards stacked on a `vmap` axis named "ba" that serves
its `all_gather`, `psum_scatter` and `psum` (through `jax.shard_map` op
by op it takes minutes; tests/test_torch_sharded_map.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import _make_problem, _perturb
from ra_slam_tpu.parallel import dist_ba as jdba
from ra_slam_tpu.slam import ba as jba
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.parallel import LocalMesh, distributed_bundle_adjustment, solve_window_distributed
from ra_slam_tpu_torch.slam import ba as tba
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks
from ra_slam_tpu_torch.utils.convert import tree_from_numpy

N_SHARDS, WINDOW, MAX_POINTS, ITERS = 2, 8, 256, 8
TCAM = PinholeCamera.create(200.0, 200.0, 159.5, 119.5, 320, 240)
# port vs JAX's op-by-op shard body: float32 Gauss-Newton from identical
# inputs, the normal equations summed in other orders (index_add_ vs
# segment_sum, one matmul vs XLA's einsum) over 8 iterations: measured
# 5.3e-7 on poses, 1.8e-5 on points (at 3-6 m), 2.6e-8 px on the rmse
POSE_TOL = 2e-5
POINT_TOL = 5e-5
RMSE_ATOL = 1e-5
# tests/test_dist_ba.py's bounds: the distributed optimum vs the
# single-device solver's
SINGLE_POSE_TOL, SINGLE_POINT_TOL = 1e-3, 5e-3


@functools.lru_cache()
def _problem():
    cam, kfs, lms, _, _, num_kf, num_pts = _make_problem()
    kfs, lms = _perturb(kfs, lms, num_kf, num_pts)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    tk, tl = tree_from_numpy(Keyframes, np_(kfs), "cpu"), tree_from_numpy(Landmarks, np_(lms), "cpu")
    return cam, kfs, lms, tk, tl, num_kf, num_pts


@functools.lru_cache()
def _jax_solve():
    """JAX's `_solve_shard` op by op over N_SHARDS stacked shards."""
    cam, kfs, lms, _, _, num_kf, _ = _problem()
    n = N_SHARDS
    with jax.disable_jit():
        win = jba.gather_window(kfs, lms, jnp.int32(num_kf), WINDOW, MAX_POINTS)
        st = lambda x: x.reshape(n, -1, *x.shape[1:])
        obs = ("obs_k", "obs_l", "obs_uv", "obs_w", "obs_z")
        axes = win._replace(**{f: None for f in win._fields})._replace(**{f: 0 for f in obs})
        body = functools.partial(jdba._solve_shard, axis_size=n, cam=cam, axis="ba", iterations=ITERS,
                                 huber_delta=3.0, damping=1e-4, chi2_prune=36.0, pose_prior=2e3)
        poses, points, rmse = jax.vmap(body, in_axes=(None, 0, 0, axes), axis_name="ba")(
            win.poses, st(win.points), st(win.point_ok), win._replace(**{f: st(getattr(win, f)) for f in obs}))
        r0, _, _, ok0 = jba._residuals(win.poses, win.points, win, cam)
        rmse0 = jba._weighted_rmse(r0, win.obs_w * ok0)
    return (np.asarray(poses.R[0]), np.asarray(poses.t[0]), np.asarray(points).reshape(-1, 3),
            float(rmse[0]), float(rmse0))


def _port_window():
    _, _, _, tk, tl, num_kf, _ = _problem()
    return tba.gather_window(tk, tl, num_kf, WINDOW, MAX_POINTS)


def test_solve_window_distributed_matches_jax():
    """2 LocalMesh shards against JAX's shard body: poses, points and
    rmse within the bounds; the fit converges (tests/test_dist_ba.py)."""
    jR, jt, jx, jrmse, jrmse0 = _jax_solve()
    win = _port_window()
    poses, points, st = solve_window_distributed(win, TCAM, LocalMesh(N_SHARDS, "cpu", axis="ba"),
                                                 iterations=ITERS)
    np.testing.assert_allclose(poses.R.numpy(), jR, atol=POSE_TOL)
    np.testing.assert_allclose(poses.t.numpy(), jt, atol=POSE_TOL)
    ok = win.point_ok.numpy()
    np.testing.assert_allclose(points.numpy()[ok], jx[ok], atol=POINT_TOL)
    np.testing.assert_allclose(float(st.rmse_after), jrmse, atol=RMSE_ATOL)
    np.testing.assert_allclose(float(st.rmse_before), jrmse0, rtol=1e-5)
    assert float(st.rmse_after) < 0.5 and float(st.rmse_after) < 0.1 * float(st.rmse_before)
    assert int(st.num_points) == int(ok.sum()) and int(st.points_dropped) == 0


@pytest.mark.parametrize("n", [1, 2, 4])
def test_distributed_matches_single_device_solver(n):
    """The distributed optimum against the port's `solve_window` on the
    same window, at 1, 2 and 4 shards (the JAX test's bounds); at 1
    shard the two are the same operations."""
    win = _port_window()
    p1, x1, s1 = tba.solve_window(win, TCAM, iterations=ITERS)
    pd, xd, sd = solve_window_distributed(win, TCAM, LocalMesh(n, "cpu", axis="ba"), iterations=ITERS)
    ok = win.point_ok.numpy()
    np.testing.assert_allclose(pd.t.numpy(), p1.t.numpy(), atol=SINGLE_POSE_TOL)
    np.testing.assert_allclose(xd.numpy()[ok], x1.numpy()[ok], atol=SINGLE_POINT_TOL)
    if n == 1:
        assert torch.equal(pd.R, p1.R) and torch.equal(pd.t, p1.t) and torch.equal(xd, x1)


def test_distributed_bundle_adjustment_scatters_back():
    """gather -> distributed solve -> scatter: the databases take the
    solved rows (keyframe 0 stays the gauge anchor)."""
    _, _, _, tk, tl, num_kf, num_pts = _problem()
    mesh = LocalMesh(N_SHARDS, "cpu", axis="ba")
    k2, l2, st = distributed_bundle_adjustment(tk, tl, num_kf, TCAM, mesh, window=WINDOW, max_points=MAX_POINTS,
                                               iterations=ITERS)
    poses, points, _ = solve_window_distributed(_port_window(), TCAM, mesh, iterations=ITERS)
    assert torch.equal(k2.t[:num_kf], poses.t[:num_kf]) and torch.equal(k2.t[0], tk.t[0])
    assert torch.equal(l2.pos[:num_pts], points[:num_pts])
    assert float(st.rmse_after) < 0.1 * float(st.rmse_before)


def test_mesh_size_must_divide_the_capacities():
    win = _port_window()
    with pytest.raises(AssertionError, match="divisible by mesh size 3"):
        solve_window_distributed(win, TCAM, LocalMesh(3, "cpu", axis="ba"))
    with pytest.raises(KeyError):
        solve_window_distributed(win, TCAM, LocalMesh(2, "cpu", axis="map"))
