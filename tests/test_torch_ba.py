"""Bundle adjustment of the PyTorch port (ra_slam_tpu_torch/slam/ba.py)
against the JAX package on the CPU.

The problem is tests/test_ba.py's: 120 world points seen by 6 (or 12)
keyframes on a sideways track, 200 px focal length at 320x240, built by
the JAX package and carried to the port through numpy, then perturbed
(poses 0.02, points 0.05). The JAX side runs op by op (see
tests/torch_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.core.se3 import exp_se3 as jax_exp_se3
from ra_slam_tpu.slam import ba as jba
from ra_slam_tpu.slam.keyframes import create_keyframes, insert_keyframe
from ra_slam_tpu.slam.landmarks import create_landmarks
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.slam import ba as tba
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks
from ra_slam_tpu_torch.utils.convert import tree_from_numpy, tree_to_numpy

JCAM = JaxCamera.create(200.0, 200.0, 159.5, 119.5, 320, 240)
TCAM = PinholeCamera.create(200.0, 200.0, 159.5, 119.5, 320, 240)
# float32 Gauss-Newton from identical inputs; the packages sum the
# normal equations in other orders (index_add_ vs segment_sum, one
# matmul vs XLA's einsum): measured <= 6.1e-5 on residuals and Jacobians
# with entries up to ~400 (relative 2.3e-7), <= 1e-6 on poses and points
RES_RTOL, RES_ATOL = 1e-5, 2e-4
POSE_TOL = 2e-5
POINT_TOL = 2e-5
RMSE_ATOL = 1e-5  # px, at a converged rmse of ~1e-5 px (measured 4.4e-7 apart)


def _problem(num_kf=6, num_pts=120, F=160, seed=0):
    """tests/test_ba.py's problem, perturbed, as JAX (kfs, lms)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.0, 2.0, num_pts), rng.uniform(-1.5, 1.5, num_pts),
                    rng.uniform(3.0, 6.0, num_pts)], axis=-1).astype(np.float32)
    kfs = create_keyframes(capacity=16, num_features=F)
    lms = create_landmarks(1024)
    lms = lms._replace(pos=lms.pos.at[:num_pts].set(pts), valid=lms.valid.at[:num_pts].set(True))
    obs_lm = np.r_[np.arange(num_pts), -np.ones(F - num_pts)].astype(np.int32)
    # every third keyframe row carries no depth for odd landmarks
    for k in range(num_kf):
        xi = np.zeros(6, np.float32)
        xi[1], xi[3] = 0.03 * k, 0.15 * k
        pose = jax_exp_se3(jnp.asarray(xi))
        uv, z = JCAM.project(pose.apply(jnp.asarray(pts)))
        w = (z > 0).astype(jnp.float32) * JCAM.in_bounds(uv)
        zobs = np.where((np.arange(num_pts) % 2 == 1) & (k % 3 == 0), 0.0, np.asarray(z)).astype(np.float32)
        kfs = insert_keyframe(
            kfs, jnp.int32(k), pose, jnp.int32(k), jnp.float32(k / 30.0), jnp.asarray(obs_lm),
            jnp.concatenate([uv, jnp.zeros((F - num_pts, 2))]), jnp.concatenate([w, jnp.zeros(F - num_pts)]),
            jnp.zeros((F, 8), jnp.uint32), jnp.asarray(np.r_[zobs, np.zeros(F - num_pts, np.float32)]),
        )
    rng = np.random.default_rng(seed + 1)
    for k in range(1, num_kf):
        noisy = jax_exp_se3(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32)) @ JaxSE3(kfs.R[k], kfs.t[k])
        kfs = kfs._replace(R=kfs.R.at[k].set(noisy.R), t=kfs.t.at[k].set(noisy.t))
    noise = rng.normal(0, 0.05, (num_pts, 3)).astype(np.float32)
    lms = lms._replace(pos=lms.pos.at[:num_pts].add(jnp.asarray(noise)))
    return kfs, lms


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(kfs, lms):
    return tree_from_numpy(Keyframes, _np(kfs), "cpu"), tree_from_numpy(Landmarks, _np(lms), "cpu")


def _assert_poses(t: SE3, j, tol=POSE_TOL):
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=tol)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=tol)


def _windows(kw, num_kf=6):
    kfs, lms = _problem(num_kf=num_kf)
    with jax.disable_jit():
        jw = jba.gather_window(kfs, lms, jnp.int32(num_kf), **kw)
    tk, tl = _port(kfs, lms)
    tw = tba.gather_window(tk, tl, torch.tensor(num_kf, dtype=torch.int32), **kw)
    return jw, tw, (kfs, lms), (tk, tl)


GATHER_CASES = {
    "local": dict(window=4, max_points=256),
    "local_fixed": dict(window=3, max_points=256, n_fixed=2),
    "gba_chunk": dict(window=4, max_points=256, start=2),
    "overflow": dict(window=4, max_points=50, n_fixed=1),
    "past_counter": dict(window=8, max_points=256, start=12),  # rows clamped to slot 15
}


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_window_matches_jax(case):
    """Every field exact: slots, free flags, the sorted-unique landmark
    set and its overflow count, local indices, gathered values."""
    kw = dict(GATHER_CASES[case])
    if "start" in kw:
        kw["start"] = jnp.int32(kw["start"])
    jw, tw, _, _ = _windows(kw)
    jn, tn = _np(jw), tree_to_numpy(tw)
    for f in dataclasses.fields(tba.BAWindow):
        if f.name == "poses":
            np.testing.assert_array_equal(tn.poses.R, jn.poses.R)
            np.testing.assert_array_equal(tn.poses.t, jn.poses.t)
        else:
            np.testing.assert_array_equal(getattr(tn, f.name), getattr(jn, f.name), err_msg=f.name)
    if case == "overflow":
        assert int(tw.points_dropped) > 0 and int(tw.point_ok.sum()) == 50
    elif case == "past_counter":
        assert not tw.kf_free.any() and not tw.point_ok.any()
    else:
        assert int(tw.points_dropped) == 0 and int(tw.point_ok.sum()) > 0


def test_residuals_match_jax():
    jw, tw, _, _ = _windows(dict(window=6, max_points=256))
    with jax.disable_jit():
        jr = jba._residuals(jw.poses, jw.points, jw, JCAM)
    tr = tba._residuals(tw.poses, tw.points, tw, TCAM)
    for name, a, b in zip(("r", "J_p", "J_x"), tr[:3], jr[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RES_RTOL, atol=RES_ATOL, err_msg=name)
    np.testing.assert_array_equal(tr[3].numpy(), np.asarray(jr[3]))
    # the depth row is zero exactly where the observation has no depth
    no_z = tw.obs_z.numpy() <= 1e-6
    assert no_z.any() and (tr[0].numpy()[no_z, 2] == 0).all()


def test_clamp_twist_and_robust_weight_match_jax():
    rng = np.random.default_rng(7)
    xi = (rng.normal(0, 1, (50, 6)) * rng.choice([1e-3, 0.1, 3.0], (50, 1))).astype(np.float32)
    r2 = rng.uniform(0, 50, 200).astype(np.float32)
    with jax.disable_jit():
        jc, jwt = jba.clamp_twist(jnp.asarray(xi)), jba._robust_weight(jnp.asarray(r2), 3.0)
    np.testing.assert_allclose(tba.clamp_twist(torch.from_numpy(xi)).numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tba._robust_weight(torch.from_numpy(r2), 3.0).numpy(), np.asarray(jwt), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(window=6, n_fixed=0, pose_prior=0.0), dict(window=4, n_fixed=2, pose_prior=2e3)],
                         ids=["free", "fixed_observers_prior"])
def test_solve_window_matches_jax(kw):
    """Two-phase Schur GN (8 iterations, chi2 pruning between the
    phases): poses and points within the bounds, the same counts and
    rmse, and the fit converges."""
    kw = dict(kw)
    prior = kw.pop("pose_prior")
    jw, tw, _, _ = _windows(dict(max_points=256, **kw))
    with jax.disable_jit():
        jp, jx, js = jba.solve_window(jw, JCAM, iterations=8, pose_prior=prior)
    tp, tx, ts = tba.solve_window(tw, TCAM, iterations=8, pose_prior=prior)
    _assert_poses(tp, jp)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POINT_TOL)
    for name in ("num_poses", "num_points", "num_obs", "points_dropped"):
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    for name in ("rmse_before", "rmse_after"):
        np.testing.assert_allclose(float(getattr(ts, name)), float(getattr(js, name)), rtol=1e-4, atol=RMSE_ATOL)
    assert float(ts.rmse_before) > 1.0 and float(ts.rmse_after) < 0.2 * float(ts.rmse_before)


def test_scatter_window_matches_jax():
    """Written rows exact, a repeated (clamped) slot's last write wins,
    dropped landmarks untouched."""
    jw, tw, (jk, jl), (tk, tl) = _windows(dict(window=8, max_points=256, start=jnp.int32(12)))
    rng = np.random.default_rng(3)
    W, L = tw.kf_free.shape[0], tw.points.shape[0]
    xi = rng.normal(0, 0.1, (W, 6)).astype(np.float32)
    X = rng.normal(0, 1, (L, 3)).astype(np.float32)
    with jax.disable_jit():
        P = jax_exp_se3(jnp.asarray(xi))
        jk2, jl2 = jba.scatter_window(jk, jl, jw, P, jnp.asarray(X))
    tk2, tl2 = tba.scatter_window(tk, tl, tw, SE3(torch.from_numpy(np.array(P.R)), torch.from_numpy(np.array(P.t))),
                                  torch.from_numpy(X))
    np.testing.assert_array_equal(tk2.R.numpy(), np.asarray(jk2.R))
    np.testing.assert_array_equal(tk2.t.numpy(), np.asarray(jk2.t))
    np.testing.assert_array_equal(tl2.pos.numpy(), np.asarray(jl2.pos))


def test_local_bundle_adjustment_matches_jax():
    kfs, lms = _problem()
    kw = dict(window=3, max_points=256, iterations=6, n_fixed=2)
    with jax.disable_jit():
        jk, jl, js = jba.local_bundle_adjustment(kfs, lms, jnp.int32(6), JCAM, **kw)
    tk, tl = _port(kfs, lms)
    tk, tl, ts = tba.local_bundle_adjustment(tk, tl, torch.tensor(6, dtype=torch.int32), TCAM, **kw)
    _assert_poses(SE3(tk.R, tk.t), jk)
    np.testing.assert_allclose(tl.pos.numpy(), np.asarray(jl.pos), atol=POINT_TOL)
    np.testing.assert_allclose(float(ts.rmse_after), float(js.rmse_after), rtol=1e-4, atol=RMSE_ATOL)
    # the fixed observers and keyframe 0 did not move
    np.testing.assert_array_equal(tk.R[:3].numpy(), np.asarray(kfs.R[:3]))


def test_global_bundle_adjustment_matches_jax():
    """12 keyframes, window 4: five overlapping chunks, two sweeps; the
    chunk count is read from a device counter in the port."""
    kfs, lms = _problem(num_kf=12)
    kw = dict(window=4, max_points=256, iterations=4, sweeps=2, pose_prior=0.0)
    with jax.disable_jit():
        jk, jl, js = jba.global_bundle_adjustment(kfs, lms, jnp.int32(12), JCAM, **kw)
    tk, tl = _port(kfs, lms)
    tk, tl, ts = tba.global_bundle_adjustment(tk, tl, torch.tensor(12, dtype=torch.int32), TCAM, **kw)
    _assert_poses(SE3(tk.R, tk.t), jk)
    np.testing.assert_allclose(tl.pos.numpy(), np.asarray(jl.pos), atol=POINT_TOL)
    for name in ("num_poses", "num_obs"):
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    np.testing.assert_allclose(float(ts.rmse_after), float(js.rmse_after), rtol=1e-4, atol=RMSE_ATOL)
    assert float(ts.rmse_after) < 0.3 * float(ts.rmse_before)
