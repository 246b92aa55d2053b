"""Pose-graph optimisation of the PyTorch port
(ra_slam_tpu_torch/slam/pose_graph.py) against the JAX package on the
CPU.

The graph is tests/test_pose_graph.py's: a closed chain of keyframes one
metre apart turning around y, odometry estimates drifted by a seeded
twist noise, built by the JAX package and carried to the port through
numpy. The JAX side runs op by op (see tests/torch_parity.py), except
the whole-graph optimisation, which it runs jitted.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.core.se3 import exp_se3 as jax_exp_se3
from ra_slam_tpu.slam import pose_graph as jpg
from ra_slam_tpu.slam.keyframes import create_keyframes, insert_keyframe
from ra_slam_tpu.slam.landmarks import create_landmarks
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.slam import pose_graph as tpg
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks
from ra_slam_tpu_torch.utils.convert import tree_from_numpy

K, N = 16, 12  # node capacity, keyframes in the chain
# edge linearisation: the same float32 maps, forward-mode through
# torch.func.jvp vs jax.jacfwd; measured <= 8e-7 on residuals and
# Jacobian entries (of magnitude up to 1) on both chains
LIN_TOL = 1e-5
# ten Gauss-Newton solves of a [96, 96] system under a 1e6 gauge prior,
# assembled and factorised in other orders; measured <= 2.4e-7 on poses
POSE_TOL = 2e-5
RMSE_TOL = 1e-4  # rmse of 0.06-0.13 before, < 1e-6 after; measured <= 5e-8 apart


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _chain(drift: float, seed: int = 0):
    """(gt, est) pose lists of tests/test_pose_graph.py's square loop."""
    rng = np.random.default_rng(seed)
    gt, est, rels = [JaxSE3.identity()], [JaxSE3.identity()], []
    for _ in range(N - 1):
        xi = np.zeros(6, np.float32)
        xi[2], xi[4] = 1.0, 2 * np.pi / (N - 1)
        rels.append(jax_exp_se3(jnp.asarray(xi)))
        gt.append(rels[-1] @ gt[-1])
    for rel in rels:
        noise = jax_exp_se3(jnp.asarray(drift * rng.standard_normal(6), jnp.float32))
        est.append(noise @ rel @ est[-1])
    return gt, est


def _graph(drift: float, consistent: bool, loop: bool = True):
    """JAX (kfs, edges) with the estimates as keyframe poses; the edges
    measure the estimates themselves (`consistent`, every residual zero)
    or the ground truth, plus a loop edge 0 -> N-1 of weight 2."""
    gt, est = _chain(drift)
    kfs = create_keyframes(K, 8)
    for k in range(N):
        kfs = insert_keyframe(
            kfs, jnp.int32(k), est[k], jnp.int32(k), jnp.float32(k), jnp.full((8,), -1, jnp.int32),
            jnp.zeros((8, 2)), jnp.zeros((8,)), jnp.zeros((8, 8), jnp.uint32),
        )
    meas = est if consistent else gt
    edges = jpg.create_edges(32)
    for i in range(N - 1):
        edges = jpg.add_edge(edges, jnp.int32(i), i, i + 1, jpg.odometry_edge(meas[i], meas[i + 1]), 1.0)
    if loop:
        edges = jpg.add_edge(edges, jnp.int32(N - 1), 0, N - 1, jpg.odometry_edge(meas[0], meas[N - 1]), 2.0)
    return kfs, edges, gt


def _port(kfs, edges):
    return tree_from_numpy(Keyframes, _np(kfs), "cpu"), tree_from_numpy(tpg.PoseGraphEdges, _np(edges), "cpu")


@pytest.mark.parametrize("consistent", [True, False], ids=["consistent", "drifted"])
def test_edge_jacobians_match_jacfwd(consistent):
    """r, J_i, J_j of every edge against jax.jacfwd. On the consistent
    chain every residual is zero, so the forward-mode tangents pass
    through log_se3 at the identity (norm and atan2 at 0): they must be
    finite there and equal JAX's."""
    kfs, edges, _ = _graph(drift=0.03, consistent=consistent)
    n = N
    Ti = JaxSE3(kfs.R[edges.i[:n]], kfs.t[edges.i[:n]])
    Tj = JaxSE3(kfs.R[edges.j[:n]], kfs.t[edges.j[:n]])
    Z = JaxSE3(edges.R[:n], edges.t[:n])
    with jax.disable_jit():
        jr, jJi, jJj = jax.vmap(jpg._edge_lin)(Ti, Tj, Z)
    t = lambda a: torch.from_numpy(np.array(a))
    tr, tJi, tJj = tpg._edge_lin(SE3(t(Ti.R), t(Ti.t)), SE3(t(Tj.R), t(Tj.t)), SE3(t(Z.R), t(Z.t)))
    for name, a, b in (("r", tr, jr), ("J_i", tJi, jJi), ("J_j", tJj, jJj)):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LIN_TOL, err_msg=name)
    if consistent:
        assert np.abs(np.asarray(jr)).max() < 1e-5


@pytest.mark.parametrize("case", ["drift_loop", "noop", "partial"])
def test_optimize_pose_graph_matches_jax(case):
    """drift_loop: drifted odometry with a loop edge, ten iterations;
    noop: edges that agree with the estimates (no pose moves); partial:
    only the first 8 nodes active, the rest frozen with their edges."""
    consistent = case == "noop"
    kfs, edges, gt = _graph(drift=0.03, consistent=consistent)
    kfc = 8 if case == "partial" else N
    # jitted as tests/test_pose_graph.py runs it (op by op it takes ~30 s
    # on a CPU; the comparison is within bounds, not bitwise)
    jk, js = jax.jit(functools.partial(jpg.optimize_pose_graph, max_nodes=K, iterations=10))(
        kfs, edges, jnp.int32(kfc))
    tk, te = _port(kfs, edges)
    tk2, ts = tpg.optimize_pose_graph(tk, te, torch.tensor(kfc, dtype=torch.int32), max_nodes=K, iterations=10)
    np.testing.assert_allclose(tk2.R.numpy(), np.asarray(jk.R), atol=POSE_TOL)
    np.testing.assert_allclose(tk2.t.numpy(), np.asarray(jk.t), atol=POSE_TOL)
    for name in ("rmse_before", "rmse_after"):
        np.testing.assert_allclose(float(getattr(ts, name)), float(getattr(js, name)), atol=RMSE_TOL, err_msg=name)
    # frozen nodes and node 0 (the gauge) stay where they were
    np.testing.assert_allclose(tk2.t[kfc:].numpy(), tk.t[kfc:].numpy(), atol=0)
    np.testing.assert_allclose(tk2.t[0].numpy(), tk.t[0].numpy(), atol=1e-5)
    if case == "noop":
        assert float(ts.rmse_after) < 1e-4
        np.testing.assert_allclose(tk2.t.numpy(), tk.t.numpy(), atol=1e-4)
    elif case == "drift_loop":
        err = lambda kk: np.mean([np.linalg.norm(np.asarray(kk.t[k]) - np.asarray(gt[k].t)) for k in range(N)])
        assert float(ts.rmse_after) < float(ts.rmse_before)
        assert err(tk2) < 0.2 * err(tk), (err(tk), err(tk2))


def test_correct_landmarks_matches_jax():
    """Every valid landmark moves with its creation keyframe; invalid
    ones and out-of-range anchors as in JAX."""
    rng = np.random.default_rng(5)
    kfs, _, _ = _graph(drift=0.03, consistent=False)
    new_R, new_t = [], []
    for k in range(K):
        T = jax_exp_se3(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)) @ JaxSE3(kfs.R[k], kfs.t[k])
        new_R.append(T.R)
        new_t.append(T.t)
    new = kfs._replace(R=jnp.stack(new_R), t=jnp.stack(new_t))
    M = 64
    lms = create_landmarks(M)
    lms = lms._replace(
        pos=jnp.asarray(rng.normal(0, 2, (M, 3)), jnp.float32),
        valid=jnp.asarray(rng.random(M) < 0.8),
        anchor=jnp.asarray(rng.integers(-2, K + 3, M), jnp.int32),  # clipped to [0, K-1]
    )
    with jax.disable_jit():
        jl = jpg.correct_landmarks(lms, kfs.R, kfs.t, new)
    tl = tree_from_numpy(Landmarks, _np(lms), "cpu")
    tk_old, tk_new = tree_from_numpy(Keyframes, _np(kfs), "cpu"), tree_from_numpy(Keyframes, _np(new), "cpu")
    out = tpg.correct_landmarks(tl, tk_old.R, tk_old.t, tk_new)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jl.pos), atol=1e-5)
    inval = ~np.asarray(lms.valid)
    np.testing.assert_array_equal(out.pos.numpy()[inval], np.asarray(lms.pos)[inval])
    for f in dataclasses.fields(Landmarks):
        if f.name != "pos":
            np.testing.assert_array_equal(getattr(out, f.name).numpy(), getattr(tl, f.name).numpy())
