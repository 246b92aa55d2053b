"""Carried steps of the port's SLAM system against the JAX package's own
step, at the frames of the EVAL matrix's `ba1` row (hardened VGA scene,
seed 0, BA at every keyframe, loop closing on) where a free-running
comparison of the two packages parts.

Each fixture (tests/data/make_lockstep_fixtures.py) holds the JAX state
before a frame, taken from the JAX package's jitted run, and what the
JAX step of that frame gives op by op (`jax.disable_jit()`: the source's
float32 operations as written). The port steps the frame on the CPU from
that state through `SlamSystem.feed_rgbd_frame` and is held to it:
every discrete `FrameInfo` field and integer state field exactly, poses
within 1e-5, landmarks 2e-5, stored pixels 1e-3, the BA rmse 1e-4
(tests/test_torch_slam_ba.py's bounds). The frame itself is rendered by
both packages' datasets, checked equal.

- frame 17, the first tracked frame after the BA of a keyframe: op by
  op, and in the port, 312 matches and 301 inliers; the jitted JAX step
  finds 311 and 300 and lands 3e-4 m away. XLA's CPU backend contracts
  multiply-adds under jit (the quirk ROADMAP queue 3 lists), and here
  that drops one FAST corner (a 3x3 non-maximum-suppression tie: equal
  scores op by op, one ulp apart under jit);
- frame 23, where the port found 224 / 213 against JAX's 225 / 214
  until its pyramid summed as XLA's CPU dot does: a level-1 pixel one
  ulp off put a blurred value either side of a bf16 rounding boundary
  (139.49997 against 139.5), and one BRIEF bit flipped;
- the first relocalization of the jitted run (frame 49);
- the first keyframe with its windowed BA after it (frame 52).
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))

import lockstep_torch_jax as ls  # noqa: E402

FIXTURES = sorted(glob.glob(os.path.join(HERE, "data", "lockstep_ba1_f*.npz")))


def _load(path):
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    split = lambda p: {k[len(p) + 1:]: v for k, v in d.items() if k.startswith(p + ".")}
    info = {k: (v.tolist() if k in ("R", "t") else v.item()) for k, v in split("info").items()}
    jit = {k: (v.tolist() if k in ("R", "t") else v.item()) for k, v in split("jit").items()}
    return int(d["meta.frame"]), str(d["meta.row"]), split("before"), split("after"), info, jit


def test_fixtures_present():
    frames = [_load(p)[0] for p in FIXTURES]
    assert {17, 23, 49, 52} <= set(frames), frames


@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p)[:-4] for p in FIXTURES])
def test_carried_step_matches_jax_op_by_op(path):
    torch.set_num_threads(2)
    frame, row, before, after, info, jit = _load(path)
    kw = ls.rows()[row]
    tds, ts = ls.port_setup(kw)
    fr = ls.checked_frame(ls.jax_dataset(kw["seed"]), tds, frame)
    ts.state = slam_state_from_numpy(ls.nested(before), "cpu")
    pinfo = ls.port_info(ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=frame))
    bad = ls.compare(ls.flat_port(ts.state), pinfo, after, info)
    assert not bad, (frame, bad)
    np.testing.assert_allclose(pinfo["t"], info["t"], atol=ls.POSE_TOL)
    np.testing.assert_allclose(pinfo["R"], info["R"], atol=ls.POSE_TOL)
    if frame == 17:
        # the op-by-op step and the port; the jitted step parts (XLA's
        # contracted multiply-adds)
        assert (pinfo["num_matches"], pinfo["num_inliers"]) == (312, 301)
        assert (jit["num_matches"], jit["num_inliers"]) == (311, 300)
    if frame == 23:
        assert (pinfo["num_matches"], pinfo["num_inliers"]) == (225, 214)
    if frame == 49:
        assert pinfo["relocalized"] and pinfo["tracked"]
    if frame == 52:
        assert pinfo["inserted_keyframe"] and np.isfinite(pinfo["ba_rmse"])
