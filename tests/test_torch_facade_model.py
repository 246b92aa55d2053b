"""The facade's segmentation of frames without maps with an engine of
other widths, in the PyTorch port against the JAX package on the CPU: a
(8, 16)-width checkpoint in both facades. Both nets compute in bf16
(tests/test_torch_segmentation.py's bounds), so the fused prob is held
to SEG_PROB_TOL (measured 0.0028), the rest to tests/torch_parity.py's
bounds. The JAX side runs op by op."""

import dataclasses

import jax
import numpy as np
import torch

import torch_parity as tp
from ra_slam_tpu.core import config as jcfg
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.models import segmentation as jseg
from ra_slam_tpu.pipeline.system import RaSlamSystem as JaxSystem
from ra_slam_tpu_torch.core import config as tcfg
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.io.folder import FolderReader, write_folder_dataset
from ra_slam_tpu_torch.models import segmentation as tseg
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy
from test_torch_recorded import _orbit
from test_torch_recorded_model import SEG_PROB_TOL


def test_model_through_facades_with_narrow_widths(tmp_path):
    """A (8, 16)-width checkpoint (random weights, saved by the port) in
    both facades, built with those widths, fed a port-written folder's
    frames without maps: the same stats and keys, prob within
    SEG_PROB_TOL."""
    ds, frames = _orbit(1)
    folder = str(tmp_path / "rec")
    write_folder_dataset(folder, [dataclasses.replace(f, ht=None, lt=None) for f in frames], ds.camera)
    ckpt = str(tmp_path / "seg.msgpack")
    c = tp.CAM_KW
    tseg.InferenceEngine("__random__", c["width"], c["height"], widths=(8, 16), device="cpu").save(ckpt)
    cam = dict(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    js = JaxSystem(jcfg.SystemConfig(camera=jcfg.CameraConfig(**cam), tsdf=tp.jax_cfg()), enable_tracking=False)
    ts = RaSlamSystem(tcfg.SystemConfig(camera=tcfg.CameraConfig(**cam), tsdf=tp.torch_cfg()), "cpu",
                      enable_tracking=False)
    js.seg = jseg.InferenceEngine(ckpt, c["width"], c["height"], widths=(8, 16))
    ts.seg = tseg.InferenceEngine(ckpt, c["width"], c["height"], widths=(8, 16), device="cpu")
    reader = FolderReader(folder)
    with jax.disable_jit():
        for i in range(len(reader)):
            f = reader.frame(i)
            assert f.ht is None
            jst = js.feed_rgbd_frame(f.rgb, f.depth, f.timestamp,
                                     pose=JaxSE3.from_matrix(jax.numpy.asarray(f.cam_T_world)))
            tst = ts.feed_rgbd_frame(f.rgb, f.depth, f.timestamp, pose=SE3.from_matrix(torch.as_tensor(f.cam_T_world)))
            assert tst == jst
    tp.assert_maps_match(jax.tree.map(np.asarray, js.map), voxel_map_to_numpy(ts.map),
                         tol={**tp.TOL, "prob": SEG_PROB_TOL})
