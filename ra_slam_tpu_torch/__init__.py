"""ra_slam_tpu_torch — the PyTorch/CUDA port of `ra_slam_tpu`.

The JAX package `ra_slam_tpu` is the reference; every module here has a
counterpart of the same subpackage and module name there, and each is
held against it by a parity test (`tests/test_torch_*.py`).

The port is plain PyTorch: functions on tensors, an explicit `device`
argument at every entry point, no global device state. The one kernel
on the fusion path, `ops/tsdf_fuse.py`, is a CUDA C++ kernel for Hopper
(`csrc/tsdf_fuse.cu`) built from the sources at first use; on CPU
tensors it runs its plain PyTorch version.

Importing any module of this package needs only torch and numpy: no
JAX, flax, yaml or OpenCV (those are imported, if at all, inside the
function that needs them).

Subpackages
-----------
core      SE3, pinhole camera, configuration dataclasses
io        RGB-D frame/dataset types, synthetic box-room dataset
map       block keys, spatial hash, the voxel map and its fusion step
ops       hand-written device kernels and their plain versions
models    segmentation engine (fake mode)
pipeline  RaSlamSystem facade, offline_eval CLI
utils     conversion of map state to and from the JAX package
"""

__version__ = "0.1.0"
