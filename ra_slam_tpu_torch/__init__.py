"""ra_slam_tpu_torch — the PyTorch/CUDA port of `ra_slam_tpu`.

The JAX package `ra_slam_tpu` is the reference; every module here has a
counterpart of the same subpackage and module name there, and each is
held against it by a parity test (`tests/test_torch_*.py`).

The port is plain PyTorch: functions on tensors, an explicit `device`
argument at every entry point, no global device state. Each of the JAX
package's two Pallas kernels is a CUDA C++ kernel for Hopper, built from
the sources at first use: the fuse kernel of the fusion path
(`ops/tsdf_fuse.py`, `csrc/tsdf_fuse.cu`) and the Hamming-matrix kernel
of the tracking path (`ops/hamming.py`, `csrc/hamming.cu`). On CPU
tensors each runs its plain PyTorch version.

Importing any module of this package needs only torch and numpy: no
JAX, flax, yaml or OpenCV (those are imported, if at all, inside the
function that needs them).

Subpackages
-----------
Each subpackage's `__init__` re-exports the names its JAX counterpart's
does.

core      SE3/SO(3), pinhole camera, configuration dataclasses, stereo
          rectification
features  pyramid, FAST, ORB descriptors, descriptor matching, stereo
          keypoint depth and dense stereo
io        RGB-D frame/dataset types, synthetic box-room dataset, logged
          folders, ScanNet .sens files, PNG and JPEG codecs, cameras and
          the capture tool
map       block keys, spatial hash, the voxel map and its fusion step,
          raycast rendering, marching-tetrahedra meshing, the analytic
          box-room map
ops       hand-written device kernels and their plain versions, resize
slam      landmarks, motion-only GN, tracking, keyframes, bundle
          adjustment, pose graph, loop detection, relocalization,
          SlamSystem
models    the segmentation UNet: inference engine and training step
pipeline  RaSlamSystem facade, offline_eval CLI, live robot loop, map
          viewer CLI, bench_scaling
parallel  sharded TSDF fusion and export, distributed bundle adjustment,
          multi-process wiring, the shard meshes
eval      ATE/RPE, the tracking trajectory bench, PLY I/O, ScanNet
          semantic evaluation, the mesh-dump reader
utils     pose buffer; map and SLAM state to and from the JAX package;
          checkpoints, flax msgpack and flat YAML readers, logging and
          profiling
"""

__version__ = "0.1.0"
