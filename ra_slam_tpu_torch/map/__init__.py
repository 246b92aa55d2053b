"""The sparse voxel-block TSDF map (counterpart of `ra_slam_tpu.map`)."""
