"""Learned components (counterpart of `ra_slam_tpu.models`)."""
