"""Geometry and configuration (counterpart of `ra_slam_tpu.core`)."""
