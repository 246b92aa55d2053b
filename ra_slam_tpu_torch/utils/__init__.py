"""Utilities (counterpart of `ra_slam_tpu.utils`)."""
