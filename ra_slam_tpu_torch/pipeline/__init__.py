"""System facade and CLI entry points (counterpart of `ra_slam_tpu.pipeline`)."""
