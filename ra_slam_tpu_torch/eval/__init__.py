"""Evaluation: trajectory metrics and the trajectory bench (counterpart
of `ra_slam_tpu.eval`)."""
