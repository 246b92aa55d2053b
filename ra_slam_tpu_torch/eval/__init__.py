"""Evaluation: trajectory metrics, the trajectory bench, PLY I/O, the
ScanNet semantic evaluation and the mesh-dump reader (counterpart of
`ra_slam_tpu.eval`)."""
