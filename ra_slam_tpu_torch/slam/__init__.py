"""Sparse visual SLAM: landmarks, motion-only GN, tracking, keyframes,
pose-graph edges, loop detection and relocalization, the frame step
(counterpart of `ra_slam_tpu.slam`)."""
