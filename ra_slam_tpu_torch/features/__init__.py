"""ORB features: pyramid, FAST, descriptors, matching (counterpart of
`ra_slam_tpu.features`)."""
