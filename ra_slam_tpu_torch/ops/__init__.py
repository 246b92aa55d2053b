"""Device kernels written by hand for Hopper, each beside its plain
PyTorch version (counterpart of `ra_slam_tpu.ops`)."""
