"""General harness code: inputs from the seed, the trace, the yardstick."""
