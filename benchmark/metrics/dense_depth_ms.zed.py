"""`dense_depth_ms.zed`: host milliseconds a fused ZED pair in the
program's `stereo.dense` span (`features/stereo.py:dense_stereo_depth`,
which `ZedDepthCamera.depth` calls: census, the cost volume, its box
sums and the selection, launched on the card), the mean over the fused
pairs outside the traced stretch. Source: the program's span registry.
Moves `fused_fps` (each fused pair waits for its depth). None where the
program has no such span."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fused_fps"


def read(out, cell):
    return (out.get("program") or {}).get("dense_ms")
