"""`mfu.fuse`: the whole fused frame's share of the chip's bf16 peak, in
percent: the UNet's forward operations a frame (counted from its layer
shapes at the map's frame size, `benchmark/harness/work.py:unet_flops`),
times the frames fused in the traced stretch, over the stretch's seconds
and 989 TFLOP/s (the H100's dense bf16 peak at 700 W; the convolutions
run in bf16). The card's power limit is printed beside it (the result's
`card`). Source: device trace (the traced stretch). Moves `fused_fps`."""

from benchmark.harness.work import BF16_FLOPS_PER_S, unet_flops

SOURCE, UNIT, MOVES = "device_trace", "%", "fused_fps"


def read(out, cell):
    tr = out.get("trace")
    frames = out["counters"].get("traced_fused", 0)
    if tr is None or frames == 0 or tr.window_s <= 0:
        return None
    c = cell.config
    flops = unet_flops(c["segmentation"]["widths"], c["depth_camera"]["height"], c["depth_camera"]["width"])
    return 100.0 * flops * frames / tr.window_s / BF16_FLOPS_PER_S
