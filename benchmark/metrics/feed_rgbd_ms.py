"""`feed_rgbd_ms`: host milliseconds a frame inside
`RaSlamSystem.feed_rgbd_frame` (upload, resize, segmentation, allocate,
cull, prep, the fuse kernel, carve; it returns host ints, so the span
ends synchronised), the mean over the fused frames outside the traced
stretch. Source: the harness's host span around each call. Moves
`fused_fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fused_fps"


def read(out, cell):
    xs = out["spans"].get("feed_rgbd") or []
    return 1e3 * sum(xs) / len(xs) if xs else None
