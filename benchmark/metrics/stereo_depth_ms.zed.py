"""`stereo_depth_ms.zed`: host milliseconds a ZED pair in the program's
`slam.stereo_depth` span (`SlamSystem.feed_stereo_frame`: per-keypoint
epipolar ZNCC depth and its sparse depth image), the mean over the pairs
outside the traced stretch. Source: the program's span registry. Moves
`track_ms_p95`. None where the program has no such span."""

SOURCE, UNIT, MOVES = "program_span", "ms", "track_ms_p95"


def read(out, cell):
    return (out.get("program") or {}).get("stereo_depth_ms")
