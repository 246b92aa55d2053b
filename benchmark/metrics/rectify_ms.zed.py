"""`rectify_ms.zed`: host milliseconds a ZED pair in the program's
`rectify.remap` and `rectify.to_host` spans (`StereoRectifier.rectify`:
the raw views' upload, both remaps on the card, the copy back), the mean
over the pairs outside the traced stretch. Source: the program's span
registry. Moves `fused_fps` (each fused L515 frame waits for two
rectified pairs). None where the program has no such span."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fused_fps"


def read(out, cell):
    return (out.get("program") or {}).get("rectify_ms")
