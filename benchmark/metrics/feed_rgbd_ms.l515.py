"""`feed_rgbd_ms.l515`: host milliseconds an L515 frame in the program's
`facade.feed_rgbd` span (`RaSlamSystem.feed_rgbd_frame` with no pose:
the pose query and extrinsics, the 1280x720 upload and its resizes to
the map's size, the UNet, allocate / cull / prep / fuse / carve), the
mean over the fused frames outside the traced stretch. Source: the
program's span registry. Moves `fused_fps`. None where the program has
no such span."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fused_fps"


def read(out, cell):
    return (out.get("program") or {}).get("feed_rgbd_ms")
