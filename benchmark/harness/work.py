"""The yardstick's arithmetic: the chip's published peaks, and the work of
the kernels and the net counted from the algorithm's shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

VOXELS = 512
TSDF_BYTES = 4  # float32
PAYLOAD_BYTES = 24  # a voxel's tsdf, weight, prob and rgb x 3, float32
IMAGE_PLANES = 6  # depth, r, g, b, ht, lt, float32


def fuse_bytes(num_visible: int, num_updated: int, height: int, width: int) -> int:
    """The least device-memory traffic of fusing one frame, from the
    fusion's semantics: every visible voxel's tsdf read once (the block's
    least |tsdf|, which carving reads, needs it); the rest of the payload
    (weight, prob, rgb) read, and the whole payload written, once for
    each voxel that the frame updates; and the frame's depth, colour and
    ht / lt read once. Intermediate arrays of any one implementation (a
    voxel's pixel, depth, range scale and gate) are not the fusion's work
    and are not counted."""
    return (num_visible * VOXELS * TSDF_BYTES
            + num_updated * (2 * PAYLOAD_BYTES - TSDF_BYTES)
            + IMAGE_PLANES * 4 * height * width)


def unet_flops(widths: Sequence[int], height: int, width: int, num_classes: int = 2) -> int:
    """Operations of one forward of the segmentation UNet at [height,
    width], two per multiply-add of each convolution, counted layer by
    layer from its shapes: each level's block (3x3 conv in -> w, 3x3 conv
    w -> w), the bottleneck's, each decoder level's 3x3 upsampling conv
    (w_below -> w) and block (2w -> w, w -> w), and the 1x1 logits conv.
    Normalisation, pooling and activations are left out."""
    widths = tuple(widths)
    macs, hw, cin = 0, height * width, 3
    sizes = []
    for w in widths[:-1]:
        sizes.append(hw)
        macs += hw * 9 * (cin * w + w * w)
        cin, hw = w, hw // 4
    macs += hw * 9 * (cin * widths[-1] + widths[-1] * widths[-1])
    below = widths[-1]
    for w, hw in zip(reversed(widths[:-1]), reversed(sizes)):
        macs += hw * 9 * (below * w)  # upsampling conv
        macs += hw * 9 * (2 * w * w + w * w)  # the block on [conv, skip]
        below = w
    macs += sizes[0] * widths[0] * num_classes
    return 2 * macs
