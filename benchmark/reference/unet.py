"""The segmentation UNet in plain PyTorch, float32, with TF32 off.

The net (widths w0..w3): each block is two (3x3 conv with bias, SAME
padding -> GroupNorm(min(8, C) groups, eps 1e-6) -> relu); the encoder
runs a block then a 2x2 max-pool at each of w0..w2, the bottleneck a
block at w3; the decoder, at each of w2..w0, repeats every pixel 2x2, a
3x3 conv to that width, concatenates [conv, skip] and runs a block; a
1x1 conv gives two logits, whose softmax is (high touch, low touch).
Weights are read by their flax names (`benchmark/harness/weights.py`
makes them; kernels are HWIO).

`segment(weights, rgb)` takes [H, W, 3] uint8 colour (H, W multiples of
32) and returns the (ht, lt) probability maps.

`conv_dtype="fp8"` is the control: each convolution's input and kernel
rounded to float8 e4m3 before a float32 convolution, the precision below
the bfloat16 that the configuration states for the convolutions.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(x: torch.Tensor, conv_dtype: Optional[str]) -> torch.Tensor:
    if conv_dtype == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    return x


def _conv(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor, conv_dtype) -> torch.Tensor:
    k = w[f"{name}/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(_round(x, conv_dtype), _round(k, conv_dtype), padding=k.shape[-1] // 2)
    return y + w[f"{name}/bias"].view(1, -1, 1, 1)


def _norm(w, name: str, x: torch.Tensor) -> torch.Tensor:
    n, c, h, wd = x.shape
    g = min(8, c)
    xg = x.view(n, g, c // g, h, wd)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + EPS)).view(n, c, h, wd)
    return y * w[f"{name}/scale"].view(1, -1, 1, 1) + w[f"{name}/bias"].view(1, -1, 1, 1)


def _block(w, b: int, x: torch.Tensor, conv_dtype) -> torch.Tensor:
    for j in (0, 1):
        x = torch.relu(_norm(w, f"ConvBlock_{b}/GroupNorm_{j}", _conv(w, f"ConvBlock_{b}/Conv_{j}", x, conv_dtype)))
    return x


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor, levels: int = 4, conv_dtype=None) -> torch.Tensor:
    """[N, 2, H, W] logits of [N, 3, H, W] float32 input in [0, 1]."""
    skips = []
    for b in range(levels - 1):
        x = _block(w, b, x, conv_dtype)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = _block(w, levels - 1, x, conv_dtype)
    for k, skip in enumerate(reversed(skips)):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        x = torch.cat([_conv(w, f"Conv_{k}", x, conv_dtype), skip], dim=1)
        x = _block(w, levels + k, x, conv_dtype)
    return _conv(w, f"Conv_{levels - 1}", x, None)


def segment(w: Dict[str, torch.Tensor], rgb: torch.Tensor, levels: int = 4,
            conv_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ht, lt) float32 [H, W] of an [H, W, 3] uint8 frame."""
    h, wd = rgb.shape[:2]
    if h % 32 or wd % 32:
        raise ValueError(f"reference UNet takes sizes that are multiples of 32, got {h}x{wd}")
    x = (rgb.to(torch.float32) / 255.0).permute(2, 0, 1)[None]
    with float32_exact(), torch.no_grad():
        p = torch.softmax(logits(w, x, levels, conv_dtype), dim=1)
    return p[0, 0], p[0, 1]
