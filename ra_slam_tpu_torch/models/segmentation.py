"""Semantic segmentation: high-touch / low-touch probability maps
(counterpart of `ra_slam_tpu/models/segmentation.py`).

A small UNet as `torch.nn.Module`s, NCHW, computing the flax net's
function rather than torch's defaults:

- each `Conv` is 3x3 SAME (1x1 for the logits) with a bias; its input
  and kernel are cast to `dtype` (bf16 by default; the params stay
  float32), the bias added in `dtype` after the convolution;
- `GroupNorm` uses min(8, f) groups and eps 1e-6; its statistics are
  float32 with the fast variance E[x^2] - E[x]^2 (flax's
  `force_float32_reductions` and `use_fast_variance`), the output
  `(x - mean) * (rsqrt(var + eps) * scale) + bias` in float32, then cast
  to `dtype`;
- 2x2 max-pool; nearest x2 upsample (a repeat), conv, then concat with
  the skip; the 1x1 logits conv in float32.

The convolutions, pooling and softmax are `torch.nn.functional` calls
(cuDNN on the card), as the JAX package computes them with `lax.conv`
outside any Pallas kernel. cuDNN would run the float32 convolutions in
TF32 (`torch.backends.cudnn.allow_tf32` is True by default), so the
engine's forward turns that off for its own call and restores it.

`InferenceEngine` keeps the JAX engine's four modes: no model is the
fake mode (all-ones maps); a path loads a flax msgpack checkpoint
(`utils/flax_msgpack.py`, `utils/convert.py`), raising as flax does when
the widths do not match; `"__random__"` initialises with flax's
initialisers from a generator seeded 0; `save` writes a checkpoint flax
reads. `infer_one` pads the frame to a multiple of 32, runs softmax,
crops, and resizes back to the engine's size with cv2's INTER_LINEAR
(`ops/resize.py`).

`make_train_step(net, optimizer)` is the JAX package's optax step with
`torch.autograd` for `jax.value_and_grad`: the masked cross-entropy of
the 2-class logits (labels -1 left out), the forward in the net's dtype
with float32 parameters, and `optimizer` (`torch.optim.Adam(lr,
betas=(0.9, 0.999), eps=1e-8)` is `optax.adam(lr)`) updating them in
place. `scripts/train_torch_semantic.py` drives it.

    python -m ra_slam_tpu_torch.models.segmentation --iters 1000 --device cuda
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ra_slam_tpu_torch.ops.resize import resize_linear
from ra_slam_tpu_torch.utils.profiling import TRACE

DEFAULT_WIDTHS = (32, 64, 128, 256)
GN_EPS = 1e-6  # flax's GroupNorm epsilon (torch's default is 1e-5)


class Conv(nn.Module):
    """flax `nn.Conv(features, (k, k))`: SAME padding, float32 params,
    input and kernel cast to `dtype`, bias added after in `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), padding=k // 2)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=min(8, f))` with float32 reductions
    and the fast variance, eps 1e-6, output cast to `dtype`."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.groups = min(8, channels)
        self.weight = nn.Parameter(torch.ones(channels))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xf = x.float()
        g = xf.view(n, self.groups, c // self.groups, h, w)
        mean = g.mean(dim=(2, 3, 4))
        mean2 = (g * g).mean(dim=(2, 3, 4))
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        per_c = lambda s: s.repeat_interleave(c // self.groups, dim=1).view(n, c, 1, 1)
        mul = torch.rsqrt(per_c(var) + GN_EPS) * self.weight.view(1, c, 1, 1)
        y = (xf - per_c(mean)) * mul + self.bias.view(1, c, 1, 1)
        return y.to(self.dtype)


class ConvBlock(nn.Module):
    """Two (conv 3x3 -> GroupNorm -> relu)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin, features, 3, dtype), Conv(features, features, 3, dtype)])
        self.norms = nn.ModuleList([GroupNorm(features, dtype), GroupNorm(features, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x)))
        return x


class SegmentationNet(nn.Module):
    """Small UNet: encoder/decoder with skip connections, 2-channel
    (high-touch, low-touch) logits at input resolution."""

    def __init__(self, widths: Sequence[int] = DEFAULT_WIDTHS, num_classes: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.widths, self.dtype = tuple(widths), dtype
        ins = (3,) + self.widths[:-2]
        self.down = nn.ModuleList([ConvBlock(cin, w, dtype) for cin, w in zip(ins, self.widths[:-1])])
        self.bottom = ConvBlock(self.widths[-2] if len(self.widths) > 1 else 3, self.widths[-1], dtype)
        dec = list(reversed(self.widths[:-1]))
        prev = [self.widths[-1]] + dec[:-1]
        self.up = nn.ModuleList([Conv(p, w, 3, dtype) for p, w in zip(prev, dec)])
        self.up_blocks = nn.ModuleList([ConvBlock(2 * w, w, dtype) for w in dec])
        self.head = Conv(self.widths[0], num_classes, 1, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, 3, H, W] float in [0, 1]
        x = x.to(self.dtype)
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottom(x)
        for conv, block, skip in zip(self.up, self.up_blocks, reversed(skips)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = torch.cat([conv(x), skip], dim=1)
            x = block(x)
        return self.head(x)  # [N, 2, H, W] float32


def forward_flops(widths: Sequence[int], height: int, width: int, num_classes: int = 2) -> int:
    """Floating-point operations of one forward at [height, width] (two
    per multiply-add of the convolutions; normalisation, pooling and
    activations left out)."""
    macs, hw, cin = 0, height * width, 3
    for w in widths[:-1]:
        macs += hw * 9 * (cin * w + w * w)
        cin, hw = w, hw // 4
    macs += hw * 9 * (cin * widths[-1] + widths[-1] ** 2)
    prev = widths[-1]
    for w in reversed(widths[:-1]):
        hw *= 4
        macs += hw * 9 * (prev * w + 2 * w * w + w * w)
        prev = w
    return 2 * (macs + hw * widths[0] * num_classes)


def init_params_(net: SegmentationNet, generator: torch.Generator) -> None:
    """flax's initialisers: lecun_normal kernels (truncated normal in
    [-2, 2] scaled to variance 1 / fan_in), zero biases, GroupNorm scale
    1 and bias 0."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv):
                cout, cin, k, _ = m.weight.shape
                std = math.sqrt(1.0 / (cin * k * k)) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's TF32 off inside the block (it is on by default, and would
    run the float32 convolutions in TF32), the caller's flag restored."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _pad_to_multiple(h: int, w: int, m: int = 32) -> Tuple[int, int]:
    return ((h + m - 1) // m) * m, ((w + m - 1) // m) * m


class InferenceEngine:
    """Per-frame ht/lt inference. `model_path=None` is the fake mode
    (all-ones maps); a path loads a flax msgpack checkpoint;
    `"__random__"` initialises the net from a generator seeded 0."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        width: int = 640,
        height: int = 480,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        device="cuda",
    ):
        from ra_slam_tpu_torch.pipeline.system import resolve_device

        self.fake = model_path is None
        self.width, self.height = width, height
        self.device = resolve_device(device)
        if self.fake:
            return
        self.net = SegmentationNet(widths)
        if model_path == "__random__":
            init_params_(self.net, torch.Generator().manual_seed(0))
        else:
            from ra_slam_tpu_torch.utils.convert import seg_state_dict_from_flax
            from ra_slam_tpu_torch.utils.flax_msgpack import unpackb

            with open(model_path, "rb") as f:
                tree = unpackb(f.read())
            self.net.load_state_dict(seg_state_dict_from_flax(tree, self.net))
        self.net.to(self.device).eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits [N, 2, H, W] of [N, 3, H, W] inputs in [0, 1], with
        cuDNN's TF32 off for the call."""
        with _no_tf32(), torch.no_grad():
            return self.net(x)

    def segment(self, rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ht, lt) float32 maps on the engine's device at its size, of
        an [H, W, 3] uint8 or float RGB tensor."""
        with TRACE.span("seg.segment"):
            if self.fake:
                ones = torch.ones((self.height, self.width), dtype=torch.float32, device=self.device)
                return ones, ones.clone()
            rgb = rgb.to(self.device)
            h, w = rgb.shape[:2]
            ph, pw = _pad_to_multiple(h, w)
            x = rgb.to(torch.float32) / 255.0
            x = F.pad(x.permute(2, 0, 1), (0, pw - w, 0, ph - h))[None]
            prob = torch.softmax(self.forward(x), dim=1)
            ht, lt = prob[0, 0, :h, :w], prob[0, 1, :h, :w]
            if (h, w) != (self.height, self.width):
                ht = resize_linear(ht.contiguous(), self.width, self.height)
                lt = resize_linear(lt.contiguous(), self.width, self.height)
            return ht, lt

    def infer_one(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[H, W, 3] uint8/float RGB -> (ht, lt) float32 numpy maps at
        the engine's size."""
        ht, lt = self.segment(torch.as_tensor(np.asarray(rgb)))
        return ht.cpu().numpy(), lt.cpu().numpy()

    def save(self, path: str) -> None:
        """Write the params as a flax msgpack checkpoint."""
        if self.fake:
            raise ValueError("fake engine has no parameters")
        from ra_slam_tpu_torch.utils.convert import seg_state_dict_to_flax
        from ra_slam_tpu_torch.utils.flax_msgpack import packb

        with open(path, "wb") as f:
            f.write(packb(seg_state_dict_to_flax(self.net.state_dict(), self.net)))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of `logits` [N, C, H, W] against integer
    `labels` [N, H, W] over the pixels whose label is >= 0:
    sum(ce * mask) / max(sum(mask), 1)."""
    mask = (labels >= 0).to(torch.float32)
    ce = F.cross_entropy(logits.float(), labels.clamp(min=0), reduction="none")
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(net: SegmentationNet, optimizer: torch.optim.Optimizer):
    """`step(x, y) -> loss`: one optimizer step on `net`'s parameters, in
    place. `x` is [N, 3, H, W] float in [0, 1], `y` [N, H, W] int64 in {0
    (high touch), 1 (low touch)} with -1 unlabelled. cuDNN's TF32 is off
    for the step, as in `InferenceEngine.forward`, so a float32 net
    computes in float32 on the card too."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            optimizer.zero_grad(set_to_none=True)
            loss = masked_cross_entropy(net(x), y)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def _bench(argv=None) -> dict:
    """Segmentation inference latency: `infer_one` on a random frame,
    host round trip included, one JSON line."""
    import argparse
    import json
    import time

    p = argparse.ArgumentParser(description="segmentation latency bench")
    p.add_argument("--model", default=None, help="checkpoint (None = random init)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    eng = InferenceEngine(args.model or "__random__", width=args.width, height=args.height,
                          device=args.device)
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (args.height, args.width, 3), dtype=np.uint8)
    eng.infer_one(rgb)  # warm-up
    t0 = time.perf_counter()
    for _ in range(args.iters):
        eng.infer_one(rgb)  # returns numpy: each call waits for the device
    dt = (time.perf_counter() - t0) / args.iters
    out = {
        "metric": "segmentation_latency_ms",
        "value": round(dt * 1e3, 3),
        "fps": round(1.0 / dt, 1),
        "iters": args.iters,
        "shape": [args.height, args.width],
        "backend": torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda" else "cpu",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    _bench()
