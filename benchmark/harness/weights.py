"""The segmentation UNet's weights, made on the device from the seed, and
written as the flax msgpack checkpoint that the program loads.

The net is the one the program segments with: a UNet of
widths (32, 64, 128, 256), each block two (3x3 conv, GroupNorm, relu),
2x2 max-pool down, nearest x2 upsample and a 3x3 conv up, concatenated
with the skip, a 1x1 conv to 2 logits. `layout(widths)` lists its layers
by their flax names; the reference (`benchmark/reference/unet.py`) reads
the same tensors by the same names.

Weights come from one `torch.Generator` on the device, in one draw:
kernels N(0, 1 / fan_in) (lecun normal), conv biases N(0, 0.02^2),
GroupNorm scales 1 + N(0, 0.1^2) and biases N(0, 0.05^2), all float32,
the type the checkpoint holds.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# (flax path, kind, shape): kind is "conv" (kernel HWIO, bias) or "norm"
Layer = Tuple[Tuple[str, ...], str, Tuple[int, ...]]


def layout(widths: Sequence[int], num_classes: int = 2) -> List[Layer]:
    """Every conv and GroupNorm of the UNet, in the flax module names:
    encoder blocks, bottleneck, decoder blocks are `ConvBlock_i` in that
    order; the decoder's upsampling convs `Conv_k`; the logits conv the
    last `Conv_k`."""
    widths = tuple(widths)
    ins = (3,) + widths[:-2]
    blocks = list(zip(ins, widths[:-1])) + [(widths[-2], widths[-1])]
    dec = list(reversed(widths[:-1]))
    blocks += [(2 * w, w) for w in dec]
    out: List[Layer] = []
    for b, (cin, w) in enumerate(blocks):
        out.append(((f"ConvBlock_{b}", "Conv_0"), "conv", (3, 3, cin, w)))
        out.append(((f"ConvBlock_{b}", "GroupNorm_0"), "norm", (w,)))
        out.append(((f"ConvBlock_{b}", "Conv_1"), "conv", (3, 3, w, w)))
        out.append(((f"ConvBlock_{b}", "GroupNorm_1"), "norm", (w,)))
    prev = [widths[-1]] + dec[:-1]
    for k, (p, w) in enumerate(zip(prev, dec)):
        out.append(((f"Conv_{k}",), "conv", (3, 3, p, w)))
    out.append(((f"Conv_{len(dec)}",), "conv", (1, 1, widths[0], num_classes)))
    return out


def make_weights(widths: Sequence[int], seed: int, device) -> Dict[str, torch.Tensor]:
    """{"<path>/kernel"|"bias"|"scale": float32 tensor} on `device`, from
    one normal draw of a generator seeded with `seed`."""
    lay = layout(widths)
    sizes = []
    for _, kind, shape in lay:
        n = int(np.prod(shape))
        sizes += [n, shape[-1]] if kind == "conv" else [shape[0], shape[0]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    draw = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    parts = iter(torch.split(draw, sizes))
    out: Dict[str, torch.Tensor] = {}
    for path, kind, shape in lay:
        name = "/".join(path)
        if kind == "conv":
            fan_in = shape[0] * shape[1] * shape[2]
            out[f"{name}/kernel"] = next(parts).view(shape) * (1.0 / fan_in) ** 0.5
            out[f"{name}/bias"] = next(parts) * 0.02
        else:
            out[f"{name}/scale"] = 1.0 + 0.1 * next(parts)
            out[f"{name}/bias"] = 0.05 * next(parts)
    return out


# --- flax's msgpack checkpoint: nested str-keyed maps, ndarray leaves as ext
# type 1 whose payload is msgpack (shape, dtype name, raw C-order bytes)


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, width in codes:
        if n < (1 << (8 * width)):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"length {n} too large for msgpack")


def _pack(x, out: list) -> None:
    if isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + raw)
    elif isinstance(x, int):
        if not 0 <= x < (1 << 32):
            raise ValueError(f"int {x} out of the packer's range")
        out.append(bytes([x]) if x <= 0x7F else b"\xce" + struct.pack(">I", x))
    elif isinstance(x, bytes):
        out.append(_len_header(len(x), None, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4))) + x)
    elif isinstance(x, dict):
        out.append(_len_header(len(x), 0x80, 15, ((0xDE, 2), (0xDF, 4))))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_len_header(len(x), 0x90, 15, ((0xDC, 2), (0xDD, 4))))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        payload = packb((list(a.shape), a.dtype.name, a.tobytes("C")))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = bytes([fixext[n]]) if n in fixext else _len_header(n, None, -1, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
        out.append(head + struct.pack(">b", 1) + payload)
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def packb(tree) -> bytes:
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def checkpoint_bytes(weights: Dict[str, torch.Tensor]) -> bytes:
    """The flax params checkpoint of `weights`."""
    params: dict = {}
    for name, t in weights.items():
        *path, leaf = name.split("/")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy().astype(np.float32)
    return packb({"params": params})
