"""Train the segmentation UNet through the PyTorch port: the training half
of `scripts/gen_semantic.py` (which trained `ra_slam_tpu/models/
demo_seg.msgpack` and wrote SEMANTIC_r05.json), on `--device`.

    python3 scripts/train_torch_semantic.py --out seg.msgpack --device cuda|cpu \\
        [--init tests/data/seg_init_16_32_64.msgpack] [--steps 300]

The (16, 32, 64)-width net starts from `--init`, a flax msgpack (by
default the JAX package's own initial parameters, which torch cannot
draw: `tests/data/make_seg_init.py`), and takes `--steps` Adam steps
(lr 3e-4) of batch 4 over 48 frames of the synthetic room (seed 0, 4
clutter boxes, 320x240 padded to 256x320, the pad rows labelled -1),
the batches in the order of `np.random.default_rng(0).integers(0, 48,
(300, 4))`: class 0 where the ground-truth high-touch map is > 0.5, else
1. It writes the trained parameters to `--out` as a flax msgpack (that
`InferenceEngine(widths=(16, 32, 64))` of either package loads) and
prints one JSON line: the first and last loss, steps/s, wall time and,
on a card, peak device memory and the card's nvidia-smi name and power
limit. `scripts/score_torch_semantic.py --weights` scores the result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec  # noqa: E402
from ra_slam_tpu_torch.models.segmentation import SegmentationNet, make_train_step  # noqa: E402
from ra_slam_tpu_torch.pipeline.system import resolve_device  # noqa: E402
from ra_slam_tpu_torch.utils.convert import seg_state_dict_from_flax, seg_state_dict_to_flax  # noqa: E402
from ra_slam_tpu_torch.utils.flax_msgpack import packb, unpackb  # noqa: E402

H, W, PH = 240, 320, 256  # frame height, width, height padded to /32
WIDTHS = (16, 32, 64)
INIT = os.path.join(REPO, "tests", "data", "seg_init_16_32_64.msgpack")
TRAIN_FRAMES, BATCH, LR = 48, 4, 3e-4


def frames(seed: int, n: int):
    ds = SyntheticBoxDataset(
        num_frames=n, cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5, width=W, height=H),
        radius=1.0, seed=seed, clutter=4,
    )
    return [ds.frame(i) for i in range(n)]


def batch_arrays(fs):
    """(x [N, 3, PH, W] float32 in [0, 1], y [N, PH, W] int64): class 0
    (high touch) where ht > 0.5, else 1; the pad rows -1."""
    x = np.zeros((len(fs), 3, PH, W), np.float32)
    y = np.full((len(fs), PH, W), -1, np.int64)
    for k, f in enumerate(fs):
        x[k, :, :H] = np.asarray(f.rgb, np.float32).transpose(2, 0, 1) / 255.0
        y[k, :H] = np.where(np.asarray(f.ht) > 0.5, 0, 1)
    return x, y


def load_net(path: str, dtype=torch.bfloat16) -> SegmentationNet:
    """A (16, 32, 64) net with the parameters of a flax msgpack, on the CPU."""
    net = SegmentationNet(WIDTHS, dtype=dtype)
    with open(path, "rb") as f:
        net.load_state_dict(seg_state_dict_from_flax(unpackb(f.read()), net))
    return net


def save_net(net: SegmentationNet, path: str) -> None:
    with open(path, "wb") as f:
        f.write(packb(seg_state_dict_to_flax(net.state_dict(), net)))


def train(init: str, device, steps: int = 300):
    """(net, losses, wall seconds): `steps` Adam steps from `init`."""
    dev = resolve_device(device)
    net = load_net(init).to(dev)
    step = make_train_step(net, torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8))
    x, y = batch_arrays(frames(seed=0, n=TRAIN_FRAMES))
    xs, ys = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    order = torch.as_tensor(np.random.default_rng(0).integers(0, TRAIN_FRAMES, (steps, BATCH)), device=dev)
    losses = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for s in range(steps):
        losses.append(step(xs[order[s]], ys[order[s]]))
    losses = torch.stack(losses).cpu().tolist()  # waits for the last step
    return net, losses, time.perf_counter() - t0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="trained parameters, a flax msgpack")
    p.add_argument("--init", default=INIT, help="initial parameters, a flax msgpack")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    net, losses, wall = train(args.init, dev, args.steps)
    save_net(net, args.out)
    out = {
        "train_steps": args.steps,
        "train_loss_first_last": [losses[0], losses[-1]],
        "steps_per_s": args.steps / wall,
        "train_wall_s": wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "weights": args.out,
    }
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
