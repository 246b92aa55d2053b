"""Score the committed segmentation weights through the PyTorch port: the
scoring half of `scripts/gen_semantic.py` (which trained the weights and
wrote SEMANTIC_r05.json), on `--device`.

    python3 scripts/score_torch_semantic.py --device cuda|cpu [--weights seg.msgpack]

Loads `--weights` (a flax checkpoint; by default
`ra_slam_tpu/models/demo_seg.msgpack`, or what
`scripts/train_torch_semantic.py` writes) into a (16, 32, 64)-width
`InferenceEngine`, then
  1. 2D IoU on 16 held-out frames (seed 3, 4 clutter boxes, 320x240
     padded to 256x320): prob(high touch) > 0.5 against the ground-truth
     maps, both classes;
  2. fuses the first 40 of those frames twice at their ground-truth
     poses (2 cm voxels, 12 cm truncation), fed once by the net (ht = p,
     lt = 1 - p) and once by the ground-truth maps, and scores voxel
     high-touch IoU over the surface voxels both maps hold (weight > 1.5,
     |tsdf| < 0.1, prob > 0.5).
Prints one JSON line; with --device cuda also the card's nvidia-smi name
and power limit.
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

from ra_slam_tpu_torch.core.config import TsdfConfig  # noqa: E402
from ra_slam_tpu_torch.core.se3 import SE3  # noqa: E402
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec  # noqa: E402
from ra_slam_tpu_torch.map.voxel_map import create_map, integrate_frame  # noqa: E402
from ra_slam_tpu_torch.models.segmentation import InferenceEngine  # noqa: E402

H, W, PH = 240, 320, 256  # frame height, width, height padded to /32
WEIGHTS = os.path.join(REPO, "ra_slam_tpu", "models", "demo_seg.msgpack")


def frames(n):
    ds = SyntheticBoxDataset(
        num_frames=n, cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5, width=W, height=H),
        radius=1.0, seed=3, clutter=4,
    )
    return ds, [ds.frame(i) for i in range(n)]


def net_prob(engine, fs):
    """[N, H, W] high-touch probability of the frames, padded to PH rows."""
    x = np.zeros((len(fs), PH, W, 3), np.float32)
    for k, f in enumerate(fs):
        x[k, :H] = np.asarray(f.rgb, np.float32) / 255.0
    xt = torch.as_tensor(x, device=engine.device).permute(0, 3, 1, 2)
    return torch.softmax(engine.forward(xt), dim=1)[:, 0, :H]


def score(device, weights: str = WEIGHTS) -> dict:
    engine = InferenceEngine(weights, width=W, height=H, widths=(16, 32, 64), device=device)
    dev = engine.device

    _, test = frames(16)
    probs = net_prob(engine, test).cpu().numpy()
    gt_ht = np.stack([f.ht for f in test]) > 0.5
    pred = probs > 0.5
    iou_ht = (pred & gt_ht).sum() / max((pred | gt_ht).sum(), 1)
    iou_lt = (~pred & ~gt_ht).sum() / max((~pred | ~gt_ht).sum(), 1)
    acc = (pred == gt_ht).mean()

    cfg = TsdfConfig(voxel_size=0.02, truncation=0.12, max_depth=6.0, log2_num_blocks=15,
                     log2_hash_size=17, max_visible_blocks=1 << 12, max_new_blocks=1 << 13,
                     width=W, height=H)
    ds, fuse_frames = frames(40)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def fuse(use_net):
        m = create_map(cfg, dev)
        for f in fuse_frames:
            if use_net:
                ht = net_prob(engine, [f])[0]
                lt = 1.0 - ht
            else:
                ht, lt = t(f.ht), t(f.lt)
            integrate_frame(m, t(f.rgb), t(f.depth), ht, lt, ds.camera,
                            SE3.from_matrix(t(f.cam_T_world)), cfg, alloc_stride=2)
        return m

    t0 = time.perf_counter()
    m_net, m_gt = fuse(True), fuse(False)
    fuse_s = time.perf_counter() - t0

    def surface_ht(m):
        valid = (m.weight > 1.5) & (m.tsdf.abs() < 0.1) & m.active[:, None]
        return valid.cpu().numpy(), (m.prob > 0.5).cpu().numpy()

    (v1, h1), (v2, h2) = surface_ht(m_net), surface_ht(m_gt)
    both = v1 & v2
    p_net, p_gt = h1 & both, h2 & both
    vox_iou = (p_net & p_gt).sum() / max((p_net | p_gt).sum(), 1)
    return {
        "iou_2d_high_touch": round(float(iou_ht), 4),
        "iou_2d_low_touch": round(float(iou_lt), 4),
        "pixel_acc_2d": round(float(acc), 4),
        "voxel_iou_high_touch": round(float(vox_iou), 4),
        "voxel_acc": round(float((h1[both] == h2[both]).mean()), 4),
        "mutual_surface_voxels": int(both.sum()),
        "fuse_s": round(fuse_s, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=WEIGHTS, help="flax msgpack of a (16, 32, 64) net")
    args = p.parse_args(argv)
    out = score(args.device, args.weights)
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
