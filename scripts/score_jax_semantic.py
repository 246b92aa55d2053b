"""Score the committed segmentation weights through the JAX package: the
scoring half of `scripts/gen_semantic.py`, unchanged but for loading
`ra_slam_tpu/models/demo_seg.msgpack` instead of training, so that its
numbers sit beside `scripts/score_torch_semantic.py`'s.

    JAX_PLATFORMS=cpu python3 scripts/score_jax_semantic.py

2D IoU on 16 held-out frames (seed 3, 320x240 padded to 256x320), then
voxel high-touch IoU of a net-fed against a ground-truth-fed map fused
over 40 frames (2 cm voxels). Prints one JSON line with the backend.
"""

import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

H, W, PH = 240, 320, 256


def _frames(seed, n, clutter=4):
    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    ds = SyntheticBoxDataset(
        num_frames=n, cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5, width=W, height=H),
        radius=1.0, seed=seed, clutter=clutter,
    )
    return ds, [ds.frame(i) for i in range(n)]


def main() -> dict:
    from flax import serialization

    from ra_slam_tpu.core.config import TsdfConfig
    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.map.voxel_map import create_map, integrate_frame
    from ra_slam_tpu.models.segmentation import SegmentationNet

    net = SegmentationNet(widths=(16, 32, 64))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, PH, W, 3), jnp.float32))
    with open(os.path.join(REPO, "ra_slam_tpu", "models", "demo_seg.msgpack"), "rb") as f:
        params = serialization.from_bytes(params, f.read())

    @jax.jit
    def infer(params, x):
        return jax.nn.softmax(net.apply(params, x), axis=-1)[..., 0]

    def xt(fs):
        x = np.zeros((len(fs), PH, W, 3), np.float32)
        for k, f in enumerate(fs):
            x[k, :H] = np.asarray(f.rgb, np.float32) / 255.0
        return jnp.asarray(x)

    _, test = _frames(seed=3, n=16)
    probs = np.asarray(infer(params, xt(test)))[:, :H]
    gt_ht = np.stack([f.ht for f in test]) > 0.5
    pred = probs > 0.5
    iou_ht = (pred & gt_ht).sum() / max((pred | gt_ht).sum(), 1)
    iou_lt = (~pred & ~gt_ht).sum() / max((~pred | ~gt_ht).sum(), 1)
    acc = (pred == gt_ht).mean()

    cfg = TsdfConfig(voxel_size=0.02, truncation=0.12, max_depth=6.0, log2_num_blocks=15,
                     log2_hash_size=17, max_visible_blocks=1 << 12, max_new_blocks=1 << 13,
                     width=W, height=H)
    ds, fuse_frames = _frames(seed=3, n=40)
    cam = ds.camera
    istep = jax.jit(functools.partial(integrate_frame, cfg=cfg, alloc_stride=2), donate_argnums=(0,))

    def fuse(use_net):
        m = create_map(cfg)
        for f in fuse_frames:
            if use_net:
                ht = infer(params, xt([f]))[0, :H]
                lt = 1.0 - ht
            else:
                ht, lt = jnp.asarray(f.ht), jnp.asarray(f.lt)
            m, _ = istep(m, jnp.asarray(f.rgb, jnp.float32), jnp.asarray(f.depth), ht, lt, cam,
                         SE3.from_matrix(jnp.asarray(f.cam_T_world)))
        return m

    t0 = time.perf_counter()
    m_net, m_gt = fuse(True), fuse(False)
    fuse_s = time.perf_counter() - t0

    def surface_ht(m):
        valid = (np.asarray(m.weight) > 1.5) & (np.abs(np.asarray(m.tsdf)) < 0.1) & np.asarray(m.active)[:, None]
        return valid, np.asarray(m.prob) > 0.5

    (v1, h1), (v2, h2) = surface_ht(m_net), surface_ht(m_gt)
    both = v1 & v2
    p_net, p_gt = h1 & both, h2 & both
    out = {
        "iou_2d_high_touch": round(float(iou_ht), 4),
        "iou_2d_low_touch": round(float(iou_lt), 4),
        "pixel_acc_2d": round(float(acc), 4),
        "voxel_iou_high_touch": round(float((p_net & p_gt).sum() / max((p_net | p_gt).sum(), 1)), 4),
        "voxel_acc": round(float((h1[both] == h2[both]).mean()), 4),
        "mutual_surface_voxels": int(both.sum()),
        "fuse_s": round(fuse_s, 2),
        "backend": jax.default_backend(),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
