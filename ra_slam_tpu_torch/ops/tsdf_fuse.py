"""TSDF fusion of the visible blocks: the CUDA kernel `csrc/tsdf_fuse.cu`
and its plain PyTorch version (counterpart of `ra_slam_tpu/ops/tsdf_pallas.py`).

Per visible block and each of its 512 voxels: read the voxel's pixel
(depth, rgb, ht, lt), then fuse — range-scaled SDF `d2r*(d - z)`; update
gate `gate>0 & d>1e-6 & d<=max_depth & sdf>-truncation`; weighted running
averages of tsdf and rgb with observation weight `(1 - d/max_depth)*4`;
weight clamped at `max_weight`; log-odds fusion of the high-touch
probability — and emit the block's min |tsdf| for space carving.

`tsdf_fuse_` is the entry point on the fusion path. On a CUDA map it
launches the kernel, which updates the pool rows in place; on a CPU map
it runs the plain version, `tsdf_fuse_plain_` (a row gather,
`tsdf_fuse_reference`, a masked scatter). There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ra_slam_tpu_torch.ops._build import load_library

VOXELS = 512

LAUNCHES = 0  # kernel launches made by tsdf_fuse_ (CUDA path only)


def tsdf_fuse_reference(
    img6: torch.Tensor,  # [6, HW] f32: depth | r | g | b | ht | lt
    pix: torch.Tensor,  # [V, 512] i32 flat pixel index
    z: torch.Tensor,  # [V, 512] f32 voxel depth in the camera frame
    d2r: torch.Tensor,  # [V, 512] f32 depth-to-range scale at the pixel
    gate: torch.Tensor,  # [V, 512] f32, 1.0 where the voxel may update
    t_old: torch.Tensor,  # [V, 512] f32
    w_old: torch.Tensor,  # [V, 512] f32
    p_old: torch.Tensor,  # [V, 512] f32
    c_old: torch.Tensor,  # [V, 3, 512] f32 channel-major rgb
    truncation: float,
    max_depth: float,
    max_weight: float,
):
    """The fusion on dense [V, ...] tensors, in float32, in the operation
    order of the TPU kernel. Returns (t, w, p [V,512], c [V,3,512],
    minabs [V])."""
    vals = img6[:, pix.long()]  # [6, V, 512]
    d = vals[0]
    rgb_new = vals[1:4].permute(1, 0, 2)  # [V, 3, 512]
    ht = vals[4]
    lt = vals[5]

    sdf = d2r * (d - z)
    update = (gate > 0) & (d > 1e-6) & (d <= max_depth) & (sdf > -truncation)
    tsdf_obs = torch.clamp(sdf / truncation, max=1.0)
    w_new = (1.0 - d / max_depth) * 4.0

    w_comb = w_old + w_new
    inv_w = 1.0 / torch.clamp(w_comb, min=1e-9)
    t_new = (t_old * w_old + tsdf_obs * w_new) * inv_w
    c_new = (c_old * w_old[:, None, :] + rgb_new * w_new[:, None, :]) * inv_w[:, None, :]
    w_upd = torch.clamp(w_comb, max=max_weight)

    p_c = torch.clamp(p_old, 1e-6, 1.0 - 1e-6)
    lo_old = torch.log(p_c) - torch.log1p(-p_c)
    lo_obs = torch.log(torch.clamp(ht, 1e-6, 1.0)) - torch.log(torch.clamp(lt, 1e-6, 1.0))
    lo_new = (lo_old * w_old + lo_obs * w_new) * inv_w
    p_new = 1.0 / (1.0 + torch.exp(-lo_new))

    t_out = torch.where(update, t_new, t_old)
    w_out = torch.where(update, w_upd, w_old)
    p_out = torch.where(update, p_new, p_old)
    c_out = torch.where(update[:, None, :], c_new, c_old)
    minabs = t_out.abs().amin(dim=-1)
    return t_out, w_out, p_out, c_out, minabs


def _check(m, vis_idx, vis_mask, img6, pix, z, d2r, gate) -> None:
    dev = m.tsdf.device
    V = vis_idx.shape[0]
    N = m.tsdf.shape[0]
    spec = [
        ("tsdf", m.tsdf, torch.float32, (N, VOXELS)),
        ("weight", m.weight, torch.float32, (N, VOXELS)),
        ("prob", m.prob, torch.float32, (N, VOXELS)),
        ("rgb", m.rgb, torch.float32, (N, 3, VOXELS)),
        ("vis_idx", vis_idx, torch.int32, (V,)),
        ("vis_mask", vis_mask, torch.bool, (V,)),
        ("img6", img6, torch.float32, (6, img6.shape[1])),
        ("pix", pix, torch.int32, (V, VOXELS)),
        ("z", z, torch.float32, (V, VOXELS)),
        ("d2r", d2r, torch.float32, (V, VOXELS)),
        ("gate", gate, torch.float32, (V, VOXELS)),
    ]
    for name, t, dtype, shape in spec:
        if t.device != dev:
            raise ValueError(f"tsdf_fuse_: {name} is on {t.device}, the map on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"tsdf_fuse_: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tsdf_fuse_: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"tsdf_fuse_: {name} is not contiguous")
    if V == 0:
        return
    # the kernel dereferences these: reject out-of-range indices up front
    lo_p, hi_p, lo_r, hi_r = torch.stack([*pix.aminmax(), *vis_idx.aminmax()]).tolist()
    if lo_p < 0 or hi_p >= img6.shape[1] or lo_r < 0 or hi_r >= N:
        raise IndexError(
            f"tsdf_fuse_: pix in [{lo_p}, {hi_p}] (image {img6.shape[1]} px), "
            f"vis_idx in [{lo_r}, {hi_r}] (pool {N} rows)"
        )


def _launcher():
    lib = load_library("tsdf_fuse")
    fn = lib.tsdf_fuse_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, p, p, p,  # tsdf weight prob rgb
            p, p,  # vis_idx vis_mask
            p, ctypes.c_int64,  # img6 hw
            p, p, p, p,  # pix z d2r gate
            p, ctypes.c_int,  # minabs num_slots
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def tsdf_fuse_plain_(m, vis_idx, vis_mask, img6, pix, z, d2r, gate, cfg) -> torch.Tensor:
    """The plain PyTorch version of `tsdf_fuse_`, on any device: gather
    the pool rows, `tsdf_fuse_reference`, scatter back the rows of the
    slots with `vis_mask`. Same contract as `tsdf_fuse_`."""
    _check(m, vis_idx, vis_mask, img6, pix, z, d2r, gate)
    rows = vis_idx.long()
    t, w, p, c, minabs = tsdf_fuse_reference(
        img6, pix, z, d2r, gate,
        m.tsdf[rows], m.weight[rows], m.prob[rows], m.rgb[rows],
        cfg.truncation, cfg.max_depth, cfg.max_weight,
    )
    keep = rows[vis_mask]
    m.tsdf[keep] = t[vis_mask]
    m.weight[keep] = w[vis_mask]
    m.prob[keep] = p[vis_mask]
    m.rgb[keep] = c[vis_mask]
    return torch.where(vis_mask, minabs, 0.0)


def tsdf_fuse_(m, vis_idx, vis_mask, img6, pix, z, d2r, gate, cfg) -> torch.Tensor:
    """Fuse one frame into the pool rows `vis_idx[b]` of every slot with
    `vis_mask[b]`, IN PLACE on `m.tsdf/weight/prob/rgb`. Returns minabs
    [V] f32: the min |tsdf| of each fused block after the update, 0 for
    masked slots (which are neither read nor written).

    A map on the CPU runs `tsdf_fuse_plain_`; a map on a CUDA device
    launches the kernel, and any other device raises."""
    global LAUNCHES
    dev = m.tsdf.device
    if dev.type == "cpu":
        return tsdf_fuse_plain_(m, vis_idx, vis_mask, img6, pix, z, d2r, gate, cfg)
    if dev.type != "cuda":
        raise RuntimeError(f"tsdf_fuse_: no kernel for device {dev}")
    _check(m, vis_idx, vis_mask, img6, pix, z, d2r, gate)
    V = vis_idx.shape[0]
    minabs = torch.empty(V, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(
            m.tsdf.data_ptr(), m.weight.data_ptr(), m.prob.data_ptr(), m.rgb.data_ptr(),
            vis_idx.data_ptr(), vis_mask.data_ptr(),
            img6.data_ptr(), img6.shape[1],
            pix.data_ptr(), z.data_ptr(), d2r.data_ptr(), gate.data_ptr(),
            minabs.data_ptr(), V,
            cfg.truncation, cfg.max_depth, cfg.max_weight,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"tsdf_fuse_ kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return minabs
