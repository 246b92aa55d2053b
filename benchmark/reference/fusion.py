"""Semantic TSDF fusion in plain PyTorch: the map the program should hold.

The map is a set of 8x8x8-voxel blocks (block edge 8 voxels), each with
per-voxel tsdf (init -1), weight (init 1), high-touch probability (init
0.5) and rgb (init 0). Blocks are found by key in a sorted key array;
their payload lives in rows of a pool. One frame at pose cam_T_world:

1. allocate: every 2nd pixel in each direction with depth in (min_depth,
   max_depth] is unprojected; its ray samples t in linspace(-trunc,
   trunc, S), S = int(2 trunc / (block / 2)) + 2, along the unit ray
   through the pixel give block coordinates floor(world / block). Their
   keys (10 bits an axis, offset 512; out of range is no key) are
   made unique in ascending order; of the first min(2 cap, M) (M the
   number of samples, cap = max_new_blocks) those not in the map are
   new, and the first cap of them are added.
2. cull: a block is visible unless all 8 corners lie behind the camera,
   all beyond max_depth + trunc, or all on one outer side of the image.
3. fuse: each voxel of a visible block (centre at voxel * voxel_size) is
   projected; its pixel is (round(u), round(v)) (half to even), valid
   when inside the image with z > 0. The block's level L is the number
   of l in 0..n-2 with span > 8 * 2^l - 1, where span is the larger
   extent of its valid pixels in u and v and n = bitlen(max(1,
   ceil(max(H, W) / 8) - 1)) + 1. The voxel samples the full-size pixel
   ((v >> L) << L, (u >> L) << L) when (u >> L, v >> L) lies in the 16 x
   16 tile of level L at ((u0 >> 3) << 3, (v0 >> 3) << 3), where (u0, v0)
   is the block's least valid pixel at level L, clamped into the level
   (size ceil(W / 2^L) x ceil(H / 2^L)). With d the depth there, sdf =
   sqrt(x^2 + y^2 + 1) (d - z) for the sampled pixel's normalised (x, y);
   it updates when d in (1e-6, max_depth] and sdf > -trunc:
   w_obs = 4 (1 - d / max_depth), running averages of tsdf (sdf / trunc
   capped at 1) and rgb with weights w and w_obs, weight min(w + w_obs,
   max_weight), and the probability's log-odds averaged the same way
   with the observation's log(ht) - log(lt) (ht, lt clamped to [1e-6,
   1], p to [1e-6, 1 - 1e-6]).
4. carve: a visible block whose least |tsdf| is >= carve_threshold after
   the update is removed.

`dtype=torch.bfloat16` is the control: the payload held and fused in
bfloat16 (the geometry stays float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BLOCK = 8
VOX = 512
INVALID = 0x7FFFFFFF


@dataclass(frozen=True)
class MapSpec:
    voxel_size: float
    truncation: float
    max_depth: float
    min_depth: float
    max_weight: float
    carve_threshold: float
    max_new_blocks: int
    max_visible_blocks: int
    alloc_stride: int
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def pack(c: torch.Tensor) -> torch.Tensor:
    c = c + 512
    ok = ((c >= 0) & (c <= 1023)).all(dim=-1)
    key = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    return torch.where(ok, key, INVALID)


def unpack(k: torch.Tensor) -> torch.Tensor:
    return torch.stack([((k >> 20) & 1023) - 512, ((k >> 10) & 1023) - 512, (k & 1023) - 512], dim=-1)


def _offsets(device) -> torch.Tensor:
    i = torch.arange(VOX, device=device)
    return torch.stack([i % 8, (i // 8) % 8, i // 64], dim=-1)  # x fastest


def _apply(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,...j->...i", R, p) + t


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as an IEEE division (a Python divisor would be a multiply by
    its reciprocal on the card)."""
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)


def _floor_i64(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).clamp(-(2.0**30), 2.0**30).to(torch.int64)


class RefMap:
    def __init__(self, spec: MapSpec, device, dtype=torch.float32, capacity: int = 1 << 14):
        self.s, self.dev, self.dtype = spec, torch.device(device), dtype
        self.keys = torch.empty(0, dtype=torch.int64, device=self.dev)  # sorted
        self.rows = torch.empty(0, dtype=torch.int64, device=self.dev)
        self.cap = 0
        self.tsdf = self.weight = self.prob = self.rgb = None
        self.free = torch.empty(0, dtype=torch.int64, device=self.dev)
        self.overflow = 0  # frames whose allocation or visible window overflowed
        self._grow(capacity)

    def _grow(self, cap: int) -> None:
        kw = dict(device=self.dev, dtype=self.dtype)
        new = (torch.full((cap, VOX), -1.0, **kw), torch.ones((cap, VOX), **kw),
               torch.full((cap, VOX), 0.5, **kw), torch.zeros((cap, 3, VOX), **kw))
        if self.cap:
            for dst, src in zip(new, (self.tsdf, self.weight, self.prob, self.rgb)):
                dst[: self.cap] = src
        self.tsdf, self.weight, self.prob, self.rgb = new
        self.free = torch.cat([self.free, torch.arange(cap - 1, self.cap - 1, -1, device=self.dev)])
        self.cap = cap

    # -- 1. allocation
    def candidate_keys(self, depth: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        s = self.s
        st = s.alloc_stride
        block = BLOCK * s.voxel_size
        n_steps = int(2 * s.truncation / (0.5 * block)) + 2
        d = depth[::st, ::st]
        h, w = d.shape
        u = (torch.arange(w, device=self.dev, dtype=torch.float32) * st)[None, :].expand(h, w)
        v = (torch.arange(h, device=self.dev, dtype=torch.float32) * st)[:, None].expand(h, w)
        valid = (d > s.min_depth) & (d <= s.max_depth)
        dd = torch.where(valid, d, torch.ones_like(d))
        p = torch.stack([(u - s.cx) / s.fx * dd, (v - s.cy) / s.fy * dd, dd], dim=-1)
        ray = torch.sqrt((p * p).sum(-1, keepdim=True).double()).float()
        udir = p / ray.clamp(min=1e-9)
        steps = torch.arange(n_steps, device=self.dev, dtype=torch.float32) / (n_steps - 1)
        ts = -s.truncation * (1 - steps) + s.truncation * steps
        ts[-1] = s.truncation
        pc = p[..., None, :] + udir[..., None, :] * ts[:, None]
        Rt = R.T
        pw = _apply(Rt, -(Rt.double() @ t.double()).float(), pc)
        keys = pack(_floor_i64(pw / block))
        return torch.where(valid[..., None], keys, INVALID).reshape(-1)

    def allocate(self, cand: torch.Tensor) -> None:
        s = self.s
        M = cand.numel()
        take = min(s.max_new_blocks, M)
        uniq = torch.unique(cand[cand != INVALID])  # ascending
        if uniq.numel() > min(2 * take, M):
            self.overflow += 1
            uniq = uniq[: min(2 * take, M)]
        new = uniq[~torch.isin(uniq, self.keys)]
        if new.numel() > take:
            self.overflow += 1
            new = new[:take]
        n = new.numel()
        if n == 0:
            return
        if n > self.free.numel():
            self._grow(max(2 * self.cap, self.cap + n))
        rows = self.free[-n:].flip(0)
        self.free = self.free[:-n]
        keys = torch.cat([self.keys, new])
        order = torch.argsort(keys)
        self.keys, self.rows = keys[order], torch.cat([self.rows, rows])[order]

    # -- 2. culling
    def visible(self, R, t) -> torch.Tensor:
        """Indices into self.keys of the visible blocks."""
        s = self.s
        block = BLOCK * s.voxel_size
        base = unpack(self.keys).to(torch.float32) * block
        corners = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                               dtype=torch.float32, device=self.dev) * block
        c = _apply(R, t, base[:, None, :] + corners)
        z = c[..., 2]
        iz = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        u = c[..., 0] * iz * s.fx + s.cx
        v = c[..., 1] * iz * s.fy + s.cy
        out = ((z <= 0).all(1) | (z > s.max_depth + s.truncation).all(1) | (u < 0).all(1)
               | (u > s.width - 1).all(1) | (v < 0).all(1) | (v > s.height - 1).all(1))
        idx = torch.nonzero(~out).squeeze(1)
        if idx.numel() > s.max_visible_blocks:
            self.overflow += 1
        return idx

    # -- 3. the voxel's pixel and the update
    def sample_pixels(self, keys: torch.Tensor, R, t):
        """(pixel flat index, camera z, depth-to-range scale, gate) [V, 512]."""
        s = self.s
        H, W = s.height, s.width
        vox = unpack(keys)[:, None, :] * BLOCK + _offsets(self.dev)[None]
        pc = _apply(R, t, vox.to(torch.float32) * s.voxel_size)
        z = pc[..., 2]
        iz = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        ui = torch.round(pc[..., 0] * iz * s.fx + s.cx).clamp(-(2.0**30), 2.0**30).to(torch.int64)
        vi = torch.round(pc[..., 1] * iz * s.fy + s.cy).clamp(-(2.0**30), 2.0**30).to(torch.int64)
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
        uc, vc = ui.clamp(0, W - 1), vi.clamp(0, H - 1)
        big = 1 << 20
        anyv = inb.any(1)
        umin = torch.where(anyv, torch.where(inb, ui, big).amin(1).clamp(min=0), 0)
        vmin = torch.where(anyv, torch.where(inb, vi, big).amin(1).clamp(min=0), 0)
        umax = torch.where(inb, ui, -big).amax(1)
        vmax = torch.where(inb, vi, -big).amax(1)
        span = torch.maximum(umax - umin, vmax - vmin)
        n_levels = max(1, (max(H, W) + 7) // 8 - 1).bit_length() + 1
        lvl = sum((span > 8 * (1 << l) - 1).to(torch.int64) for l in range(n_levels - 1))
        lw = torch.tensor([-(-W // (1 << l)) for l in range(n_levels)], device=self.dev)[lvl]
        lh = torch.tensor([-(-H // (1 << l)) for l in range(n_levels)], device=self.dev)[lvl]
        u0 = torch.minimum((umin >> lvl).clamp(min=0), (lw - 1).clamp(min=0))
        v0 = torch.minimum((vmin >> lvl).clamp(min=0), (lh - 1).clamp(min=0))
        L = lvl[:, None]
        ul, vl = uc >> L, vc >> L
        du = ul - ((u0 >> 3) << 3)[:, None]
        dv = vl - ((v0 >> 3) << 3)[:, None]
        gate = inb & (du >= 0) & (du < 16) & (dv >= 0) & (dv < 16)
        us, vs = ul << L, vl << L
        xn = (us.to(torch.float32) - s.cx) / s.fx
        yn = (vs.to(torch.float32) - s.cy) / s.fy
        d2r = torch.sqrt((xn * xn + yn * yn + 1.0).double()).float()
        return vs * W + us, z, d2r, gate

    def integrate(self, depth, rgb, ht, lt, cam_T_world) -> tuple:
        """Fuse one frame: depth [H, W] metres, rgb [H, W, 3] (0..255),
        ht / lt [H, W], cam_T_world [4, 4]; all float32 on the device.
        Returns (visible blocks, updated voxels): the fusion's work."""
        s = self.s
        R, t = cam_T_world[:3, :3].contiguous(), cam_T_world[:3, 3].contiguous()
        self.allocate(self.candidate_keys(depth, R, t))
        vis = self.visible(R, t)
        if vis.numel() == 0:
            return 0, 0
        keys, rows = self.keys[vis], self.rows[vis]
        pix, z, d2r, gate = self.sample_pixels(keys, R, t)
        dt = self.dtype
        img = torch.stack([depth, rgb[..., 0], rgb[..., 1], rgb[..., 2], ht, lt]).reshape(6, -1)
        vals = img[:, pix]  # [6, V, 512], float32
        d = vals[0]
        sdf = d2r * (d - z)  # geometry in float32
        upd = gate & (d > 1e-6) & (d <= s.max_depth) & (sdf > -s.truncation)
        d, sdf = d.to(dt), sdf.to(dt)
        col, ht_, lt_ = vals[1:4].permute(1, 0, 2).to(dt), vals[4].to(dt), vals[5].to(dt)
        t_old, w_old, p_old, c_old = self.tsdf[rows], self.weight[rows], self.prob[rows], self.rgb[rows]
        obs = torch.clamp(_div(sdf, s.truncation), max=1.0)
        w_new = (1.0 - _div(d, s.max_depth)) * 4.0
        w_sum = w_old + w_new
        inv = 1.0 / torch.clamp(w_sum, min=1e-9)
        t_new = (t_old * w_old + obs * w_new) * inv
        c_new = (c_old * w_old[:, None] + col * w_new[:, None]) * inv[:, None]
        pc = torch.clamp(p_old, 1e-6, 1.0 - 1e-6)
        lo_old = torch.log(pc) - torch.log1p(-pc)
        lo_obs = torch.log(torch.clamp(ht_, 1e-6, 1.0)) - torch.log(torch.clamp(lt_, 1e-6, 1.0))
        p_new = 1.0 / (1.0 + torch.exp(-((lo_old * w_old + lo_obs * w_new) * inv)))
        t_out = torch.where(upd, t_new, t_old)
        self.tsdf[rows] = t_out
        self.weight[rows] = torch.where(upd, torch.clamp(w_sum, max=s.max_weight), w_old)
        self.prob[rows] = torch.where(upd, p_new, p_old)
        self.rgb[rows] = torch.where(upd[:, None], c_new, c_old)
        # -- 4. carving
        gone = t_out.abs().amin(1) >= s.carve_threshold
        if bool(gone.any()):
            r = rows[gone]
            self.tsdf[r], self.weight[r], self.prob[r], self.rgb[r] = -1.0, 1.0, 0.5, 0.0
            self.free = torch.cat([self.free, r.flip(0)])
            keep = torch.ones(self.keys.numel(), dtype=torch.bool, device=self.dev)
            keep[vis[gone]] = False
            self.keys, self.rows = self.keys[keep], self.rows[keep]
        return int(vis.numel()), int(upd.sum())

    def blocks(self):
        """(sorted keys [K], tsdf, weight, prob [K, 512], rgb [K, 3, 512]) float32."""
        r = self.rows
        return (self.keys, self.tsdf[r].float(), self.weight[r].float(), self.prob[r].float(),
                self.rgb[r].float())
