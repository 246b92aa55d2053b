"""The voxel map of the PyTorch port (ra_slam_tpu_torch/map/voxel_map.py)
against the JAX package's, on the CPU: the direct pixel read against the
mip-tile atlas, the whole fusion path over a synthetic orbit, the dump,
space carving, and state carried from one package to the other. Set-up and bounds in
tests/torch_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.io.dataset import Frame
from ra_slam_tpu.io.synthetic import (
    SyntheticBoxDataset,
    SyntheticCameraSpec,
    look_at,
    render_box_room,
)
from ra_slam_tpu.map import voxel_map as jvm
from ra_slam_tpu_torch.io import synthetic as tsyn
from ra_slam_tpu_torch.map import voxel_map as tvm
from ra_slam_tpu_torch.utils.convert import voxel_map_from_numpy, voxel_map_to_numpy


def _np(jax_map):
    return jax.tree.map(np.asarray, jax_map)


def _views():
    """Two orbit frames and two close-up views whose near blocks span
    tens of pixels (mip levels >= 2): facing the +x wall from 0.35 m, and
    looking down into a corner from about 0.7 m."""
    spec = SyntheticCameraSpec(**tp.CAM_KW)
    ds = SyntheticBoxDataset(num_frames=tp.N_FRAMES, cam=spec, radius=1.0, seed=0)
    frames = [ds.frame(0), ds.frame(5)]
    for eye, target in (((2.65, 0.1, 0.2), (3.0, 0.1, 0.3)), ((2.5, 1.0, 2.5), (3.0, 2.0, 3.0))):
        wTc = look_at(np.array(eye), np.array(target))
        rgb, depth, ht, lt = render_box_room(spec, wTc, ds.half_extents)
        cTw = np.linalg.inv(wTc.astype(np.float64)).astype(np.float32)
        frames.append(Frame(0, 0.0, rgb, depth, cTw, ht, lt))
    return ds.camera, frames


def _block_levels(jm, vis_idx, vis_mask, cam, pose, cfg, H, W):
    """Mip level of each visible block, from the JAX projection: the
    count of 8*2^l - 1 thresholds its pixel footprint exceeds."""
    base = jvm.unpack_block_coords(jm.block_key[vis_idx]) * 8
    world = (base[:, None, :] + jvm.voxel_offsets()[None]).astype(jnp.float32) * cfg.voxel_size
    uv, z = cam.project(pose.apply(world))
    ui, vi = np.round(np.asarray(uv[..., 0])), np.round(np.asarray(uv[..., 1]))
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (np.asarray(z) > 0)
    big = 1 << 20
    span = np.maximum(
        np.where(inb, ui, -big).max(1) - np.where(inb, ui, big).min(1),
        np.where(inb, vi, -big).max(1) - np.where(inb, vi, big).min(1),
    )
    span = np.where(inb.any(1), span, -1)
    return np.sum(span[:, None] > (8 << np.arange(5))[None] - 1, axis=1)[np.asarray(vis_mask)]


def test_direct_read_equals_atlas_read():
    """(a) The port's projection reads, at `pix`, the very samples the
    JAX package resolves out of its mip-tile atlas, and gates the same
    voxels: gate, z and d2r equal, and the six channels bit for bit
    wherever gate == 1."""
    jcfg, tcfg, tcam = tp.jax_cfg(), tp.torch_cfg(), tp.torch_cam()
    H, W = tcfg.height, tcfg.width
    max_level = 0
    jcam, frames = _views()
    with jax.disable_jit():
        for f in frames:
            rgb, depth, ht, lt, pose = tp.jax_frame(f)
            jm = jvm.allocate_from_depth(jvm.create_map(jcfg), depth, jcam, pose, jcfg, 1)
            vis_idx, vis_mask, _ = jvm.visible_blocks(jm, jcam, pose, jcfg)
            patch, idx, z, d2r, gate = jvm._integrate_prep(
                jm, vis_idx, vis_mask, rgb, depth, ht, lt, jcam, pose, jcfg
            )
            # the einsum resolve of integrate's f32 branch
            TP = 16
            V = idx.shape[0]
            patch_im = patch.reshape(V, 6, TP, TP).transpose(0, 2, 3, 1)
            oh_v = jax.nn.one_hot(idx // TP, TP, dtype=jnp.float32)
            oh_u = jax.nn.one_hot(idx % TP, TP, dtype=jnp.float32)
            tmp = jnp.einsum("bvp,bpqc->bvqc", oh_v, patch_im, precision=jax.lax.Precision.HIGHEST)
            vals = np.asarray(jnp.einsum("bvq,bvqc->bvc", oh_u, tmp, precision=jax.lax.Precision.HIGHEST))
            max_level = max(max_level, _block_levels(jm, vis_idx, vis_mask, jcam, pose, jcfg, H, W).max())

            tm = voxel_map_from_numpy(_np(jm), "cpu")
            trgb, tdepth, tht, tlt, tpose = tp.torch_frame(f)
            pix, tz, td2r, tgate = tvm.integrate_prep(
                tm, torch.tensor(np.asarray(vis_idx)), torch.tensor(np.asarray(vis_mask)),
                H, W, tcam, tpose, tcfg,
            )
            np.testing.assert_array_equal(np.asarray(gate), tgate.numpy())
            np.testing.assert_array_equal(np.asarray(z), tz.numpy())
            np.testing.assert_array_equal(np.asarray(d2r), td2r.numpy())
            g = tgate.numpy() > 0
            assert g.sum() > 1000
            img6 = tvm.image_planes(trgb, tdepth, tht, tlt)
            direct = img6[:, pix.long()].permute(1, 2, 0).numpy()  # [V, 512, 6]
            np.testing.assert_array_equal(direct[g], vals[g])
    assert max_level >= 2


@pytest.fixture(scope="module", params=[1, 2], ids=["stride1", "stride2"])
def orbit(request):
    """Both packages fuse the 12-frame orbit at one allocation stride,
    each from its own dataset copy. Keeps per-frame stats, the JAX state
    after 6 and 7 frames, and both final maps."""
    stride = request.param
    jcfg, tcfg, tcam = tp.jax_cfg(), tp.torch_cfg(), tp.torch_cam()
    spec = SyntheticCameraSpec(**tp.CAM_KW)
    jds = SyntheticBoxDataset(num_frames=tp.N_FRAMES, cam=spec, radius=1.0, seed=0)
    tds = tsyn.SyntheticBoxDataset(
        num_frames=tp.N_FRAMES, cam=tsyn.SyntheticCameraSpec(**tp.CAM_KW), radius=1.0, seed=0
    )
    out = {"stride": stride, "jax_stats": [], "port_stats": [], "jax_after": {}}
    jm = jvm.create_map(jcfg)
    tm = tvm.create_map(tcfg, "cpu")
    with jax.disable_jit():
        for i in range(tp.N_FRAMES):
            *imgs, pose = tp.jax_frame(jds.frame(i))
            jm, st = jvm.integrate_frame(jm, *imgs, jds.camera, pose, jcfg, alloc_stride=stride)
            out["jax_stats"].append({k: int(v) for k, v in st.items()})
            if i + 1 in (6, 7):
                out["jax_after"][i + 1] = _np(jm)
            *timgs, tpose = tp.torch_frame(tds.frame(i))
            tm, st = tvm.integrate_frame(tm, *timgs, tcam, tpose, tcfg, alloc_stride=stride)
            out["port_stats"].append({k: int(v) for k, v in st.items()})
    out["jax_map"], out["port_map"] = _np(jm), tm
    out["tds"], out["jcam"] = tds, jds.camera
    return out


def test_integrate_frame_orbit_parity(orbit):
    """(b) Metadata, hash table and free stack exact after every frame's
    counts and at the end; payload within the bounds on all rows."""
    assert orbit["jax_stats"] == orbit["port_stats"]
    assert orbit["port_stats"][-1]["num_active"] > 1000
    assert orbit["port_stats"][-1]["alloc_failures"] == 0
    tp.assert_maps_match(orbit["jax_map"], voxel_map_to_numpy(orbit["port_map"]))


def test_dump_parity(orbit, tmp_path):
    """(c) dump_semantic_tsdf: as many rows, xyz byte-equal, tsdf/prob
    within the bounds."""
    jpath, tpath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jm_dev = jax.tree.map(jnp.asarray, orbit["jax_map"])
    nj = jvm.dump_semantic_tsdf(jm_dev, tp.jax_cfg(), jpath)
    nt = tvm.dump_semantic_tsdf(orbit["port_map"], tp.torch_cfg(), tpath)
    assert nj == nt > 0
    a = np.fromfile(jpath, "<f4").reshape(-1, 5)
    b = np.fromfile(tpath, "<f4").reshape(-1, 5)
    assert a[:, :3].tobytes() == b[:, :3].tobytes()
    assert np.abs(a[:, 3] - b[:, 3]).max() <= tp.TOL["tsdf"]
    assert np.abs(a[:, 4] - b[:, 4]).max() <= tp.TOL["prob"]
    q = tvm.query_tsdf(orbit["port_map"], tp.torch_cfg(), [-1, -1, -1], [1, 1, 1])
    qj = jvm.query_tsdf(jm_dev, tp.jax_cfg(), [-1, -1, -1], [1, 1, 1])
    assert q.shape == qj.shape and q[:, :3].tobytes() == qj[:, :3].tobytes()


def test_space_carve_parity(orbit):
    """space_carve releases the same blocks as the JAX package's: after
    allocating frame 6 on the 6-frame map, its new blocks (tsdf = -1,
    not yet fused) are all empty space to the carve test."""
    jcfg, tcfg = tp.jax_cfg(), tp.torch_cfg()
    f = orbit["tds"].frame(6)
    with jax.disable_jit():
        jm = jax.tree.map(jnp.asarray, orbit["jax_after"][6])
        *_, depth, _, _, pose = tp.jax_frame(f)
        jm = jvm.allocate_from_depth(jm, depth, orbit["jcam"], pose, jcfg, orbit["stride"])
        before = int(jvm.num_active(jm))
        vis_idx, vis_mask, _ = jvm.visible_blocks(jm, orbit["jcam"], pose, jcfg)
        jm = jvm.space_carve(jm, vis_idx, vis_mask, jcfg)
    tm = voxel_map_from_numpy(orbit["jax_after"][6], "cpu")
    *_, tdepth, _, _, tpose = tp.torch_frame(f)
    tvm.allocate_from_depth(tm, tdepth, tp.torch_cam(), tpose, tcfg, orbit["stride"])
    tidx, tmask, _ = tvm.visible_blocks(tm, tp.torch_cam(), tpose, tcfg)
    tvm.space_carve(tm, tidx, tmask, tcfg)
    assert int(tvm.num_active(tm)) == int(jvm.num_active(jm)) < before
    tp.assert_maps_match(_np(jm), voxel_map_to_numpy(tm), tol={})


def test_state_carried_from_jax(orbit):
    """(d) A map fused for 6 frames by JAX, carried into the port with
    voxel_map_from_numpy, takes frame 6 there; it then agrees with the
    JAX map after 7 frames, and converts back unchanged."""
    tm = voxel_map_from_numpy(orbit["jax_after"][6], "cpu")
    *imgs, pose = tp.torch_frame(orbit["tds"].frame(6))
    tm, st = tvm.integrate_frame(
        tm, *imgs, tp.torch_cam(), pose, tp.torch_cfg(), alloc_stride=orbit["stride"]
    )
    assert {k: int(v) for k, v in st.items()} == orbit["jax_stats"][6]
    tp.assert_maps_match(orbit["jax_after"][7], voxel_map_to_numpy(tm))
    back = voxel_map_from_numpy(voxel_map_to_numpy(tm), "cpu")
    tp.assert_maps_match(voxel_map_to_numpy(tm), voxel_map_to_numpy(back), tol={})
