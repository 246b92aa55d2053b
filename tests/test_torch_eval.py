"""The evaluation and file formats of the PyTorch port against the JAX
package's, on the CPU: the ScanNet semantic evaluation, PLY I/O, npz
checkpoints of the map and the system, and the PNG writer."""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.eval import ply as jply
from ra_slam_tpu.eval.scannet_eval import ScannetEval as JaxScannetEval
from ra_slam_tpu.map import synthetic_map as jsm
from ra_slam_tpu.utils import checkpoint as jck
from ra_slam_tpu_torch.core.config import CameraConfig, SystemConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.eval import ply as tply
from ra_slam_tpu_torch.eval.scannet_eval import ScannetEval
from ra_slam_tpu_torch.io.png import write_png
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu_torch.map import voxel_map as tvm
from ra_slam_tpu_torch.map.blocks import pack_block_coords
from ra_slam_tpu_torch.map.hash_table import ht_lookup
from ra_slam_tpu_torch.map.synthetic_map import analytic_box_map
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from ra_slam_tpu_torch.utils import checkpoint as tck
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

HE = (1.5, 1.0, 1.5)


def _jax_box_map():
    return jsm.analytic_box_map(tp.jax_cfg(), half_extents=HE)


def _box_gt_mesh(rng, n=4000):
    """Points on the walls of the HE room labeled nyu40 5 (chair: high
    touch) on the +x wall and 1 (wall: low touch) elsewhere, a few 0
    (unannotated), with random faces."""
    he = np.array(HE)
    v = rng.uniform(-he, he, (n, 3))
    axis = rng.integers(0, 3, n)
    side = rng.choice([-1.0, 1.0], n)
    v[np.arange(n), axis] = side * he[axis]
    labels = np.where((axis == 0) & (side > 0), 5, 1)
    labels[rng.random(n) < 0.02] = 0
    faces = rng.integers(0, n, (n // 2, 3))
    return v.astype(np.float32), faces.astype(np.int32), labels


def test_scannet_eval_matches_jax(tmp_path):
    """A dumped tsdf.bin (the analytic room, prob 0.9 on the +x wall)
    scored against a labeled PLY written by save_ply: the same summary
    in both packages, and the +x wall found (5 cm voxels put lattice
    planes on every wall)."""
    cfg = dataclasses.replace(tp.torch_cfg(), voxel_size=0.05, truncation=0.2)
    m = analytic_box_map(cfg, "cpu", half_extents=HE)
    rows = tvm.gather_valid_semantic(m, cfg)
    m.prob[:] = 0.1
    hx = torch.as_tensor(rows[:, 0].reshape(m.active.sum().item(), 512) > HE[0] - 0.1)
    m.prob[torch.nonzero(m.active).squeeze(1)] = torch.where(hx, 0.9, 0.1)
    tsdf_path = str(tmp_path / "tsdf.bin")
    n = tvm.dump_semantic_tsdf(m, cfg, tsdf_path)
    assert n == len(rows)
    v, f, labels = _box_gt_mesh(np.random.default_rng(0))
    gt_path = str(tmp_path / "gt.labels.ply")
    tply.save_ply(gt_path, v, f, vertex_labels=labels)

    s = ScannetEval(tsdf_path, gt_path).summary()
    assert s == JaxScannetEval(tsdf_path, gt_path).summary()
    assert s["iou"] > 0.5 and sum(map(sum, s["confusion"])) > 1000


def test_ply_binary_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    v, f, labels = _box_gt_mesh(rng, 500)
    colors = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    path = str(tmp_path / "m.ply")
    tply.save_ply(path, v, f, vertex_colors=colors, vertex_labels=labels)
    with open(path, "rb") as fh:
        assert fh.read() == _jax_ply_bytes(tmp_path, v, f, colors, labels)
    for load in (tply.load_ply, jply.load_ply):
        m = load(path)
        np.testing.assert_array_equal(m.vertices, v.astype(np.float64))
        np.testing.assert_array_equal(m.faces, f)
        np.testing.assert_array_equal(m.labels, labels)
        np.testing.assert_array_equal(m.vertex_props["red"], colors[:, 0])


def _jax_ply_bytes(tmp_path, v, f, colors, labels):
    path = str(tmp_path / "jax.ply")
    jply.save_ply(path, v, f, vertex_colors=colors, vertex_labels=labels)
    with open(path, "rb") as fh:
        return fh.read()


def test_ply_ascii_load(tmp_path):
    """An ASCII PLY with colours and labels loads the same in both
    packages."""
    text = "\n".join([
        "ply", "format ascii 1.0", "comment made by hand", "element vertex 4",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "property ushort label", "element face 2", "property list uchar int vertex_indices",
        "end_header",
        "0 0 0 255 0 0 5", "1 0 0 0 255 0 1", "0 1.5 0 0 0 255 0", "0 0 -2.25 9 9 9 40",
        "3 0 1 2", "3 0 2 3", "",
    ])
    path = tmp_path / "a.ply"
    path.write_text(text)
    t, j = tply.load_ply(str(path)), jply.load_ply(str(path))
    np.testing.assert_array_equal(t.vertices, [[0, 0, 0], [1, 0, 0], [0, 1.5, 0], [0, 0, -2.25]])
    np.testing.assert_array_equal(t.faces, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_array_equal(t.labels, [5, 1, 0, 40])
    for name in t.vertex_props:
        np.testing.assert_array_equal(t.vertex_props[name], j.vertex_props[name])
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.faces, j.faces)


def test_jax_map_checkpoint_loads_into_port(tmp_path):
    """A JAX `save_pytree(map.npz)` loads into the port and reproduces
    the map exactly, and the port's file loads back into JAX."""
    jm = _jax_box_map()
    path = str(tmp_path / "map.npz")
    jck.save_pytree(path, jm)
    names = sorted(np.load(path).files)
    assert names == sorted([
        ".table.key", ".table.value", ".block_key", ".block_slot", ".active", ".tsdf",
        ".weight", ".rgb", ".prob", ".alloc_failures", ".free_stack", ".free_top"])
    tm = tck.load_pytree(path, tvm.create_map(tp.torch_cfg(), "cpu"))
    jn = jax.tree.map(np.asarray, jm)
    tp.assert_maps_match(jn, voxel_map_to_numpy(tm), tol={"tsdf": 0, "weight": 0, "prob": 0, "rgb": 0})
    np.testing.assert_array_equal(jn.free_stack, tm.free_stack.numpy())

    back = str(tmp_path / "port.npz")
    tck.save_pytree(back, tm)
    assert sorted(np.load(back).files) == names
    jm2 = jck.load_pytree(back, jax.tree.map(jnp.zeros_like, jm))
    for a, b in zip(jax.tree.leaves(jm), jax.tree.leaves(jm2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_map_checkpoint_without_free_stack(tmp_path):
    """A map file that predates the free-row stack: free_top = N -
    active, the free rows on the stack, and allocation goes on from
    them."""
    jm = _jax_box_map()
    jn = jax.tree.map(np.asarray, jm)
    jck.save_pytree(str(tmp_path / "full.npz"), jm)
    full = dict(np.load(str(tmp_path / "full.npz")))
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **{k: v for k, v in full.items() if k not in (".free_stack", ".free_top")})
    cfg = tp.torch_cfg()
    m = tck.load_pytree(path, tvm.create_map(cfg, "cpu"))
    n, act = cfg.num_blocks, jn.active
    assert int(m.free_top) == n - act.sum()
    top = int(m.free_top)
    assert sorted(m.free_stack[:top].tolist()) == np.flatnonzero(~act).tolist()
    assert sorted(m.free_stack.tolist()) == list(range(n))

    keys = pack_block_coords(torch.tensor([[40, 40, 40], [41, 40, 40]], dtype=torch.int32))
    tvm.allocate_keys(m, keys, max_new_blocks=2)
    assert int(m.alloc_failures) == 0 and int(m.free_top) == top - 2
    assert not act[ht_lookup(m.table, keys).numpy()].any()


def test_system_checkpoint_round_trip(tmp_path):
    """save_system / load_system: a fresh facade resumes with the same
    map and counters and fuses on identically."""
    cam = dict(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    cfg = SystemConfig(camera=CameraConfig(**cam), tsdf=dataclasses.replace(tp.torch_cfg(), voxel_size=0.05))
    ds = SyntheticBoxDataset(num_frames=6, cam=SyntheticCameraSpec(**cam), radius=0.8)

    def feed(s, i):
        fr = ds.frame(i)
        return s.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt,
                                 pose=SE3.from_matrix(torch.as_tensor(fr.cam_T_world)))

    a = RaSlamSystem(cfg, "cpu", enable_tracking=False)
    for i in range(2):
        feed(a, i)
    tck.save_system(str(tmp_path / "ckpt"), a)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["map.npz", "meta.npz"]
    b = RaSlamSystem(cfg, "cpu", enable_tracking=False)
    tck.load_system(str(tmp_path / "ckpt"), b)
    assert b.num_integrated == 2
    assert feed(a, 2) == feed(b, 2)
    for name in ("tsdf", "weight", "prob", "rgb", "block_key", "free_stack"):
        assert torch.equal(getattr(a.map, name), getattr(b.map, name)), name


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_png_writer_pixels_equal_cv2_read(tmp_path, channels):
    rng = np.random.default_rng(channels or 1)
    shape = (37, 53) if channels is None else (37, 53, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels == 3:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    elif channels == 4:
        back = cv2.cvtColor(back, cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(back, img)


def test_png_writer_rejects_bad_images(tmp_path):
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))
