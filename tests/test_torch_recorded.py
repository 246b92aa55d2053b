"""The recorded-data path of the PyTorch port's offline_eval
(ra_slam_tpu_torch/pipeline/offline_eval.py `--folder`, `--sens`)
against the JAX package's CLI on the same JAX-written data, on the CPU:
the same counts, `tsdf.bin` xyz byte-equal, tsdf and prob within
tests/torch_parity.py's TOL (tests/test_torch_recorded_model.py adds
`--model`). The JAX CLI runs op by op (see tests/torch_parity.py); its
mesh dump is skipped (tests/test_torch_meshing.py holds meshing against
JAX)."""

import dataclasses

import jax
import numpy as np
import pytest

import torch_parity as tp
from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.io import folder as jfolder
from ra_slam_tpu.io import sens as jsens
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.pipeline import offline_eval as jax_cli
from ra_slam_tpu.pipeline.system import RaSlamSystem as JaxSystem
from ra_slam_tpu_torch.pipeline import offline_eval as port_cli

SMALL = ["--voxel-size", "0.05", "--truncation", "0.3", "--log2-blocks", "13"]


def _orbit(n=3):
    ds = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(**tp.CAM_KW), radius=1.0, seed=0)
    return ds, [ds.frame(i) for i in range(n)]


def _jax_folder(path, maps):
    ds, frames = _orbit()
    if not maps:
        frames = [dataclasses.replace(f, ht=None, lt=None) for f in frames]
    c = tp.CAM_KW
    jfolder.write_folder_dataset(str(path), frames, JaxCamera.create(c["fx"], c["fy"], c["cx"], c["cy"],
                                                                    c["width"], c["height"]))
    return str(path)


def _run_both(tmp_path, monkeypatch, src_args, prob_tol=tp.TOL["prob"]):
    monkeypatch.setattr(JaxSystem, "download_all_mesh", lambda self, *paths: (0, 0))
    with jax.disable_jit():
        rj = jax_cli.main(src_args + SMALL + ["--download", str(tmp_path / "jax")])
    rt = port_cli.main(src_args + SMALL + ["--download", str(tmp_path / "port"), "--device", "cpu"])
    for key in ("frames", "num_active", "num_visible", "alloc_failures", "tsdf_rows"):
        assert rt[key] == rj[key], key
    assert rt["frames"] > 0 and rt["tsdf_rows"] > 0
    a = np.fromfile(tmp_path / "jax" / "tsdf.bin", "<f4").reshape(-1, 5)
    b = np.fromfile(tmp_path / "port" / "tsdf.bin", "<f4").reshape(-1, 5)
    assert a[:, :3].tobytes() == b[:, :3].tobytes()
    assert np.abs(a[:, 3] - b[:, 3]).max() <= tp.TOL["tsdf"]
    dp = np.abs(a[:, 4] - b[:, 4]).max()
    assert dp <= prob_tol, dp
    return rt, b


@pytest.mark.parametrize("maps,frames", [(True, 2), (False, 1)], ids=["with-ht-maps", "fake-maps"])
def test_folder_cli_matches_jax(tmp_path, monkeypatch, maps, frames):
    """`--folder` on a 3-frame JAX-written (cv2) folder: with its `_ht`
    maps fused as read, without them through the fake engine."""
    folder = _jax_folder(tmp_path / "rec", maps)
    r, rows = _run_both(tmp_path, monkeypatch, ["--folder", folder, "--max-frames", str(frames)])
    assert r["frames"] == frames
    if not maps:
        assert (rows[:, 4] == 0.5).all()  # equal all-ones maps leave every voxel's prob at 0.5


def _jax_sens(tmp_path):
    """A JAX-written `.sens` of 3 orbit frames: PNG colour at twice the
    depth size, zlib depth."""
    ds, frames = _orbit()
    c = tp.CAM_KW
    big = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(
        fx=2 * c["fx"], fy=2 * c["fy"], cx=2 * c["cx"] + 0.5, cy=2 * c["cy"] + 0.5,
        width=2 * c["width"], height=2 * c["height"]), radius=1.0, seed=0)
    k = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]], np.float32)
    path = str(tmp_path / "scene.sens")
    jsens.write_sens(path, [big.frame(i).rgb for i in range(3)],
                     [np.clip(f.depth * 1000.0, 0, 65535).astype(np.uint16) for f in frames],
                     [np.linalg.inv(f.cam_T_world.astype(np.float64)).astype(np.float32) for f in frames],
                     k, color_compression=jsens.COLOR_PNG)
    return path


def test_sens_cli_matches_jax(tmp_path, monkeypatch):
    """`--sens` on a JAX-written file with PNG colour at twice the depth
    size (resized to it on read) and zlib depth."""
    r, _ = _run_both(tmp_path, monkeypatch, ["--sens", _jax_sens(tmp_path), "--max-frames", "2"])
    assert r["frames"] == 2


def test_native_io_matches_plain_sens(tmp_path):
    """`--sens --native-io` (frames decoded ahead by two threads,
    io/prefetch.py) dumps the same map as `--sens`, byte for byte."""
    path = _jax_sens(tmp_path)
    runs = {}
    for name, extra in (("plain", []), ("native", ["--native-io"])):
        out = tmp_path / name
        r = port_cli.main(["--sens", path, "--max-frames", "3", "--device", "cpu", "--download", str(out)]
                          + SMALL + extra)
        runs[name] = (r, (out / "tsdf.bin").read_bytes(), (out / "mesh_indices.bin").read_bytes())
    (rp, tp_, mp), (rn, tn, mn) = runs["plain"], runs["native"]
    for key in ("frames", "num_active", "tsdf_rows", "mesh_vertices", "mesh_triangles"):
        assert rn[key] == rp[key], key
    assert rn["frames"] == 3 and tn == tp_ and mn == mp
