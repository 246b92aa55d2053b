"""TUM-style logged-folder dataset: reader, writer, trajectory format
(counterpart of `ra_slam_tpu/io/folder.py`).

    <dir>/camera_config.yaml      Camera.fx/fy/cx/cy, depthmap_factor,
                                  optional Extrinsics (4x4 row-major list)
    <dir>/trajectory.txt          per line: id + 12 floats (3x4 row-major
                                  cam_T_world, last row implied 0 0 0 1)
    <dir>/{id}_rgb.png            8-bit colour
    <dir>/{id}_depth.png          16-bit raw depth (units/depthmap_factor m)
    <dir>/{id}_ht.png, {id}_no_ht.png   optional 8-bit probability maps

The PNGs go through `io/png.py` and the config through
`utils/flat_yaml.py`, so neither cv2 nor PyYAML is needed; a folder
either package writes reads the same in both.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.io.dataset import Frame, RGBDDataset
from ra_slam_tpu_torch.io.png import read_png, write_png
from ra_slam_tpu_torch.utils.flat_yaml import dump_flat_yaml, load_flat_yaml


def save_trajectory(path: str, entries: Sequence[Tuple[int, np.ndarray]]) -> None:
    """Write (frame_id, 3x4-or-4x4 cam_T_world) rows as `id r00 ... r23`."""
    with open(path, "w") as f:
        for fid, pose in entries:
            p = np.asarray(pose, np.float64)[:3, :4].reshape(-1)
            f.write(str(int(fid)) + " " + " ".join(f"{v:.9g}" for v in p) + "\n")


def load_trajectory(path: str) -> List[Tuple[int, np.ndarray]]:
    """Parse `trajectory.txt` rows into (id, 4x4 cam_T_world) pairs."""
    entries: List[Tuple[int, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) != 13:
                continue
            m = np.eye(4, dtype=np.float32)
            m[:3, :4] = np.array([float(v) for v in vals[1:]], np.float32).reshape(3, 4)
            entries.append((int(vals[0]), m))
    return entries


class FolderReader(RGBDDataset):
    """Replay of a logged folder. The extrinsics compose onto every
    trajectory pose; depth is divided by `depthmap_factor` (default
    1000); `_ht` / `_no_ht` maps are optional, as `/ 255` float32; the
    camera is the config's intrinsics at the first depth image's size."""

    def __init__(self, folder: str):
        self.folder = folder
        with open(os.path.join(folder, "camera_config.yaml")) as f:
            self._cfg = load_flat_yaml(f.read())
        extr = self._cfg.get("Extrinsics")
        self.extrinsics = (
            np.array(extr, np.float32).reshape(4, 4) if extr else np.eye(4, dtype=np.float32)
        )
        self._entries = [
            (fid, (self.extrinsics @ pose).astype(np.float32))
            for fid, pose in load_trajectory(os.path.join(folder, "trajectory.txt"))
        ]
        self._depth_factor = float(self._cfg.get("depthmap_factor", 1000.0))
        self._h, self._w = self._read(self._entries[0][0], "depth", "unchanged").shape

    def _read(self, fid: int, suffix: str, mode: str) -> np.ndarray:
        path = os.path.join(self.folder, f"{fid}_{suffix}.png")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return read_png(path, mode)

    def _read_prob(self, fid: int, suffix: str) -> Optional[np.ndarray]:
        if not os.path.exists(os.path.join(self.folder, f"{fid}_{suffix}.png")):
            return None
        return self._read(fid, suffix, "grayscale").astype(np.float32) / 255.0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def camera(self) -> PinholeCamera:
        c = self._cfg
        return PinholeCamera.create(
            float(c["Camera.fx"]), float(c["Camera.fy"]), float(c["Camera.cx"]), float(c["Camera.cy"]),
            self._w, self._h,
        )

    @property
    def depth_factor(self) -> float:
        return self._depth_factor

    def frame(self, idx: int) -> Frame:
        fid, pose = self._entries[idx]
        depth = self._read(fid, "depth", "unchanged")
        if depth.dtype != np.uint16 or depth.ndim != 2:
            raise ValueError(f"{fid}_depth.png is {depth.dtype} {depth.shape}, not 16-bit grey")
        return Frame(
            frame_id=fid,
            timestamp=float(fid),
            rgb=self._read(fid, "rgb", "color"),
            depth=depth.astype(np.float32) / self._depth_factor,
            cam_T_world=pose,
            ht=self._read_prob(fid, "ht"),
            lt=self._read_prob(fid, "no_ht"),
        )


def write_folder_dataset(
    folder: str,
    frames: Sequence[Frame],
    cam: PinholeCamera,
    depth_factor: float = 1000.0,
    extrinsics: Optional[np.ndarray] = None,
) -> None:
    """Log frames to the replay-folder layout: the config, 8-bit RGB and
    16-bit depth PNGs, the maps a frame has, and the poses it has."""
    os.makedirs(folder, exist_ok=True)
    cfg = {
        "Camera.fx": float(cam.fx),
        "Camera.fy": float(cam.fy),
        "Camera.cx": float(cam.cx),
        "Camera.cy": float(cam.cy),
        "depthmap_factor": float(depth_factor),
    }
    if extrinsics is not None:
        cfg["Extrinsics"] = [float(v) for v in np.asarray(extrinsics).reshape(-1)]
    with open(os.path.join(folder, "camera_config.yaml"), "w") as f:
        f.write(dump_flat_yaml(cfg))

    entries = []
    for fr in frames:
        fid = fr.frame_id
        write_png(os.path.join(folder, f"{fid}_rgb.png"), np.asarray(fr.rgb, np.uint8))
        depth_raw = np.clip(np.asarray(fr.depth, np.float32) * depth_factor, 0, 65535).astype(np.uint16)
        write_png(os.path.join(folder, f"{fid}_depth.png"), depth_raw)
        for suffix, prob in (("ht", fr.ht), ("no_ht", fr.lt)):
            if prob is not None:
                write_png(os.path.join(folder, f"{fid}_{suffix}.png"),
                          (np.clip(prob, 0, 1) * 255).astype(np.uint8))
        if fr.cam_T_world is not None:
            entries.append((fid, fr.cam_T_world))
    save_trajectory(os.path.join(folder, "trajectory.txt"), entries)
