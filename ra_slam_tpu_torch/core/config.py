"""Configuration dataclasses (counterpart of `ra_slam_tpu/core/config.py`).

Same fields and defaults as the JAX package's `CameraConfig`,
`TsdfConfig` and `SystemConfig`. The tracking, feature and BA configs
arrive with the tracking port. `yaml` is imported only inside
`load_yaml_config`, so importing this module needs no PyYAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    width: int = 640
    height: int = 480
    fps: float = 30.0
    depthmap_factor: float = 5000.0  # raw depth units per meter
    # stereo only:
    focal_x_baseline: float = 0.0


@dataclass(frozen=True)
class TsdfConfig:
    """Dense map parameters.

    Defaults mirror the reference call sites: voxel 0.01 m, truncation
    6x voxel, max depth 6 m, weight clamp 40 and carving threshold 0.9.
    """

    voxel_size: float = 0.01
    truncation: float = 0.06
    max_depth: float = 6.0
    min_depth: float = 0.1
    max_weight: float = 40.0
    carve_threshold: float = 0.9
    raycast_min_weight: float = 10.0
    # capacities (fixed pool and hash sizes; per-frame overflow counted)
    log2_num_blocks: int = 16
    log2_hash_size: int = 18
    max_visible_blocks: int = 8192
    max_new_blocks: int = 8192  # per-frame allocation cap (overflow counted)
    max_shell_blocks: int = 0
    # image feed size
    width: int = 640
    height: int = 480

    @property
    def num_blocks(self) -> int:
        return 1 << self.log2_num_blocks

    @property
    def hash_size(self) -> int:
        return 1 << self.log2_hash_size


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    tsdf: TsdfConfig = field(default_factory=TsdfConfig)
    # extrinsics: 4x4 row-major depth-cam -> tracking-cam transform
    extrinsics: Optional[list] = None


def _get(node: dict, key: str, default):
    return node[key] if node and key in node else default


def load_yaml_config(path: str) -> SystemConfig:
    """Parse a reference-style YAML config into a SystemConfig (the
    camera, tsdf and extrinsics keys of the JAX package's loader)."""
    import yaml

    with open(path) as f:
        node = yaml.safe_load(f) or {}

    cam_node = node.get("Camera", node.get("camera", {})) or {}
    if not cam_node:
        cam_node = {
            k.split(".", 1)[1]: v for k, v in node.items() if k.startswith("Camera.")
        }
    cam = CameraConfig(
        fx=float(_get(cam_node, "fx", 525.0)),
        fy=float(_get(cam_node, "fy", 525.0)),
        cx=float(_get(cam_node, "cx", 319.5)),
        cy=float(_get(cam_node, "cy", 239.5)),
        width=int(_get(cam_node, "cols", _get(cam_node, "width", 640))),
        height=int(_get(cam_node, "rows", _get(cam_node, "height", 480))),
        fps=float(_get(cam_node, "fps", 30.0)),
        depthmap_factor=float(
            node.get("depthmap_factor", cam_node.get("depthmap_factor", 5000.0))
        ),
        focal_x_baseline=float(_get(cam_node, "focal_x_baseline", 0.0)),
    )

    tsdf_node = node.get("tsdf", {}) or {}
    tsdf_kwargs = {}
    for f_ in dataclasses.fields(TsdfConfig):
        if f_.name in tsdf_node:
            tsdf_kwargs[f_.name] = type(f_.default)(tsdf_node[f_.name])
    for k in ("width", "height"):
        flat = node.get(f"tsdf.{k}")
        if flat is not None:
            tsdf_kwargs[k] = int(flat)

    extrinsics = node.get("Extrinsics", node.get("extrinsics"))
    return SystemConfig(camera=cam, tsdf=TsdfConfig(**tsdf_kwargs), extrinsics=extrinsics)
