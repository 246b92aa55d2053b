"""Evaluation: trajectory metrics, the trajectory bench, PLY I/O, the
ScanNet semantic evaluation and the mesh-dump reader (counterpart of
`ra_slam_tpu.eval`)."""

from ra_slam_tpu_torch.eval.ate import ate_rmse, rpe_rmse, umeyama_alignment
from ra_slam_tpu_torch.eval.labelparser import (
    NYU40_HT_DICT,
    NYU40_ID_TO_CLASS,
    LabelParser,
)
from ra_slam_tpu_torch.eval.mesh_processor import MeshReader, recolor_gt_by_ht
from ra_slam_tpu_torch.eval.ply import PlyMesh, load_ply, save_ply
from ra_slam_tpu_torch.eval.scannet_eval import (
    ScannetEval,
    read_semantic_tsdf,
    tsdf_to_semantic_pc,
)

__all__ = [
    "LabelParser",
    "ate_rmse",
    "rpe_rmse",
    "umeyama_alignment",
    "MeshReader",
    "NYU40_HT_DICT",
    "NYU40_ID_TO_CLASS",
    "PlyMesh",
    "ScannetEval",
    "load_ply",
    "read_semantic_tsdf",
    "recolor_gt_by_ht",
    "save_ply",
    "tsdf_to_semantic_pc",
]
