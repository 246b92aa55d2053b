"""ScanNet semantic-reconstruction evaluation, IoU / precision / recall
(counterpart of `ra_slam_tpu/eval/scannet_eval.py`).

Load a dumped semantic TSDF, keep |tsdf| < 0.1 as a surface point
cloud, transfer the ground-truth nyu40 labels of the annotated ScanNet
mesh by nearest vertex (scipy's cKDTree), binarize them by the curated
high-touch map, and compute the confusion matrix and its metrics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ra_slam_tpu_torch.eval.labelparser import LabelParser
from ra_slam_tpu_torch.eval.ply import load_ply

TSDF_THRESHOLD = 0.1


def read_semantic_tsdf(path: str) -> np.ndarray:
    """(n, 5) float32 rows of (x, y, z, tsdf, prob) — the binary layout
    written by `dump_semantic_tsdf` (the reference's `DownloadAll`
    layout)."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 5)


def tsdf_to_semantic_pc(
    tsdf_np: np.ndarray, threshold: float = TSDF_THRESHOLD
) -> np.ndarray:
    """Keep near-surface voxels; rows become (x, y, z, prob)."""
    pc = tsdf_np[np.abs(tsdf_np[:, 3]) < threshold, :]
    return pc[:, [0, 1, 2, 4]]


class ScannetEval:
    """Compare a semantic TSDF dump against a labeled ScanNet GT mesh."""

    def __init__(
        self,
        tsdf_path: str,
        gt_poly_path: str,
        p_cutoff: float = 0.5,
        labels_tsv: Optional[str] = None,
    ):
        self.tsdf_np = read_semantic_tsdf(tsdf_path)
        self.semantic_pc = tsdf_to_semantic_pc(self.tsdf_np)
        self.xyz_pc = self.semantic_pc[:, :3]

        mesh = load_ply(gt_poly_path)
        if mesh.labels is None:
            raise ValueError(f"{gt_poly_path} has no per-vertex 'label' property")
        gt_label_arr = self._nearest_point_label(
            mesh.vertices, mesh.labels.astype(np.int64)
        )

        # drop unannotated (label 0) points, map nyu40 -> high-touch
        keep = gt_label_arr != 0
        gt_label_arr = gt_label_arr[keep]
        ht_map = LabelParser(labels_tsv).get_nyuid_to_ht_map()
        lut = np.zeros(max(ht_map) + 1, dtype=np.int64)
        for k, v in ht_map.items():
            lut[k] = v
        self.gt_high_touch_arr = lut[np.clip(gt_label_arr, 0, len(lut) - 1)]
        self.predicted_label_arr = (self.semantic_pc[keep, 3] > p_cutoff).astype(
            np.int64
        )

    def _nearest_point_label(
        self, gt_vertices: np.ndarray, gt_labels: np.ndarray
    ) -> np.ndarray:
        from scipy.spatial import cKDTree

        tree = cKDTree(gt_vertices)
        _, nn_idx = tree.query(self.xyz_pc, k=1)
        return gt_labels[nn_idx]

    # -- metrics (identical formulas to the reference) -----------------------
    def get_confusion_matrix(self) -> np.ndarray:
        """[[TP, FP], [FN, TN]] for the high-touch class."""
        p, g = self.predicted_label_arr, self.gt_high_touch_arr
        tp = int(np.sum((p == 1) & (g == 1)))
        tn = int(np.sum((p == 0) & (g == 0)))
        fp = int(np.sum((p == 1) & (g == 0)))
        fn = int(np.sum((p == 0) & (g == 1)))
        return np.array([[tp, fp], [fn, tn]])

    def get_iou(self) -> float:
        c = self.get_confusion_matrix()
        return c[0, 0] / (c[0, 0] + c[0, 1] + c[1, 0] + 1e-15)

    def get_voxel_acc(self) -> float:
        c = self.get_confusion_matrix()
        return (c[0, 0] + c[1, 1]) / np.sum(c)

    def get_precision(self) -> float:
        c = self.get_confusion_matrix()
        return c[0, 0] / (c[0, 0] + c[0, 1] + 1e-15)

    def get_recall(self) -> float:
        c = self.get_confusion_matrix()
        return c[0, 0] / (c[0, 0] + c[1, 0] + 1e-15)

    def summary(self) -> dict:
        return {
            "iou": float(self.get_iou()),
            "precision": float(self.get_precision()),
            "recall": float(self.get_recall()),
            "voxel_acc": float(self.get_voxel_acc()),
            "confusion": self.get_confusion_matrix().tolist(),
        }
