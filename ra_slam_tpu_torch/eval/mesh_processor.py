"""Reader / post-processor for dumped reconstruction meshes (counterpart
of `ra_slam_tpu/eval/mesh_processor.py`).

Load the `mesh_vertices.bin` / `mesh_indices.bin` /
`mesh_vertices_prob.bin` triple, color vertices by high-touch
probability, vertex-clustering decimation, normals, and PLY export,
all in numpy.
"""

from __future__ import annotations

import os

import numpy as np

from ra_slam_tpu_torch.eval.ply import save_ply


class MeshReader:
    def __init__(self, mesh_dir: str):
        self.vertices = np.fromfile(
            os.path.join(mesh_dir, "mesh_vertices.bin"), dtype=np.float32
        ).reshape(-1, 3)
        self.indices = np.fromfile(
            os.path.join(mesh_dir, "mesh_indices.bin"), dtype=np.int32
        ).reshape(-1, 3)
        self.ht_prob = np.fromfile(
            os.path.join(mesh_dir, "mesh_vertices_prob.bin"), dtype=np.float32
        ).reshape(-1)

        if self.ht_prob.shape[0] != self.vertices.shape[0]:
            raise ValueError(
                f"{mesh_dir}: {self.ht_prob.shape[0]} probabilities for "
                f"{self.vertices.shape[0]} vertices"
            )
        if not ((self.ht_prob >= 0.0) & (self.ht_prob <= 1.0)).all():
            raise ValueError(f"{mesh_dir}: probabilities outside [0, 1]")

    # -- derived attributes ---------------------------------------------------
    def vertex_colors(self) -> np.ndarray:
        """Red channel = high-touch probability (reference
        `fill_mesh_w_raw_prob`)."""
        c = np.zeros((len(self.vertices), 3), np.float32)
        c[:, 0] = self.ht_prob
        return c

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted average of incident face normals."""
        v, f = self.vertices, self.indices
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        normals = np.zeros_like(v)
        for k in range(3):
            np.add.at(normals, f[:, k], fn)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        return normals / np.maximum(norm, 1e-12)

    def num_vertices(self) -> int:
        return len(self.vertices)

    def num_triangles(self) -> int:
        return len(self.indices)

    # -- simplification -------------------------------------------------------
    def vertex_clustering_downsample(self, voxel_size: float = 0.05) -> None:
        """Cluster vertices on a uniform grid (average contraction), remap
        faces, drop degenerate triangles — the role of open3d's
        `simplify_vertex_clustering`."""
        v = self.vertices
        cell = np.floor(v / voxel_size).astype(np.int64)
        # unique cluster per occupied cell
        _, cluster, counts = np.unique(
            cell, axis=0, return_inverse=True, return_counts=True
        )
        n_clusters = len(counts)
        pos = np.zeros((n_clusters, 3), np.float64)
        prob = np.zeros((n_clusters,), np.float64)
        np.add.at(pos, cluster, v)
        np.add.at(prob, cluster, self.ht_prob)
        pos /= counts[:, None]
        prob /= counts

        f = cluster[self.indices]
        keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        self.vertices = pos.astype(np.float32)
        self.ht_prob = prob.astype(np.float32)
        self.indices = f[keep].astype(np.int32)

    def save(self, path: str) -> None:
        save_ply(path, self.vertices, self.indices, vertex_colors=self.vertex_colors())


def recolor_gt_by_ht(gt_ply_path: str, out_ply_path: str) -> None:
    """Recolor a labeled ScanNet GT mesh by its high-touch binarization
    for visual comparison (the reference's
    `python_utils/scannet_eval/utils/convert_scannet_to_ht.py`)."""
    from ra_slam_tpu_torch.eval.labelparser import LabelParser
    from ra_slam_tpu_torch.eval.ply import load_ply

    mesh = load_ply(gt_ply_path)
    if mesh.labels is None:
        raise ValueError("GT mesh has no 'label' property")
    ht_map = LabelParser().get_nyuid_to_ht_map()
    lut = np.zeros(max(ht_map) + 1, dtype=np.float32)
    for k, v in ht_map.items():
        lut[k] = float(v)
    ht = lut[np.clip(mesh.labels.astype(np.int64), 0, len(lut) - 1)]
    colors = np.zeros((len(mesh.vertices), 3), np.float32)
    colors[:, 0] = ht
    save_ply(out_ply_path, mesh.vertices, mesh.faces, vertex_colors=colors)
