"""RGB-D datasets (counterpart of `ra_slam_tpu.io`): the synthetic box
room, logged folders (`folder.py`), ScanNet `.sens` files (`sens.py`),
and the PNG (`png.py`) and JPEG (`jpeg.py`, nvjpeg on a CUDA device)
codecs they read through, none of which needs cv2, PyYAML or PIL.
"""

from ra_slam_tpu_torch.io.dataset import Frame, RGBDDataset
from ra_slam_tpu_torch.io.folder import (
    FolderReader,
    load_trajectory,
    save_trajectory,
    write_folder_dataset,
)
from ra_slam_tpu_torch.io.sens import SensReader, write_sens
from ra_slam_tpu_torch.io.synthetic import (
    SyntheticBoxDataset,
    SyntheticCameraSpec,
    look_at,
    render_box_room,
)

__all__ = [
    "Frame",
    "RGBDDataset",
    "FolderReader",
    "SensReader",
    "SyntheticBoxDataset",
    "SyntheticCameraSpec",
    "load_trajectory",
    "look_at",
    "render_box_room",
    "save_trajectory",
    "write_folder_dataset",
    "write_sens",
]
