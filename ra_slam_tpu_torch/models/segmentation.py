"""Semantic segmentation engine (counterpart of `ra_slam_tpu/models/segmentation.py`).

Only the fake mode is ported: with no model, `infer_one` returns
all-ones high-touch / low-touch maps, as the reference does with an empty
model path, so the fusion pipeline runs without a trained network. The
UNet is still to port (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class InferenceEngine:
    """Per-frame ht/lt inference; `model_path=None` is the fake mode."""

    def __init__(self, model_path: Optional[str] = None, width: int = 640, height: int = 480):
        if model_path is not None:
            raise NotImplementedError(
                "the segmentation UNet is not ported yet; only fake mode (no model) runs"
            )
        self.fake = True
        self.width = width
        self.height = height

    def infer_one(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[H, W, 3] RGB -> (ht, lt) float32 maps at the engine's size."""
        shape = (self.height, self.width)
        return np.ones(shape, np.float32), np.ones(shape, np.float32)
