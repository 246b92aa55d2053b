"""scripts/train_torch_semantic.py, the PyTorch port's segmentation
trainer, on the CPU: one step from the committed JAX init, and its
weights in the JAX package's engine (tests/test_torch_train.py holds the
training step itself against optax)."""

import importlib.util
import os

import jax
import numpy as np

import torch_parity  # noqa: F401  (torch threads)
from ra_slam_tpu.models import segmentation as jseg
from ra_slam_tpu_torch.models import segmentation as tseg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trainer_weights_load_in_jax_engine(tmp_path):
    """scripts/train_torch_semantic.py from the committed JAX init, one
    step on the CPU: its first loss is SEMANTIC_r05.json's (0.6504, on a
    TPU) within 0.01, and the flax msgpack it writes loads in the JAX
    package's `InferenceEngine(widths=(16, 32, 64))`, whose probabilities
    on a held-out frame are the port engine's within the bf16 bounds of
    tests/test_torch_segmentation.py (prob 0.06, 1e-3 of the decisions)."""
    spec = importlib.util.spec_from_file_location("train_torch_semantic",
                                                  os.path.join(REPO, "scripts", "train_torch_semantic.py"))
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    out = str(tmp_path / "seg.msgpack")
    r = trainer.main(["--steps", "1", "--out", out, "--device", "cpu"])
    assert abs(r["train_loss_first_last"][0] - 0.6504) <= 0.01, r

    frame = trainer.frames(seed=3, n=1)[0]
    jeng = jseg.InferenceEngine(out, width=320, height=240, widths=(16, 32, 64))
    with jax.disable_jit():
        jht, _ = jeng.infer_one(frame.rgb)
    teng = tseg.InferenceEngine(out, width=320, height=240, widths=(16, 32, 64), device="cpu")
    tht, _ = teng.infer_one(frame.rgb)
    assert np.abs(jht - tht).max() <= 0.06
    assert ((jht > 0.5) != (tht > 0.5)).mean() <= 1e-3
