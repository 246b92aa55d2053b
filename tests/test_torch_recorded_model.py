"""`offline_eval --model` in the PyTorch port against the JAX package's
CLI on the CPU (tests/test_torch_recorded.py holds the rest of the
recorded-data path, tests/test_torch_facade_model.py the facade with
other widths). Both nets compute in bf16
(tests/test_torch_segmentation.py's bounds), so the fused prob is held
to SEG_PROB_TOL (measured 0.0054) and the rest as in
tests/test_torch_recorded.py. The JAX CLI runs op by op."""

import torch_parity as tp
from ra_slam_tpu_torch.models import segmentation as tseg
from test_torch_recorded import _jax_folder, _run_both

SEG_PROB_TOL = 0.05  # fused prob where bf16 nets make the maps


def test_model_cli_with_a_port_checkpoint_matches_jax(tmp_path, monkeypatch):
    """`--model` with a default-width checkpoint the port saves (random
    weights), one frame of a folder without maps: the JAX CLI loads the
    same file, and both nets segment the frame."""
    folder = _jax_folder(tmp_path / "rec", maps=False)
    ckpt = str(tmp_path / "seg.msgpack")
    tseg.InferenceEngine("__random__", tp.CAM_KW["width"], tp.CAM_KW["height"], device="cpu").save(ckpt)
    _, rows = _run_both(tmp_path, monkeypatch, ["--folder", folder, "--model", ckpt, "--max-frames", "1"],
                        prob_tol=SEG_PROB_TOL)
    assert 0.0 < rows[:, 4].min() and rows[:, 4].max() < 1.0
