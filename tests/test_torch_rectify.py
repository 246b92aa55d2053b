"""Stereo rectification of the PyTorch port (ra_slam_tpu_torch/core/
rectify.py), written without OpenCV, against cv2 (the JAX package's
`StereoRectifier` calls cv2) on the CPU.

Bounds: R_l, R_r, P_l, P_r and Q within 1e-9 relative (measured <= 4e-14:
float64 in both); the float32 maps within 1e-4 px (measured 0 on the
ZED-like calibration, 1.8e-15 near zero on the identity); the uint8
remap exactly equal (cv2 5's float interpolation, fused multiply-adds
included, emulated in float64)."""

import cv2
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads)
from ra_slam_tpu.core import config as jconfig
from ra_slam_tpu.core import rectify as jrect
from ra_slam_tpu.io.capture import calib_to_yaml, parse_zed_conf
from ra_slam_tpu_torch.core import config as tconfig
from ra_slam_tpu_torch.core import rectify as trect
from test_capture import _CONF
from test_stereo import BASELINE, _stereo_pair

VGA = (672, 376)


def _identity():
    mono = dict(fx=120.0, fy=120.0, cx=119.5, cy=89.5, distortion=[0.0] * 5)
    return (240, 180), dict(left=mono, right=mono, rotation=[0.0, 0.0, 0.0], translation=[-BASELINE, 0.0, 0.0])


def _zed_vga(tmp_path):
    """tests/test_capture.py's ZED factory calibration (HD) scaled to VGA."""
    p = tmp_path / "SN000.conf"
    p.write_text(_CONF)
    c = parse_zed_conf(str(p), "720p")
    sx, sy = VGA[0] / 1280, VGA[1] / 720

    def mono(m):
        return dict(fx=m["fx"] * sx, fy=m["fy"] * sy, cx=m["cx"] * sx, cy=m["cy"] * sy,
                    distortion=[m["k1"], m["k2"], m["p1"], m["p2"], m["k3"]])

    return VGA, dict(left=mono(c["left"]), right=mono(c["right"]), rotation=c["rotation"],
                     translation=[-c["baseline"], 0.0, 0.0])


def _both(size, calib):
    """(the port's rectifier on the CPU, the JAX package's) of one calibration."""
    port = trect.StereoRectifier(size, trect.CalibStereo(
        trect.CalibMono(**calib["left"]), trect.CalibMono(**calib["right"]), calib["rotation"],
        calib["translation"]), device="cpu")
    jax_side = jrect.StereoRectifier(size, jrect.CalibStereo(
        jrect.CalibMono(**calib["left"]), jrect.CalibMono(**calib["right"]), calib["rotation"],
        calib["translation"]))
    return port, jax_side


@pytest.fixture(params=["identity", "zed_vga"])
def calib(request, tmp_path):
    return _identity() if request.param == "identity" else _zed_vga(tmp_path)


def test_stereo_rectify_matches_cv2(calib):
    size, c = calib
    K = lambda m: np.array([[m["fx"], 0, m["cx"]], [0, m["fy"], m["cy"]], [0, 0, 1.0]])
    R = cv2.Rodrigues(np.array(c["rotation"], np.float64))[0]
    np.testing.assert_allclose(trect.rodrigues(c["rotation"]), R, rtol=0, atol=1e-15)
    np.testing.assert_allclose(trect.rodrigues_vector(R), cv2.Rodrigues(R)[0].ravel(), rtol=0, atol=1e-15)
    want = cv2.stereoRectify(K(c["left"]), np.array(c["left"]["distortion"]), K(c["right"]),
                             np.array(c["right"]["distortion"]), size, R, np.array(c["translation"]).reshape(3, 1),
                             flags=cv2.CALIB_ZERO_DISPARITY, alpha=0, newImageSize=size)[:5]
    got = trect.stereo_rectify(K(c["left"]), c["left"]["distortion"], K(c["right"]), c["right"]["distortion"],
                               size, R, c["translation"])
    for name, a, b in zip(("R_l", "R_r", "P_l", "P_r", "Q"), want, got):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), name


def test_maps_and_rectified_pairs_match_jax(calib):
    """The maps against the JAX rectifier's (cv2's), and the rectified
    uint8 pair against its `rectify` (cv2.remap), exactly."""
    size, c = calib
    port, jax_side = _both(size, c)
    np.testing.assert_allclose(port.cam_rect_matrix, jax_side.cam_rect_matrix, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(port.reproj_mat, jax_side.reproj_mat, rtol=1e-9, atol=1e-12)
    assert port.focal_x_baseline == pytest.approx(jax_side.focal_x_baseline, rel=1e-9)
    for ours, theirs in zip(port.maps, (jax_side._map_l, jax_side._map_r)):
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float32 and np.abs(a - b).max() <= 1e-4
    rng = np.random.default_rng(0)
    w, h = size
    img_l, img_r = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2))
    for ours, theirs in zip(port.rectify(img_l, img_r), jax_side.rectify(img_l, img_r)):
        assert ours.dtype == np.uint8 and ours.shape == (h, w, 3)
        np.testing.assert_array_equal(ours, theirs)
    # tensors in, tensors out, the same pixels
    tl, tr = port.rectify(torch.as_tensor(img_l), torch.as_tensor(img_r))
    np.testing.assert_array_equal(tl.numpy(), jax_side.rectify(img_l, img_r)[0])


@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_remap_linear_matches_cv2(channels):
    """Arbitrary float32 maps over the border (constant 0), exact."""
    rng = np.random.default_rng(channels)
    h, w = 61, 83
    shape = (h, w, channels) if channels else (h, w)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    mx = rng.uniform(-3, w + 2, (47, 59)).astype(np.float32)
    my = rng.uniform(-3, h + 2, (47, 59)).astype(np.float32)
    mx[::7] = np.round(mx[::7] * 4) / 4  # map values on the 1/4 grid too
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    plan = trect.remap_plan(torch.as_tensor(mx), torch.as_tensor(my), (h, w))
    got = trect.remap_linear(torch.as_tensor(img), plan).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_from_yaml_reads_calib_to_yaml(tmp_path):
    """`from_yaml` on the text `io/capture.py:calib_to_yaml` writes (the
    baseline standing for the translation, which the JAX reader cannot
    take) gives the rectifier built from the same numbers."""
    p = tmp_path / "SN000.conf"
    p.write_text(_CONF)
    c = parse_zed_conf(str(p), "720p")
    path = tmp_path / "calib.yaml"
    path.write_text(calib_to_yaml(c, 1280, 720))
    r = trect.StereoRectifier.from_yaml(str(path), device="cpu")
    mono = lambda m: trect.CalibMono(m["fx"], m["fy"], m["cx"], m["cy"], [m["k1"], m["k2"], m["p1"], m["p2"], m["k3"]])
    want = trect.StereoRectifier((1280, 720), trect.CalibStereo(mono(c["left"]), mono(c["right"]), c["rotation"],
                                                                [-c["baseline"], 0.0, 0.0]), device="cpu")
    np.testing.assert_array_equal(r.cam_rect_matrix, want.cam_rect_matrix)
    assert r.focal_x_baseline == pytest.approx(c["baseline"] * r.cam_rect_matrix[0, 0], rel=1e-12)


def test_rewrite_camera_config_and_camera_match_jax():
    size, c = _identity()
    port, jax_side = _both(size, c)
    jc = jrect.rewrite_camera_config(jconfig.SystemConfig(), jax_side).camera
    tc = trect.rewrite_camera_config(tconfig.SystemConfig(), port).camera
    for f in ("fx", "fy", "cx", "cy", "width", "height", "focal_x_baseline"):
        assert getattr(tc, f) == pytest.approx(getattr(jc, f), rel=1e-12), f
    cam = port.rectified_camera()
    assert (cam.width, cam.height) == size and cam.fx == np.float32(port.cam_rect_matrix[0, 0])
    # a rectified synthetic pair comes back nearly unchanged (tests/test_stereo.py:79)
    rgb_l, rgb_r, _, _ = _stereo_pair()
    out_l, _ = port.rectify(rgb_l, rgb_r)
    assert np.abs(out_l[40:140, 40:200].astype(float) - rgb_l[40:140, 40:200]).mean() < 10.0


def test_cuda_rectifier_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    size, c = _identity()
    with pytest.raises(RuntimeError, match="cuda"):
        trect.StereoRectifier(size, trect.CalibStereo(trect.CalibMono(**c["left"]), trect.CalibMono(**c["right"]),
                                                      c["rotation"], c["translation"]))
