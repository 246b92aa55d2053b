"""The PyTorch port's recorded-data readers against the JAX package's:
the flat-YAML reader and writer against PyYAML, logged folders written
by either package read by the other exactly, `.sens` files with PNG
colour written by the JAX package read exactly (at the native size and
with colour of another size resized, on the host and counted there),
and a JPEG `.sens` raising where no decoder is bound."""

import os

import numpy as np
import pytest
import torch
import yaml

from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.io import folder as jfolder
from ra_slam_tpu.io import sens as jsens
from ra_slam_tpu.io.dataset import Frame as JaxFrame
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.io import folder as tfolder
from ra_slam_tpu_torch.io import sens as tsens
from ra_slam_tpu_torch.io.dataset import Frame
from ra_slam_tpu_torch.utils.flat_yaml import FlatYamlError, dump_flat_yaml, load_flat_yaml

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CFG = {"Camera.fx": 60.0, "Camera.fy": 61.25, "Camera.cx": 31.5, "Camera.cy": 23.5, "depthmap_factor": 1000.0}
EXTR = [1.0, 0.0, 0.0, 0.1, 0.0, 1.0, 0.0, -0.25, 0.0, 0.0, 1.0, 1e-05, 0.0, 0.0, 0.0, 1.0]


@pytest.mark.parametrize("cfg", [CFG, {**CFG, "Extrinsics": EXTR}], ids=["plain", "extrinsics"])
def test_flat_yaml_matches_pyyaml_on_the_writer(cfg):
    text = yaml.safe_dump(cfg)
    assert load_flat_yaml(text) == yaml.safe_load(text) == cfg
    assert dump_flat_yaml(cfg) == text


HAND_WRITTEN = [
    "# camera\nCamera.fx: 320   # int\nCamera.fy: 3.2e+2\nname: 'a # b'\nq: \"x: y\"\n",
    "Extrinsics: [1.0, 0, -2.5e-3, .5]\nempty: []\nnothing:\nflag: yes\nswitch: Off\nhex: 0x1F\noct: 017\n",
    "---\na: .inf\nb: -.Inf\nc: ~\nd: 1_000\ne: 1e5\nf: 'it''s'\n",
    "Extrinsics:\n  - 1.0\n  - -2\n\n  # between items\n  - text\nafter: 1\n",
    "",
]


@pytest.mark.parametrize("text", HAND_WRITTEN)
def test_flat_yaml_matches_pyyaml_on_hand_written_files(text):
    want = yaml.safe_load(text) or {}
    got = load_flat_yaml(text)
    assert got.keys() == want.keys()
    for k in want:  # NaN-free, so == holds for floats
        assert got[k] == want[k] and type(got[k]) is type(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n", "a: {b: 1}\n", "a:\n- [1, 2]\n", "a:\n- - 1\n", "a:\n- b: 1\n", "- 1\n", "a: [1, [2]]\n",
])
def test_flat_yaml_rejects_nesting(text):
    with pytest.raises(FlatYamlError, match="line"):
        load_flat_yaml(text)


def _frames(n=3, h=48, w=64, seed=0, maps=True, frame_cls=Frame):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        rgb = np.stack([xx * 4 % 256, yy * 5 % 256, rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        depth = rng.uniform(0.3, 6.5, (h, w)).astype(np.float32)
        depth[rng.random((h, w)) < 0.05] = 0.0
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * i, -0.02 * i, 0.3]
        ht = rng.random((h, w)).astype(np.float32) if maps else None
        out.append(frame_cls(i * 10, float(i), rgb, depth, pose, ht, None if ht is None else 1 - ht))
    return out


def _assert_folders_equal(a, b):
    assert len(a) == len(b) and a.depth_factor == b.depth_factor
    ca, cb = a.camera, b.camera
    assert [float(ca.fx), float(ca.fy), float(ca.cx), float(ca.cy), ca.width, ca.height] == [
        float(cb.fx), float(cb.fy), float(cb.cx), float(cb.cy), cb.width, cb.height]
    for i in range(len(a)):
        fa, fb = a.frame(i), b.frame(i)
        assert fa.frame_id == fb.frame_id and fa.timestamp == fb.timestamp
        for name in ("rgb", "depth", "cam_T_world", "ht", "lt"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("maps", [True, False])
@pytest.mark.parametrize("extrinsics", [None, np.array(EXTR, np.float32).reshape(4, 4)], ids=["no-extr", "extr"])
def test_folder_written_by_jax_reads_as_in_jax(tmp_path, maps, extrinsics):
    frames = _frames(maps=maps, frame_cls=JaxFrame)
    jfolder.write_folder_dataset(str(tmp_path), frames, JaxCamera.create(60.0, 61.25, 31.5, 23.5, 64, 48),
                                 depth_factor=1000.0, extrinsics=extrinsics)
    _assert_folders_equal(tfolder.FolderReader(str(tmp_path)), jfolder.FolderReader(str(tmp_path)))


@pytest.mark.parametrize("maps", [True, False])
def test_folder_written_by_port_reads_as_in_jax(tmp_path, maps):
    extr = np.array(EXTR, np.float32).reshape(4, 4)
    tfolder.write_folder_dataset(str(tmp_path), _frames(maps=maps), PinholeCamera.create(60.0, 61.25, 31.5, 23.5, 64, 48),
                                 depth_factor=500.0, extrinsics=extr)
    with open(tmp_path / "camera_config.yaml") as f:
        text = f.read()
    assert yaml.safe_load(text) == {**CFG, "depthmap_factor": 500.0,
                                    "Extrinsics": [float(v) for v in extr.reshape(-1)]}
    port, jax_reader = tfolder.FolderReader(str(tmp_path)), jfolder.FolderReader(str(tmp_path))
    _assert_folders_equal(port, jax_reader)
    assert port.frame(0).ht is not None if maps else port.frame(0).ht is None


def _sens_frames(n=2, h=48, w=64, ch=None, cw=None, seed=0):
    rng = np.random.default_rng(seed)
    ch, cw = ch or h, cw or w
    yy, xx = np.mgrid[0:ch, 0:cw]
    rgbs = [np.stack([xx * 3 % 256, yy * 7 % 256, rng.integers(0, 256, (ch, cw))], -1).astype(np.uint8)
            for _ in range(n)]
    depths = [rng.integers(0, 6000, (h, w)).astype(np.uint16) for _ in range(n)]
    c2w = []
    for i in range(n):
        a = 0.3 * (i + 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.5 * i, -0.1, 1.2]
        c2w.append(m)
    k = np.array([[60.0, 0, 31.5], [0, 61.0, 23.5], [0, 0, 1]], np.float32)
    return rgbs, depths, c2w, k


def _assert_sens_equal(port, ref):
    assert len(port) == len(ref) and port.depth_factor == ref.depth_factor
    cp, cr = port.camera, ref.camera
    assert [cp.fx, cp.fy, cp.cx, cp.cy, cp.width, cp.height] == [
        float(cr.fx), float(cr.fy), float(cr.cx), float(cr.cy), cr.width, cr.height]
    for i in range(len(ref)):
        fp, fr = port.frame(i), ref.frame(i)
        assert fp.frame_id == fr.frame_id and fp.timestamp == fr.timestamp
        for name in ("rgb", "depth", "cam_T_world"):
            x, y = getattr(fp, name), getattr(fr, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("color,target", [
    ((48, 64), None),  # native size
    ((96, 128), None),  # colour twice the depth size, resized on read
    ((75, 100), None),  # colour of a non-integer ratio
    ((48, 64), (40, 30)),  # test_io_readers.py::test_sens_resize's target size, and smaller
], ids=["native", "colour-2x", "colour-ratio", "target-size"])
def test_sens_written_by_jax_reads_as_in_jax(tmp_path, color, target):
    rgbs, depths, c2w, k = _sens_frames(ch=color[0], cw=color[1])
    path = str(tmp_path / "scene.sens")
    jsens.write_sens(path, rgbs, depths, c2w, k, depth_shift=1000.0, color_compression=jsens.COLOR_PNG)
    port, ref = tsens.SensReader(path, target_size=target), jsens.SensReader(path, target_size=target)
    _assert_sens_equal(port, ref)
    port.close()
    ref.close()


@pytest.mark.parametrize("read", ["frame", "prefetch"])
@pytest.mark.parametrize("color", [(48, 64), (75, 100)], ids=["native", "colour-ratio"])
def test_png_sens_resizes_on_the_host(tmp_path, color, read):
    """PNG colour read on the CPU takes the host path: `sens.host_resizes`
    counts every frame whose colour is resized (from threads too, under
    `prefetch`), and the frames are the JAX reader's."""
    from ra_slam_tpu_torch.utils.profiling import TRACE

    rgbs, depths, c2w, k = _sens_frames(n=6, ch=color[0], cw=color[1])
    path = str(tmp_path / "scene.sens")
    jsens.write_sens(path, rgbs, depths, c2w, k, depth_shift=1000.0, color_compression=jsens.COLOR_PNG)
    port, ref = tsens.SensReader(path), jsens.SensReader(path)
    before = TRACE.counters()
    frames = list(port.prefetch(3, 2)) if read == "prefetch" else [port.frame(i) for i in range(len(port))]
    after = TRACE.counters()
    assert after["sens.host_resizes"] - before["sens.host_resizes"] == (0 if color == (48, 64) else 6)
    assert len(frames) == 6
    for i, fp in enumerate(frames):
        fr = ref.frame(i)
        for name in ("rgb", "depth", "cam_T_world"):
            np.testing.assert_array_equal(getattr(fp, name), getattr(fr, name), err_msg=name)
    port.close()
    ref.close()


def test_sens_written_by_port_reads_as_in_jax(tmp_path):
    rgbs, depths, c2w, k = _sens_frames(n=3, ch=75, cw=100)
    path = str(tmp_path / "scene.sens")
    tsens.write_sens(path, rgbs, depths, c2w, k, depth_shift=500.0, timestamps_us=[0, 40000, 90000])
    _assert_sens_equal(tsens.SensReader(path), jsens.SensReader(path))
    with pytest.raises(RuntimeError, match="no JPEG encoder on the CPU"):
        tsens.write_sens(path, rgbs, depths, c2w, k, color_compression=tsens.COLOR_JPEG, device="cpu")


def test_jpeg_sens_without_a_decoder_raises():
    """The committed JPEG fixture (written by the JAX `write_sens`, its
    cv2-decoded pixels beside it) reads its header, poses and depth; its
    colour needs nvjpeg on a CUDA device, and without one the reader
    raises and names what was probed."""
    path = os.path.join(DATA, "jpeg_64x48.sens")
    ref = jsens.SensReader(path)
    want = np.load(os.path.join(DATA, "jpeg_64x48_rgb.npy"))
    np.testing.assert_array_equal(want, np.stack([ref.frame(i).rgb for i in range(len(ref))]))
    port = tsens.SensReader(path)
    assert port.color_compression == tsens.COLOR_JPEG and len(port) == 2
    np.testing.assert_array_equal(port._raw_depth(1), ref._raw_depth(1))
    np.testing.assert_array_equal(port.pose(1), ref.pose(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no JPEG decoder.*probed turbojpeg"):
            port.frame(0)
    port.close()


def test_jpeg_encoder_planes_follow_libjpeg():
    """`rgb_to_ycbcr420`, the planes nvjpeg encodes: libjpeg's 16-bit
    fixed-point YCbCr (within one level of cv2's 14-bit conversion), the
    chroma halved per 2x2 block with libjpeg's alternating bias 1, 2,
    odd edges replicated."""
    import cv2

    from ra_slam_tpu_torch.io.jpeg import rgb_to_ycbcr420

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 51, 3), dtype=np.uint8)
    y, cb, cr = (p.numpy().astype(np.int64) for p in rgb_to_ycbcr420(torch.tensor(img)))
    ycc = cv2.cvtColor(img, cv2.COLOR_RGB2YCrCb).astype(np.int64)
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    np.testing.assert_array_equal(y, (19595 * r + 38470 * g + 7471 * b + 32768) >> 16)
    assert np.abs(y - ycc[..., 0]).max() <= 1
    full_cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    full_cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    assert np.abs(full_cr - ycc[..., 1]).max() <= 1 and np.abs(full_cb - ycc[..., 2]).max() <= 1
    for full, half in ((full_cb, cb), (full_cr, cr)):
        p = np.pad(full, ((0, 1), (0, 1)), mode="edge")
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        assert half.shape == (19, 26)
        np.testing.assert_array_equal(half, (s + 1 + (np.arange(26) & 1)) >> 2)
