"""The segmentation UNet of the PyTorch port
(ra_slam_tpu_torch/models/segmentation.py) against the flax net on the
CPU, and its flax-msgpack checkpoints (utils/flax_msgpack.py,
utils/convert.py) against flax's serialization.

Bounds. With float32 compute on both sides the nets compute the same
function: logits within 1e-4 (measured 8.6e-6). With bf16 compute (the
default) the convolutions round their outputs to bf16 after summing in
different orders, so the committed weights on two held-out frames
(256x320, seed 3) are held to measured bounds: logits max 0.2 and mean
0.01 (measured 0.061 / 0.0041), the high-touch probability max 0.06
(0.019), and at most 1e-3 of the prob > 0.5 decisions flipped (8 of
153,600). The JAX side runs op by op (`jax.disable_jit()`)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.models import segmentation as jseg
from ra_slam_tpu_torch.models import segmentation as tseg
from ra_slam_tpu_torch.utils.convert import seg_state_dict_from_flax, seg_state_dict_to_flax
from ra_slam_tpu_torch.utils.flax_msgpack import MsgpackError, packb, unpackb

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "ra_slam_tpu", "models", "demo_seg.msgpack")
DEMO_WIDTHS = (16, 32, 64)
F32_TOL = 1e-4
BF16_LOGIT_MAX, BF16_LOGIT_MEAN, BF16_PROB_MAX, BF16_FLIP_SHARE = 0.2, 0.01, 0.06, 1e-3


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _raw():
    with open(WEIGHTS, "rb") as f:
        return f.read()


def test_msgpack_reader_restores_demo_seg_leaf_for_leaf():
    raw = _raw()
    assert raw[:8] == b"\x81\xa6params"
    ours, flax_tree = unpackb(raw), serialization.msgpack_restore(raw)
    a, b = _leaves(ours), _leaves(flax_tree)
    assert len(a) == len(b) == 46
    for (pa, x), (pb, y) in zip(a, b):
        assert pa == pb and x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert packb(ours) == raw  # the writer gives flax's bytes back


def test_msgpack_scalars_and_errors():
    tree = {"i": [0, 127, 128, -1, -33, 70000, -70000, 2**40], "f": [1.5, -0.0], "s": "x" * 40,
            "b": b"yy", "n": None, "t": True, "a": np.arange(6, dtype=np.int32).reshape(2, 3)}
    back = serialization.msgpack_restore(packb(tree))
    assert back["i"] == tree["i"] and back["f"] == tree["f"] and back["s"] == tree["s"]
    assert back["b"] == b"yy" and back["n"] is None and back["t"] is True
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert unpackb(serialization.msgpack_serialize(back))["i"] == tree["i"]
    with pytest.raises(MsgpackError):
        unpackb(_raw()[:-3])
    with pytest.raises(MsgpackError):
        unpackb(b"\xc1")


def test_port_checkpoint_restored_by_flax(tmp_path):
    """`InferenceEngine.save` writes what flax's `from_bytes` restores
    into a params tree of the JAX net's structure: every leaf equal
    (kernels back to HWIO)."""
    eng = tseg.InferenceEngine("__random__", 64, 48, widths=DEMO_WIDTHS, device="cpu")
    path = str(tmp_path / "seg.msgpack")
    eng.save(path)
    with open(path, "rb") as f:
        restored = serialization.from_bytes(serialization.msgpack_restore(_raw()), f.read())
    sd = eng.net.state_dict()
    mine = seg_state_dict_to_flax(sd, eng.net)
    assert len(_leaves(mine)) == len(_leaves(restored)) == 46
    for (pa, x), (pb, y) in zip(_leaves(mine), _leaves(restored)):
        assert pa == pb and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    back = seg_state_dict_from_flax(unpackb(open(path, "rb").read()), eng.net)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_random_init_follows_flax_initialisers():
    """lecun_normal kernels (variance 1 / fan_in), zero biases, GroupNorm
    scale 1 and bias 0; the same weights from the same seed."""
    a = tseg.InferenceEngine("__random__", 64, 48, device="cpu").net.state_dict()
    b = tseg.InferenceEngine("__random__", 64, 48, device="cpu").net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["up_blocks.0.convs.0.weight"]  # 256 -> 128, fan_in 256 * 9
    assert abs(float(w.std()) * np.sqrt(256 * 9) - 1.0) < 0.02 and float(w.abs().max()) <= 2.0 / np.sqrt(256 * 9) / 0.8796 + 1e-6
    assert all(float(a[k].abs().max()) == 0 for k in a if k.endswith("bias"))
    assert all(torch.equal(a[k], torch.ones_like(a[k])) for k in a if ".norms." in k and k.endswith("weight"))


def test_unet_float32_matches_flax():
    """widths (8, 16), 64x96, float32 compute on both sides, the same
    carried (perturbed) weights: logits within 1e-4."""
    rng = np.random.default_rng(0)
    jn = jseg.SegmentationNet(widths=(8, 16), dtype=jnp.float32)
    x = rng.random((1, 64, 96, 3)).astype(np.float32)
    params = jn.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 3)))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32), params)
    with jax.disable_jit():
        want = np.asarray(jn.apply(params, x))
    tn = tseg.SegmentationNet((8, 16), dtype=torch.float32)
    tn.load_state_dict(seg_state_dict_from_flax(params, tn))
    with torch.no_grad():
        got = tn(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 96, 2)
    assert np.abs(got - want).max() <= F32_TOL


def _held_out(n=2):
    ds = SyntheticBoxDataset(num_frames=16, cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                                                                     width=320, height=240),
                             radius=1.0, seed=3, clutter=4)
    return [ds.frame(i).rgb for i in range(n)]


def test_unet_bf16_committed_weights_match_flax():
    tree = serialization.msgpack_restore(_raw())
    x = np.zeros((2, 256, 320, 3), np.float32)
    for k, rgb in enumerate(_held_out()):
        x[k, :240] = rgb.astype(np.float32) / 255.0
    with jax.disable_jit():
        lj = np.asarray(jseg.SegmentationNet(widths=DEMO_WIDTHS).apply(tree, x))[:, :240]
    tn = tseg.SegmentationNet(DEMO_WIDTHS)
    tn.load_state_dict(seg_state_dict_from_flax(unpackb(_raw()), tn))
    with torch.no_grad():
        lt = tn(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()[:, :240]
    pj = np.asarray(jax.nn.softmax(lj, axis=-1))[..., 0]
    pt = torch.softmax(torch.as_tensor(lt), dim=-1).numpy()[..., 0]
    d = np.abs(lj - lt)
    assert d.max() <= BF16_LOGIT_MAX and d.mean() <= BF16_LOGIT_MEAN, (d.max(), d.mean())
    assert np.abs(pj - pt).max() <= BF16_PROB_MAX
    assert ((pj > 0.5) != (pt > 0.5)).mean() <= BF16_FLIP_SHARE
    assert ((pj > 0.5) == (pt > 0.5)).mean() > 0.99 and (pj > 0.5).mean() > 0.05  # a real, confident net


def test_infer_one_pads_crops_and_resizes_back_like_jax():
    """A 35x50 frame into engines of size 64x48: padded to 64x64, softmax,
    cropped, resized back with INTER_LINEAR; float32 numpy out, within
    the bf16 bounds."""
    rgb = _held_out(1)[0][100:135, 140:190]
    # the JAX engine as its constructor builds it from this checkpoint,
    # without the eager `init` whose values `from_bytes` replaces
    jeng = jseg.InferenceEngine(None, width=64, height=48)
    jeng.fake, jeng.net, jeng.params = False, jseg.SegmentationNet(widths=DEMO_WIDTHS), serialization.msgpack_restore(_raw())
    jeng._forward = jax.jit(functools.partial(jeng._apply, net=jeng.net))
    teng = tseg.InferenceEngine(WEIGHTS, width=64, height=48, widths=DEMO_WIDTHS, device="cpu")
    with jax.disable_jit():
        jht, jlt = jeng.infer_one(rgb)
    tht, tlt = teng.infer_one(rgb)
    for j, t in ((jht, tht), (jlt, tlt)):
        assert t.dtype == np.float32 and t.shape == j.shape == (48, 64)
        assert np.abs(j - t).max() <= BF16_PROB_MAX
        assert ((j > 0.5) != (t > 0.5)).mean() <= 10 * BF16_FLIP_SHARE  # 3072 pixels: a few flips at most
    np.testing.assert_allclose(tht + tlt, 1.0, atol=1e-6)


def test_fake_mode_and_width_mismatch_like_jax():
    rgb = np.zeros((30, 40, 3), np.uint8)
    j = jseg.InferenceEngine(None, width=40, height=30).infer_one(rgb)
    t = tseg.InferenceEngine(None, width=40, height=30, device="cpu").infer_one(rgb)
    for a, b in zip(j, t):
        assert b.dtype == np.float32 and b.shape == (30, 40)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no parameters"):
        tseg.InferenceEngine(None, device="cpu").save("unused")
    # demo_seg.msgpack is a (16, 32, 64) net: the default widths fail to
    # load it in both packages, naming the modules it lacks (the JAX
    # engine's own call, `from_bytes` into the default net's params tree,
    # whose structure `eval_shape` gives without initialising it)
    target = jax.eval_shape(lambda: jseg.SegmentationNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    with pytest.raises(ValueError, match="ConvBlock_5") as jerr:
        serialization.from_bytes(target, _raw())
    with pytest.raises(ValueError, match="ConvBlock_5") as terr:
        tseg.InferenceEngine(WEIGHTS, width=64, height=48, device="cpu")
    assert "not present in state dict" in str(jerr.value) and "not present in state dict" in str(terr.value)
    if not torch.cuda.is_available():  # the default device is cuda, with no move to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            tseg.InferenceEngine(None)


def test_forward_flops_and_latency_cli():
    # 58.3 GMAC at VGA, default widths, counted from the layer shapes
    assert tseg.forward_flops(tseg.DEFAULT_WIDTHS, 480, 640) == 116_647_526_400
    out = tseg._bench(["--iters", "2", "--width", "64", "--height", "48", "--device", "cpu"])
    assert out["metric"] == "segmentation_latency_ms" and out["backend"] == "cpu" and out["shape"] == [48, 64]
    assert set(out) == {"metric", "value", "fps", "iters", "shape", "backend"}
