"""ORB features of the PyTorch port (ra_slam_tpu_torch/features/) against
the JAX package on the CPU: pyramid, blur, FAST, orientation and
descriptors. The JAX side runs op by op (see tests/torch_parity.py);
inputs cross as numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.features import fast as jfast
from ra_slam_tpu.features import orb as jorb
from ra_slam_tpu.features import pyramid as jpyr
from ra_slam_tpu_torch.core.config import FeatureConfig
from ra_slam_tpu_torch.features import fast as tfast
from ra_slam_tpu_torch.features import orb as torb
from ra_slam_tpu_torch.features import pyramid as tpyr
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

# resampled levels and the blur: the same float32 terms summed in another
# order (XLA's CPU dot and convolution vs torch's) -- at most 3 ulps of
# a 0..255 image (1 ulp = 1.5e-5 in [128, 256))
LEVEL_TOL = 6e-5
ANGLE_TOL = 1e-5  # rad: centroid moments summed in another order
FEAT_KW = dict(max_num_keypoints=300, num_levels=2)


@functools.lru_cache()
def _gray(kind: str) -> np.ndarray:
    """320x240 grayscale: a textured synthetic frame, or uniform noise
    (many corners)."""
    if kind == "noise":
        return (np.random.default_rng(3).random((240, 320)) * 255).astype(np.float32)
    spec = SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5, width=320, height=240)
    rgb = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005).frame(3).rgb
    with jax.disable_jit():
        return np.asarray(jpyr.rgb_to_gray(jnp.asarray(rgb, jnp.float32)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def test_rgb_to_gray_matches_jax():
    rgb = np.random.default_rng(0).integers(0, 256, (24, 32, 3)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jpyr.rgb_to_gray(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tpyr.rgb_to_gray(_t(rgb)).numpy(), ref)


@pytest.mark.parametrize("kind", ["noise", "frame"])
def test_pyramid_and_blur_match_jax(kind):
    # op by op: under jit, XLA's CPU backend computes the resampling
    # weights with fused multiply-adds and the levels move by up to 5e-4
    gray = _gray(kind)
    with jax.disable_jit():
        jl = [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(gray), 4, 1.2)]
        jb = np.asarray(jpyr.gaussian_blur(jnp.asarray(gray)))
    tl = [x.numpy() for x in tpyr.build_pyramid(_t(gray), 4, 1.2)]
    assert [x.shape for x in tl] == [x.shape for x in jl]
    np.testing.assert_array_equal(tl[0], jl[0])
    for a, b in zip(jl[1:], tl[1:]):
        assert np.abs(a - b).max() <= LEVEL_TOL
    assert np.abs(tpyr.gaussian_blur(_t(gray)).numpy() - jb).max() <= LEVEL_TOL


def test_resample_weights_equal_jax():
    """The resampling weights of every level of every pyramid the port
    builds (640x480 and 672x376 at 8 levels, 320x240 at 4) equal
    `jax.image.resize`'s exactly: their column sums run in XLA's CPU
    order, blocks of 32 rows, the first and the last sharing the rest
    where 32 does not divide the rows. (Summed in turn, 12 of the 341,120
    weights at 640 -> 533 were an ulp off; in blocks of 32 from row 0, up
    to 65 weights of a matrix at 376 rows and 20 at 240.)"""
    from jax._src.image import scale

    for W, H, levels in ((640, 480, 8), (672, 376, 8), (320, 240, 4)):
        for h, w in tpyr.pyramid_shapes(H, W, levels, 1.2)[1:]:
            for i, o in ((H, h), (W, w)):
                with jax.disable_jit():
                    ref = np.asarray(scale.compute_weight_mat(
                        i, o, o / i, 0.0, scale._kernels[scale.ResizeMethod.LINEAR], True))
                np.testing.assert_array_equal(tpyr._weight_mat(i, o), ref, err_msg=f"{i} -> {o}")


def test_vga_pyramid_follows_xla_sums():
    """A VGA frame of the EVAL scene: every level, and its blur, bit-equal
    to the JAX package's op by op (XLA's CPU dot sums each output in fused
    multiply-add chains, split where it splits the contracted axis; its
    convolution adds the blur's products in pairs; an ulp off moves a
    blurred pixel across a bf16 rounding boundary that BRIEF reads). Two
    float32 matrix products left 10-35% of each level an ulp off, and the
    blur summed tap by tap half of each level."""
    spec = SyntheticCameraSpec(fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480)
    rgb = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, clutter=6).frame(20).rgb
    with jax.disable_jit():
        gray = jpyr.rgb_to_gray(jnp.asarray(rgb, jnp.float32))
        jl = [np.asarray(x) for x in jpyr.build_pyramid(gray, 4, 1.2)]
        jb = [np.asarray(jpyr.gaussian_blur(jnp.asarray(x))) for x in jl]
    tl = [x.numpy() for x in tpyr.build_pyramid(_t(np.asarray(gray)), 4, 1.2)]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tl, jb):
        np.testing.assert_array_equal(tpyr.gaussian_blur(_t(a)).numpy(), b)


def test_pyramid_320x240_follows_xla_sums():
    """The parity tests' 320x240 pyramid at 4 levels, on noise and a frame
    of the EVAL scene: every level and its blur bit-equal to the JAX
    package's op by op (tests/test_torch_pyramid_shapes.py)."""
    from test_torch_pyramid_shapes import check_pyramid

    check_pyramid(320, 240, 4)


@pytest.mark.parametrize("cell,min_t,k", [(32, 7.0, 200), (0, 7.0, 150), (32, 0.0, 300), (16, 7.0, 64)])
def test_fast_matches_jax_exactly(cell, min_t, k):
    """Same image in: score map, corners, subpixel uv and the valid mask
    equal JAX's exactly (ties in the selection included)."""
    for kind in ("noise", "frame"):
        img = _gray(kind)[:120, :150]
        with jax.disable_jit():
            js = np.asarray(jfast.fast_score(jnp.asarray(img), 20.0))
            juv, jsc, jv = (np.asarray(a) for a in jfast.fast_corners(jnp.asarray(img), 20.0, k, min_t, cell))
        np.testing.assert_array_equal(tfast.fast_score(_t(img), 20.0).numpy(), js)
        tuv, tsc, tv = (a.numpy() for a in tfast.fast_corners(_t(img), 20.0, k, min_t, cell))
        np.testing.assert_array_equal(tuv, juv)
        np.testing.assert_array_equal(tsc, jsc)
        np.testing.assert_array_equal(tv, jv)
        assert jv.any()


def _bits_differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.bitwise_xor(a.view(np.uint32), b.view(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def test_reference_patch_features_equal_direct_read():
    """Pins the reference: JAX's tile-atlas `_patch_features` gives what
    `orientation`/`orb_descriptors` give on the blurred image rounded to
    bf16 -- the direct read the port makes."""
    gray = jnp.asarray(_gray("noise"))
    with jax.disable_jit():
        uv, _, valid = jfast.fast_corners(gray, 20.0, 200, 7.0, 32)
        blur = jpyr.gaussian_blur(gray)
        ang, desc = jorb._patch_features(blur, uv)
        bf = blur.astype(jnp.bfloat16).astype(jnp.float32)
        ang2 = jorb.orientation(bf, uv)
        desc2 = jorb.orb_descriptors(bf, uv, ang)
    valid = np.asarray(valid)
    assert valid.sum() > 100
    assert np.abs(np.asarray(ang) - np.asarray(ang2))[valid].max() <= ANGLE_TOL
    np.testing.assert_array_equal(np.asarray(desc)[valid], np.asarray(desc2)[valid])


def test_patch_features_match_jax():
    """Same blurred image and keypoints in: angles within ANGLE_TOL, and
    every valid keypoint's 256 bits equal (a descriptor may differ only
    where a rotated sample rounds to another pixel: none here)."""
    gray = jnp.asarray(_gray("noise"))
    with jax.disable_jit():
        uv, _, valid = jfast.fast_corners(gray, 20.0, 200, 7.0, 32)
        blur = jpyr.gaussian_blur(gray)
        ang, desc = jorb._patch_features(blur, uv)
    ta, td = torb._patch_features(_t(blur), _t(uv))
    valid = np.asarray(valid)
    assert np.abs(ta.numpy() - np.asarray(ang))[valid].max() <= ANGLE_TOL
    diff = _bits_differ(td.numpy(), np.asarray(desc))[valid]
    assert (diff == 0).all(), diff


@pytest.mark.parametrize("kind", ["noise", "frame"])
def test_detect_and_describe_matches_jax(kind):
    """The whole ORB pipeline on one image. Level 0 (no resampling):
    corners exact. Level 1 reads a resampled level that differs by ulps
    (LEVEL_TOL), so its subpixel uv and scores agree to 1e-3 px / 1e-3.
    Descriptors: at least 99% of valid keypoints bit-equal, none more
    than 8 bits apart."""
    gray = _gray(kind)
    with jax.disable_jit():
        kj = jorb.detect_and_describe(jnp.asarray(gray), JaxFeatureConfig(**FEAT_KW))
    kt = torb.detect_and_describe(_t(gray), FeatureConfig(**FEAT_KW))
    assert kt.capacity == jorb.keypoint_capacity(JaxFeatureConfig(**FEAT_KW))
    np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    l0 = kt.level.numpy() == 0
    np.testing.assert_array_equal(kt.uv.numpy()[l0], np.asarray(kj.uv)[l0])
    np.testing.assert_array_equal(kt.score.numpy()[l0], np.asarray(kj.score)[l0])
    assert np.abs(kt.uv.numpy() - np.asarray(kj.uv)).max() <= 1e-3
    assert np.abs(kt.score.numpy() - np.asarray(kj.score)).max() <= 1e-3
    v = np.asarray(kj.valid)
    assert v.sum() >= 50
    assert np.abs(kt.angle.numpy() - np.asarray(kj.angle))[v].max() <= 1e-3
    diff = _bits_differ(kt.desc.numpy(), np.asarray(kj.desc))[v]
    assert (diff == 0).mean() >= 0.99 and diff.max() <= 8, diff


def test_detect_and_describe_rgb_matches_jax():
    """The colour entry point: grey conversion, then the same ORB (the
    bounds of test_detect_and_describe_matches_jax)."""
    spec = SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5, width=320, height=240)
    rgb = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005).frame(5).rgb
    with jax.disable_jit():
        kj = jorb.detect_and_describe_rgb(jnp.asarray(rgb, jnp.float32), JaxFeatureConfig(**FEAT_KW))
    kt = torb.detect_and_describe_rgb(_t(np.asarray(rgb, np.float32)), FeatureConfig(**FEAT_KW))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    l0 = kt.level.numpy() == 0
    np.testing.assert_array_equal(kt.uv.numpy()[l0], np.asarray(kj.uv)[l0])
    assert np.abs(kt.uv.numpy() - np.asarray(kj.uv)).max() <= 1e-3
    v = np.asarray(kj.valid)
    assert v.sum() >= 50
    diff = _bits_differ(kt.desc.numpy(), np.asarray(kj.desc))[v]
    assert (diff == 0).mean() >= 0.99 and diff.max() <= 8, diff


def test_pack_bits_matches_jax_words():
    bits = np.random.default_rng(5).random((7, 256)) < 0.5
    shifts = (np.arange(256) % 32).astype(np.uint64)
    ref = (bits.astype(np.uint64) << shifts).reshape(7, 8, 32).sum(axis=2).astype(np.uint32)
    np.testing.assert_array_equal(torb.pack_bits(_t(bits)).numpy().view(np.uint32), ref)


def test_level_quotas_match_jax():
    for kw in (FEAT_KW, {}, dict(max_num_keypoints=600, num_levels=4)):
        assert torb.level_quotas(FeatureConfig(**kw)) == jorb.level_quotas(JaxFeatureConfig(**kw))
    np.testing.assert_array_equal(torb._pattern(), jorb._pattern())


def test_detect_never_captures_on_cpu():
    """On the CPU `detect_and_describe` runs the eager body: no graph is
    captured or replayed, and it returns what the body returns."""
    before = (torb.GRAPH_CAPTURES, torb.GRAPH_REPLAYS, len(torb._GRAPHS))
    gray, cfg = _t(_gray("frame")), FeatureConfig(**FEAT_KW)
    a, b = torb.detect_and_describe(gray, cfg), torb._detect(gray, cfg)
    assert (torb.GRAPH_CAPTURES, torb.GRAPH_REPLAYS, len(torb._GRAPHS)) == before == (0, 0, 0)
    for k in ("uv", "level", "score", "angle", "desc", "valid"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_patch_constants_uploaded_once():
    """The BRIEF pattern and the centroid offsets are uploaded once a
    device: repeated calls and detections reuse the same tensors, which
    hold `_pattern()` / `_centroid_offsets()`."""
    cpu = torch.device("cpu")
    pat, offs = torb._device_pattern(cpu), torb._device_centroid_offsets(cpu)
    misses = (torb._device_pattern.cache_info().misses, torb._device_centroid_offsets.cache_info().misses)
    torb.detect_and_describe(_t(_gray("noise")), FeatureConfig(**FEAT_KW))
    assert torb._device_pattern(cpu) is pat and torb._device_centroid_offsets(cpu) is offs
    assert (torb._device_pattern.cache_info().misses, torb._device_centroid_offsets.cache_info().misses) == misses
    assert pat.dtype == torch.float32
    np.testing.assert_array_equal(pat.numpy(), torb._pattern().astype(np.float32))
    for t, a in zip(offs, torb._centroid_offsets()):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)
