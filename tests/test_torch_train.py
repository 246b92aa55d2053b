"""Segmentation training of the PyTorch port (ra_slam_tpu_torch/models/
segmentation.py `make_train_step`) against the JAX package's optax step
on the CPU (tests/test_torch_train_cli.py drives the trainer script).

The nets start from one flax init (PRNGKey(0)), carried into the port
with `seg_state_dict_from_flax`; the batch is made with numpy. The JAX
side runs op by op (`jax.disable_jit()`).

Bounds. Float32 compute: the loss within 1e-5 and every gradient within
1e-4 of its tensor's largest |g| (the same function summed in other
orders; measured 6e-8 and 4.7e-6). bf16 compute (the default): each
convolution rounds its output to bf16 after summing in its own order.
The bias of a conv that feeds a GroupNorm has a gradient that is a bf16
sum over 4096 pixels that mostly cancel (the norm removes the group's
mean), so those tensors are held to 0.5 of their largest |g| (measured
at most 0.395); every other tensor, the kernels included, to 0.15
(measured at most 0.084, on a kernel); the loss to 1e-3 (4.1e-5). Adam divides by sqrt(v) + 1e-8, so a gradient
that is analytically zero (the bias of a conv feeding a GroupNorm of one
channel per group, `features <= 8`) but holds float noise of ~1e-9 moves
its parameter by about +-lr whatever its sign: after three steps the
parameters are held within 1e-5 where |g| exceeds 1e-6 of its tensor's
largest, and within 2 * lr * steps elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads)
from ra_slam_tpu.models import segmentation as jseg
from ra_slam_tpu_torch.models import segmentation as tseg
from ra_slam_tpu_torch.utils.convert import seg_state_dict_from_flax

WIDTHS, N, H, W = (16, 32), 2, 32, 64
LR = 3e-4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((N, H, W, 3), dtype=np.float32)
    y = rng.integers(-1, 2, (N, H, W)).astype(np.int32)  # -1: unlabelled
    return x, y


def _jax_loss(net):
    # make_train_step's loss_fn (ra_slam_tpu/models/segmentation.py:157)
    def loss_fn(params, x, y):
        logits = net.apply(params, x)
        mask = (y >= 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.maximum(y, 0))
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)
    return loss_fn


def _nets(dtype):
    jnet = jseg.SegmentationNet(widths=WIDTHS, dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
    tnet = tseg.SegmentationNet(WIDTHS, dtype=dtype)
    tnet.load_state_dict(seg_state_dict_from_flax(jax.tree.map(np.asarray, params), tnet))
    return jnet, params, tnet


def _torch_xy(x, y):
    return torch.as_tensor(x).permute(0, 3, 1, 2).contiguous(), torch.as_tensor(y.astype(np.int64))


def _rel_grad_err(jnet, params, tnet, x, y):
    """(jax loss, port loss, {name: max |g_port - g_jax| / max |g_jax|})."""
    with jax.disable_jit():
        jl, jg = jax.value_and_grad(_jax_loss(jnet))(params, jnp.asarray(x), jnp.asarray(y))
    jg = seg_state_dict_from_flax(jax.tree.map(np.asarray, jg), tnet)
    xt, yt = _torch_xy(x, y)
    tl = tseg.masked_cross_entropy(tnet(xt), yt)
    tl.backward()
    tl = tl.item()
    errs = {}
    for name, p in tnet.named_parameters():
        g = jg[name].numpy()
        errs[name] = float(np.abs(p.grad.numpy() - g).max() / max(np.abs(g).max(), 1e-30))
    return float(jl), tl, errs


def _cancelling(name):
    """The bias of a conv that feeds a GroupNorm (`*.convs.<i>.bias`)."""
    return ".convs." in name and name.endswith(".bias")


@pytest.mark.parametrize("dtype,loss_tol,grad_tol,cancel_tol",
                         [(torch.float32, 1e-5, 1e-4, 1e-4), (torch.bfloat16, 1e-3, 0.15, 0.5)],
                         ids=["float32", "bf16"])
def test_one_step_gradients_match_jax(dtype, loss_tol, grad_tol, cancel_tol):
    jnet, params, tnet = _nets(dtype)
    x, y = _batch()
    jl, tl, errs = _rel_grad_err(jnet, params, tnet, x, y)
    assert abs(jl - tl) <= loss_tol, (jl, tl)
    assert any(map(_cancelling, errs)) and not all(map(_cancelling, errs))
    for name, err in errs.items():
        assert err <= (cancel_tol if _cancelling(name) else grad_tol), (name, err, errs)


def test_adam_steps_match_optax():
    """Three steps of `make_train_step` with torch.optim.Adam against the
    JAX package's `make_train_step` with optax.adam, float32: the losses
    step by step, then the parameters (see the module docstring)."""
    jnet, params, tnet = _nets(torch.float32)
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    jstep = jseg.make_train_step(jnet, opt)
    tstep = tseg.make_train_step(tnet, torch.optim.Adam(tnet.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8))
    steps, small = 3, {}
    for s in range(steps):
        x, y = _batch(s)
        with jax.disable_jit():
            jg = jax.grad(_jax_loss(jnet))(params, jnp.asarray(x), jnp.asarray(y))
            params, opt_state, jl = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        for name, g in seg_state_dict_from_flax(jax.tree.map(np.asarray, jg), tnet).items():
            g = g.numpy()
            small[name] = small.get(name, False) | (np.abs(g) <= 1e-6 * np.abs(g).max())
        tl = tstep(*_torch_xy(x, y))
        assert abs(float(jl) - float(tl)) <= 1e-5, (s, float(jl), float(tl))
    want = seg_state_dict_from_flax(jax.tree.map(np.asarray, params), tnet)
    for name, p in tnet.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d[~small[name]].max(initial=0.0) <= 1e-5, name
        assert d.max() <= 2 * LR * steps, name


def test_training_step_reduces_loss():
    """tests/test_segmentation.py:45 through the port: an (8, 16) net,
    Adam 1e-2, a left-bright / right-dark image; the loss halves within
    12 steps."""
    torch.manual_seed(0)
    net = tseg.SegmentationNet((8, 16))
    tseg.init_params_(net, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 3, 32, 32)
    x[..., :16] = 1.0
    y = torch.ones(1, 32, 32, dtype=torch.int64)
    y[..., :16] = 0
    step = tseg.make_train_step(net, torch.optim.Adam(net.parameters(), lr=1e-2))
    losses = [float(step(x, y)) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.5, losses
    assert all(p.grad is not None for p in net.parameters())


def test_masked_cross_entropy_ignores_unlabelled():
    logits = torch.tensor([[[[2.0, 0.0]], [[0.0, 5.0]]]])  # [1, 2, 1, 2]
    y = torch.tensor([[[0, -1]]])
    want = float(np.log1p(np.exp(-2.0)))
    assert abs(float(tseg.masked_cross_entropy(logits, y)) - want) < 1e-6
    assert float(tseg.masked_cross_entropy(logits, torch.full_like(y, -1))) == 0.0
