"""Write seg_init_16_32_64.msgpack: the JAX package's initial parameters
of the (16, 32, 64)-width segmentation net, as `scripts/gen_semantic.py`
makes them before training (`SegmentationNet(widths=(16, 32, 64)).init(
PRNGKey(0), zeros((2, 256, 320, 3)))`), serialised with flax.

torch cannot reproduce JAX's random initialisation, so the PyTorch
port's trainer (`scripts/train_torch_semantic.py`) starts from this file.

    JAX_PLATFORMS=cpu python tests/data/make_seg_init.py
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from ra_slam_tpu.models.segmentation import SegmentationNet  # noqa: E402


def main():
    net = SegmentationNet(widths=(16, 32, 64))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, 256, 320, 3), jnp.float32))
    path = os.path.join(HERE, "seg_init_16_32_64.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))
    print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
