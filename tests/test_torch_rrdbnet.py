"""The port's RRDBNet (``models/rrdbnet.py``) against the JAX package on the
CPU: scales 4, 2 and 1 (pixel-unshuffle by 2 and 4 first), the JAX params
through ``convert/from_jax``, and ``tile_process`` on ragged tiles, where the
reflect padding is wider than the image (numpy's repeated reflection). Tiny
widths (16 features, 2 blocks, grow 8). Bound: f32, 1e-5 of max|JAX|."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.models import rrdbnet as jax_rrdbnet
from instarevive_tpu_torch.convert.from_jax import rrdbnet_params_to_torch
from instarevive_tpu_torch.models import rrdbnet

NET = dict(num_feat=16, num_block=2, num_grow=8)


def close(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _pair(scale, seed=0):
    jnet = jax_rrdbnet.RRDBNet(scale=scale, **NET)
    params = jnet.init(jax.random.key(seed), jnp.zeros((1, 16, 16, 3)))["params"]
    net = rrdbnet.RRDBNet(scale=scale, **NET).eval()
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         rrdbnet_params_to_torch(params, NET["num_block"]).items()})
    return jnet, params, net


@pytest.mark.parametrize("scale", [4, 2, 1])
def test_rrdbnet_matches_jax(scale):
    jnet, params, net = _pair(scale)
    x = np.random.default_rng(scale).uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 24 * scale, 20 * scale, 3)
    close(got, want)


@pytest.mark.parametrize("hw,tile,pad", [((24, 20), 16, 4), ((12, 9), 16, 10)], ids=["ragged", "pad_over_image"])
def test_tile_process_matches_jax(hw, tile, pad):
    jnet, params, net = _pair(4, seed=1)
    x = np.random.default_rng(5).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_rrdbnet.tile_process(lambda t: jnet.apply({"params": params}, t), jnp.asarray(x), 4,
                                               tile_size=tile, tile_pad=pad))
    with torch.no_grad():
        got = rrdbnet.tile_process(net, torch.from_numpy(x), 4, tile_size=tile, tile_pad=pad).numpy()
    assert got.shape == want.shape == (1, hw[0] * 4, hw[1] * 4, 3)
    close(got, want)


def test_rrdbnet_takes_the_official_names():
    names = set(rrdbnet.RRDBNet(scale=2, **NET).state_dict())
    assert {"conv_first.weight", "body.1.rdb3.conv5.bias", "conv_body.weight", "conv_up2.weight",
            "conv_hr.bias", "conv_last.weight"} <= names
    with pytest.raises(ValueError, match="scale"):
        rrdbnet.RRDBNet(scale=3)
