"""SpecAugment: espnet_slurp_tpu_torch/ops/specaug.py against the reference.

The two sides draw from different generators (jax keys, torch.Generator),
so the same draws are fed to both: the warp centres and offsets to the
reference's _time_warp_one, and the mask widths and starts that the
reference's _mask_along_axis draws from its key (recomputed here with the
same key splits) to the port's mask_bands. fp32; the warp is held at atol
1e-6 (the same interpolation in another order), the masks exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu_torch.ops import specaug as tsa
from torch_parity import t

# the reference package's ops/__init__ exports a function of the same name
jsa = importlib.import_module("espnet_slurp_tpu.ops.specaug")

B, T, F = 3, 50, 16


def _feats(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T, F).astype(np.float32), np.asarray([50, 37, 12],
                                                             np.int32)


def test_time_warp_matches():
    x, lens = _feats()
    centers = np.asarray([20, 15, 5], np.int32)
    offsets = np.asarray([-4, 5, 0], np.int32)
    ref = jax.vmap(jsa._time_warp_one)(jnp.asarray(x), jnp.asarray(centers),
                                       jnp.asarray(offsets),
                                       jnp.asarray(lens))
    out = tsa.time_warp(t(x), t(centers).long(), t(offsets).long(), t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("axis,width_range,num", [(2, (0, 20), 2),
                                                   (1, (0, 40), 2),
                                                   (1, (3, 9), 3)])
def test_masks_match(axis, width_range, num):
    x, _ = _feats(1)
    key = jax.random.PRNGKey(7)
    length = x.shape[axis]
    ref = jsa._mask_along_axis(key, jnp.asarray(x), length, width_range, num,
                               axis)
    # The reference's draws, from the same key splits as _mask_along_axis.
    kw, ks = jax.random.split(key)
    widths = jax.random.randint(kw, (B, num, 1), width_range[0],
                                max(width_range[1], 1))
    bound = max(1, length - int(widths.max()))
    starts = jnp.floor(jax.random.uniform(ks, (B, num, 1)) * bound)
    out = tsa.mask_bands(t(x), t(np.asarray(starts)[..., 0]).long(),
                         t(np.asarray(widths)[..., 0]).long(), axis)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_draws_follow_the_reference_laws():
    gen = torch.Generator().manual_seed(0)
    lens = t(np.asarray([50, 37, 12], np.int32))
    centers, offsets = tsa.draw_time_warp(gen, lens, T, 5)
    assert ((centers >= 5) & (centers <= torch.clamp(lens - 6, min=5))).all()
    assert ((offsets >= -5) & (offsets <= 5)).all()
    starts, widths = tsa.draw_bands(gen, B, F, (0, 20), 2)
    assert ((widths >= 0) & (widths < 20)).all()
    assert ((starts >= 0) & (starts < max(1, F - int(widths.max())))).all()


def test_specaug_is_seeded_and_masks_padding():
    x, lens = _feats(2)
    cfg = tsa.SpecAugConfig()
    outs = [tsa.specaug(t(x), t(lens), cfg,
                        torch.Generator().manual_seed(3)) for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert outs[0].shape == (B, T, F)
    pad = np.arange(T)[None, :] >= lens[:, None]
    assert np.all(outs[0].numpy()[pad] == 0.0)
    assert not torch.equal(outs[0], t(x))
