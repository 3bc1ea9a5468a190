"""K3 at a head width that is not a multiple of 16 (the KA2G recipe's
144-wide, 4-head encoder: Dh 36).

On the card the K3 wrapper runs such a Dh zero-padded to the next width of
a redesigned route (ops/kernels/flash_attention.py:kernel_head_width, 64
for Dh 36 in bf16 and fp32) through ``pad_heads``, with the scale of the
true Dh, and slices the output back. Here the same padding runs around the
plain versions: the padded forward (plain and tiled at the kernels'
rounding points) and backward equal the unpadded ones at Dh 36, in fp32
and bf16, at dropout 0 and 0.1 (the keep mask does not depend on Dh), and
the padded plain version is held to the reference's Pallas kernel in
interpret mode at Dh 36. The CUDA launches at Dh 36 are held to the plain
version on the card by chip_smoke.py (phase 22).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.ops.pallas.flash_attention import (
    rel_flash_attention as jax_rel_flash)
from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
import torch_parity  # noqa: F401  (each test worker's CPU threads)

B, H, T, DH = 2, 2, 40, 36
LENGTHS = np.asarray([40, 23], np.int32)
SEED = torch.tensor([1234], dtype=torch.int32)


def _data(dtype, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(
        (rng.randn(*s) * 0.5).astype(np.float32)).to(dtype)
    return [f(B, H, T, DH) for _ in range(4)] + [f(H, 2 * T, DH)], \
        f(B, H, T, DH)


def test_kernel_head_width():
    bf, f32 = torch.bfloat16, torch.float32
    assert fa.kernel_head_width(36, bf) == fa.kernel_head_width(36, f32) == 64
    assert [fa.kernel_head_width(d, f32) for d in (16, 20, 48, 72, 128)] \
        == [16, 32, 48, 128, 128]
    assert fa.kernel_head_width(24, bf) == 32
    for d, dt in ((72, bf), (136, f32), (36, torch.float16)):
        with pytest.raises(ValueError, match="no route takes"):
            fa.kernel_head_width(d, dt)


def _valid(x):
    x = x.detach().float().numpy()
    return np.concatenate([x[i, :, :LENGTHS[i]] for i in range(B)], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_padded_plain_equals_unpadded_both_ways(dtype, rate):
    args, g = _data(dtype)
    lens = torch.from_numpy(LENGTHS)
    kw = dict(scale=DH ** -0.5, dropout_rate=rate)
    seed = SEED if rate else None
    width = fa.kernel_head_width(DH, dtype)
    # the plain version and autograd
    outs, grads = [], []
    for padded in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in args]
        fn = lambda *x: fa.rel_flash_attention_plain(*x, lens, seed, **kw)
        out, lse = (fa.pad_heads(fn, *leaves, width) if padded
                    else fn(*leaves))
        assert out.shape == (B, H, T, DH)
        (out.float() * g.float()).sum().backward()
        outs.append((out.detach(), lse))
        grads.append([x.grad for x in leaves])
    tol = dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(_valid(a), _valid(b), **tol)
    for a, b in zip(grads[1], grads[0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   **tol)
    # the kernels' rounding points: tiled forward, backward
    fwd = lambda *x: fa.rel_flash_attention_fwd_tiled_plain(*x, lens, seed,
                                                            **kw)
    o0, l0 = fwd(*args)
    o1, l1 = fa.pad_heads(fwd, *args, width)
    np.testing.assert_allclose(_valid(o1), _valid(o0), **tol)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=1e-5, rtol=1e-5)
    pad = lambda x: torch.nn.functional.pad(x, (0, width - DH))
    b0 = fa.rel_flash_attention_bwd_plain(*args, lens, o0, l0, g, seed, **kw)
    b1 = fa.rel_flash_attention_bwd_plain(*map(pad, args), lens, pad(o0),
                                          l0, pad(g), seed, **kw)
    for a, b in zip(b1, b0):
        assert float(a[..., DH:].float().abs().max()) == 0.0
        np.testing.assert_allclose(a[..., :DH].float().numpy(),
                                   b.float().numpy(), **tol)


def test_padded_plain_matches_the_pallas_kernel_at_dh_36():
    args, _ = _data(torch.float32, seed=3)
    ref = jax_rel_flash(*(jnp.asarray(a.numpy()) for a in args),
                        jnp.asarray(LENGTHS), scale=DH ** -0.5,
                        interpret=True)
    out, _ = fa.pad_heads(
        lambda *x: fa.rel_flash_attention_plain(
            *x, torch.from_numpy(LENGTHS), scale=DH ** -0.5),
        *args, 64)
    np.testing.assert_allclose(_valid(out),
                               _valid(torch.from_numpy(np.array(ref))),
                               atol=1e-5, rtol=1e-4)
