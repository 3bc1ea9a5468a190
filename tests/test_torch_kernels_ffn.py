"""Kernel K2 (fused FFN): the port's plain version against the reference.

espnet_slurp_tpu_torch/ops/kernels/ffn.py:fused_ffn on CPU tensors runs
fused_ffn_plain; it is held here to the Pallas kernel in interpret mode at
the shapes of tests/test_pallas_ffn.py, and to the flax FeedForward eager
path. The CUDA kernel itself is held to fused_ffn_plain on the card by
chip_smoke.py. fp32; tolerance atol 1e-5 / rtol 1e-4 (single op).
In bf16, fused_ffn_plain (the forward at the bf16 kernel's rounding points)
is held to the Pallas forward in bf16, and fused_ffn_bwd_plain, the backward
at the bf16 kernels' rounding points, to jax.vjp of the Pallas kernel in
bf16 and fp32.
At dropout 0.1 the plain versions take the keep mask explicitly: held to
the Pallas kernel in interpret mode with the mask of its own interpret draw
(threefry keyed by seed + row tile, ops/pallas/ffn.py:50-52), forward and
vjp in fp32 with the rate-0 tolerances; fused_ffn_bwd_plain with the mask
to the masked plain version's autograd; the CPU wrapper with a seed to the
kernels' Philox mask (ops/kernels/philox.py); FeedForward's kernel and
eager routes at dropout. At the fp32 route's widths (d_ff 2048) both plain
versions are held to jax.vjp of the reference's unfused composition with
the Philox mask. ``build.check_aligned``, which refuses an operand off a
16-byte boundary before any launch, at offsets of a contiguous view.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.conformer import FeedForward as JaxFeedForward
from espnet_slurp_tpu.ops.pallas.ffn import _hidden as jax_ffn_hidden
from espnet_slurp_tpu.ops.pallas.ffn import fused_ffn as jax_fused_ffn
from espnet_slurp_tpu_torch.models.conformer import FeedForward
from espnet_slurp_tpu_torch.ops.kernels import philox
from espnet_slurp_tpu_torch.ops.kernels import build
from espnet_slurp_tpu_torch.ops.kernels.ffn import (fused_ffn,
                                                     fused_ffn_bwd_plain,
                                                     fused_ffn_plain)
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t

B, T, D, F = 2, 128, 256, 512


def _inputs(seed=0, t_len=T):
    r = np.random.RandomState(seed)
    return (r.randn(B, t_len, D).astype(np.float32) * 0.5,
            (r.randn(D, F) / np.sqrt(D)).astype(np.float32),
            (r.randn(F) * 0.1).astype(np.float32),
            (r.randn(F, D) / np.sqrt(F)).astype(np.float32),
            (r.randn(D) * 0.1).astype(np.float32))


def test_plain_matches_pallas_interpret():
    args = _inputs()
    ref = jax_fused_ffn(*map(jnp.asarray, args), interpret=True)
    out = fused_ffn_plain(*map(t, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_wrapper_on_cpu_is_plain_and_not_counted():
    args = tuple(map(t, _inputs(seed=1)))
    before = fused_ffn.launches
    out = fused_ffn(*args)
    assert fused_ffn.launches == before
    torch.testing.assert_close(out, fused_ffn_plain(*args), atol=0, rtol=0)


@pytest.mark.parametrize("use_flash", [True, False])
def test_feedforward_matches_flax_eager(use_flash):
    x = np.random.RandomState(7).randn(B, 100, D).astype(np.float32)
    ff = JaxFeedForward(D, F, use_flash=False)
    params = ff.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = ff.apply({"params": params}, jnp.asarray(x))
    mod = FeedForward(D, F, use_flash=use_flash)
    mod.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = mod(t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_bf16_plain_rounds_hidden_like_the_kernel():
    x, w1, b1, w2, b2 = map(t, _inputs(seed=2))
    bf = torch.bfloat16
    out = fused_ffn(x.to(bf), w1.to(bf), b1, w2.to(bf), b2)
    assert out.dtype == bf
    ref = fused_ffn_plain(x, w1, b1, w2, b2)
    torch.testing.assert_close(out.float(), ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("seed,t_len", [(8, T), (9, 192)])
def test_bf16_plain_matches_pallas_forward(seed, t_len):
    """fused_ffn_plain in bf16 against the Pallas forward (its _fwd_kernel,
    interpret mode) in bf16 on the same bf16 inputs, N = 256 and 384 rows.
    Both round hd to bf16 before the second product and the output after
    b2, with fp32 accumulation; what differs is the fp32 summation order,
    which can flip a rounding of hd or of the output by one unit in the
    last place (2^-8 to 2^-7 of the value): tol 2^-7 of max |ref|."""
    x, w1, b1, w2, b2 = _inputs(seed=seed, t_len=t_len)
    bf = jnp.bfloat16
    jargs = (jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(b1),
             jnp.asarray(w2, bf), jnp.asarray(b2))
    ref = np.asarray(jax_fused_ffn(*jargs, interpret=True).astype(
        jnp.float32))
    as_t = lambda a: t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    out = fused_ffn_plain(as_t(jargs[0]), as_t(jargs[1]), t(b1),
                          as_t(jargs[3]), t(b2))
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2.0 ** -7, f"{err:.3e}"


def test_rejects_bad_arguments():
    """Shapes, dtypes and layouts the kernel does not take, a dropout rate
    outside [0, 1) and a seed that is no int32 [1] tensor are refused."""
    x, w1, b1, w2, b2 = map(t, _inputs(seed=3))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError):
            fused_ffn(x, w1, b1, w2, b2, dropout_rate=rate)
    with pytest.raises(ValueError):
        fused_ffn(x, w1, b1, w2, b2, torch.zeros(1, dtype=torch.int64),
                  dropout_rate=0.1)
    with pytest.raises(ValueError):
        fused_ffn(x, w1.t(), b1, w2, b2)
    with pytest.raises(TypeError):
        fused_ffn(x, w1, b1.double(), w2, b2)
    with pytest.raises(ValueError):
        fused_ffn(x.transpose(0, 1), w1, b1, w2, b2)


def test_plain_gradients_match_pallas_interpret():
    """dx, dW1, db1, dW2, db2 of the plain version's autograd against
    jax.grad of the Pallas kernel (its _bwd_kernel) in interpret mode,
    N = 256 rows, fp32, rtol/atol 5e-4 as in tests/test_pallas_ffn.py."""
    args = _inputs(seed=4)
    cot = np.random.RandomState(5).randn(B, T, D).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jax_fused_ffn(*a, interpret=True)
                                      * cot), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    leaves = [t(a).requires_grad_(True) for a in args]
    (fused_ffn(*leaves) * t(cot)).sum().backward()
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_plain_matches_pallas_vjp(dtype):
    """fused_ffn_bwd_plain against jax.vjp of the Pallas kernel (its
    _bwd_kernel, interpret mode) at N = 256, D = 256, F = 512: dx, dW1,
    db1, dW2, db2 each within tol of its max |ref|. bf16: both sides round
    hd and ds to bf16 at the same points and return dx / dW in bf16, so what
    differs is the fp32 summation order, which can flip a rounding by one
    unit in the last place (2^-8 to 2^-7 of the value): tol 2^-7 = 7.8e-3.
    fp32: sums in another order, tol 1e-5."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, w1, b1, w2, b2 = _inputs(seed=6)
    cot = np.random.RandomState(7).randn(B, T, D).astype(np.float32)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1),
             jnp.asarray(w2, jdt), jnp.asarray(b2))
    _, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, interpret=True), *jargs)
    ref = vjp(jnp.asarray(cot, jdt))
    as_t = lambda a: t(np.asarray(jnp.asarray(a, jnp.float32))).to(tdt)
    out = fused_ffn_bwd_plain(as_t(jargs[0]), as_t(jargs[1]), t(b1),
                              as_t(jargs[3]), as_t(jnp.asarray(cot, jdt)))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), out, ref):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert a.dtype == (tdt if name in ("dx", "dw1", "dw2")
                           else torch.float32), name
        assert a.shape == r.shape, name
        err = np.abs(a.float().numpy() - r).max() / np.abs(r).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


RATE, SEED = 0.1, 1234


def _reference_keep(seed, n, f, d=D, block_rows=512):
    """The keep mask the reference's interpret mode draws
    (ops/pallas/ffn.py:_keep_mask): threefry bits keyed by seed + row tile
    over [tn, F] tiles, tn chosen as fused_ffn chooses it (:145-153)."""
    tn = block_rows
    if d * f >= 512 * 2048:
        tn = min(tn, 256)
    while tn > 128 and n % tn != 0:
        tn //= 2
    thresh = jnp.uint32(int(RATE * float(2 ** 32)))
    tiles = [jax.random.bits(jax.random.key(jnp.uint32(seed + i)), (tn, f),
                             jnp.uint32) >= thresh for i in range(n // tn)]
    return t(jnp.concatenate(tiles))


def test_plain_dropout_matches_pallas_interpret():
    """fused_ffn_plain at rate 0.1 with the reference's interpret mask
    against the Pallas kernel in interpret mode, N = 768 rows in three row
    tiles of 256: the output and every gradient of the vjp, fp32, with the
    rate-0 tests' tolerances (atol 1e-5 / rtol 1e-4; 5e-4)."""
    args = _inputs(seed=10, t_len=384)
    n = B * 384
    keep = _reference_keep(SEED, n, F)
    assert 0.85 < float(keep.float().mean()) < 0.95
    cot = np.random.RandomState(11).randn(B, 384, D).astype(np.float32)
    seed = jnp.asarray([SEED], jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_fused_ffn(
        *a, seed, dropout_rate=RATE, interpret=True), *map(jnp.asarray, args))
    ref_grads = vjp(jnp.asarray(cot))
    leaves = [t(a).requires_grad_(True) for a in args]
    out = fused_ffn_plain(*leaves, dropout_rate=RATE, keep=keep)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)
    (out * t(cot)).sum().backward()
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), leaves,
                          ref_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_dropout_matches_masked_autograd(dtype):
    """fused_ffn_bwd_plain at rate 0.1 (the kernels' Philox mask of a seed)
    against autograd of fused_ffn_plain with the same mask: fp32 within
    1e-5 of max |ref| (sums in another order); bf16, where both round the
    hidden to bf16 but autograd differentiates through the unrounded ds,
    within 2^-7."""
    tdt = getattr(torch, dtype)
    x, w1, b1, w2, b2 = map(t, _inputs(seed=12))
    x, w1, w2 = x.to(tdt), w1.to(tdt), w2.to(tdt)
    g = t(np.random.RandomState(13).randn(B, T, D).astype(np.float32)).to(tdt)
    seed = torch.tensor([SEED], dtype=torch.int32)
    got = fused_ffn_bwd_plain(x, w1, b1, w2, g, seed, dropout_rate=RATE)
    leaves = [a.clone().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    out = fused_ffn_plain(*leaves, seed, dropout_rate=RATE)
    out.backward(g)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got, leaves):
        r = r.grad.float()
        err = float((a.float() - r).abs().max() / r.abs().max())
        assert err <= tol, f"{name}: {err:.3e}"
    # The mask reaches every gradient: a zero mask leaves only the biases'.
    none = torch.zeros(B * T, F, dtype=torch.bool)
    dx, dw1, db1, dw2, db2 = fused_ffn_bwd_plain(x, w1, b1, w2, g,
                                                 dropout_rate=RATE, keep=none)
    assert float(dx.abs().max()) == float(dw2.abs().max()) == 0.0
    assert float(db2.abs().max()) > 0.0


def test_wrapper_on_cpu_drops_with_the_kernels_mask():
    """On the CPU fused_ffn(.., seed, dropout_rate) is fused_ffn_plain with
    the Philox mask of (seed, row, column); another seed moves the output,
    rate 0 ignores the seed, and about 10% of the hidden is dropped."""
    x, w1, b1, w2, b2 = map(t, _inputs(seed=14))
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = fused_ffn(x, w1, b1, w2, b2, seed, dropout_rate=RATE)
    keep = philox.keep_mask(seed, RATE, B * T, F)
    torch.testing.assert_close(out, fused_ffn_plain(
        x, w1, b1, w2, b2, dropout_rate=RATE, keep=keep), atol=0, rtol=0)
    other = fused_ffn(x, w1, b1, w2, b2, seed + 1, dropout_rate=RATE)
    assert not torch.equal(out, other)
    torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2, seed),
                               fused_ffn_plain(x, w1, b1, w2, b2), atol=0,
                               rtol=0)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01


@pytest.mark.parametrize("use_flash", [True, False])
def test_feedforward_dropout_routes(use_flash):
    """FeedForward at rate 0.1: with train and a generator, the kernel route
    draws one seed from the generator and equals fused_ffn with it; the
    eager route drops the silu hidden with torch.rand from the generator
    (flax's nn.Dropout). Without train both equal the rate-0 module."""
    x = t(np.random.RandomState(15).randn(B, 40, D).astype(np.float32))
    mod = FeedForward(D, F, use_flash=use_flash, dropout_rate=RATE)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    with torch.no_grad():
        out = mod(x, train=True, generator=g1)
        w = lambda lin: lin.weight.t().contiguous()
        if use_flash:
            seed = philox.draw_seed(g2, x.device)
            ref = fused_ffn(x, w(mod.w1), mod.w1.bias, w(mod.w2),
                            mod.w2.bias, seed, dropout_rate=RATE)
        else:
            h = torch.nn.functional.silu(mod.w1(x))
            keep = torch.rand(h.shape, generator=g2) >= RATE
            ref = mod.w2(torch.where(keep, h / (1 - RATE), 0.0))
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
        plain = FeedForward(D, F, use_flash=use_flash)
        plain.load_state_dict(mod.state_dict())
        torch.testing.assert_close(mod(x), plain(x), atol=0, rtol=0)
        assert not torch.allclose(out, plain(x))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_plain_at_the_fp32_route_widths_matches_an_unfused_composition(
        direction):
    """fused_ffn_plain (forward) and fused_ffn_bwd_plain (backward) at the
    widths the default ASRConfig gives K2's fp32 launches (D 256, d_ff
    2048), rate 0.1, against jax.vjp of the reference's unfused composition
    (ops/pallas/ffn.py:_hidden, swish, the Philox mask of the same seed from
    philox.keep_mask with kept entries scaled by 1 / (1 - rate), then
    @ W2 + b2), fp32: every output within 1e-5 of max |ref|. The card test
    holds the fp32 kernels to these plain versions."""
    n, d, f = 48, 256, 2048
    rng = np.random.RandomState(16)
    args = (rng.randn(n, d).astype(np.float32) * 0.5,
            (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
            (rng.randn(f) * 0.1).astype(np.float32),
            (rng.randn(f, d) / np.sqrt(f)).astype(np.float32),
            (rng.randn(d) * 0.1).astype(np.float32))
    g = rng.randn(n, d).astype(np.float32)
    seed = torch.tensor([SEED], dtype=torch.int32)
    keep = philox.keep_mask(seed, RATE, n, f)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    jkeep = jnp.asarray(keep.numpy())

    def unfused(x, w1, b1, w2, b2):
        hs, sig = jax_ffn_hidden(x, w1, b1[None])
        h = jnp.where(jkeep, hs * sig / (1.0 - RATE), 0.0)
        return h @ w2 + b2

    ref, vjp = jax.vjp(unfused, *map(jnp.asarray, args))
    x, w1, b1, w2, b2 = map(t, args)
    if direction == "fwd":
        got = (fused_ffn_plain(x, w1, b1, w2, b2, seed, dropout_rate=RATE),)
        refs = (ref,)
    else:
        got = fused_ffn_bwd_plain(x, w1, b1, w2, t(g), seed,
                                  dropout_rate=RATE)
        refs = vjp(jnp.asarray(g))
    for i, (a, r) in enumerate(zip(got, refs)):
        r = np.asarray(r)
        err = float(np.abs(a.numpy() - r).max() / np.abs(r).max())
        assert err <= 1e-5, f"output {i}: {err:.3e}"


@pytest.mark.parametrize("offset,refused", [
    (0, False), (1, True), (2, True), (3, True), (4, False), (6, True)])
def test_check_aligned_refuses_views_off_16_bytes(offset, refused):
    """build.check_aligned, which every K2 launch's operands pass (the
    backward's cotangent g too): a contiguous fp32 view that starts
    ``offset`` floats into its storage is refused unless it starts on a
    16-byte boundary."""
    base = torch.zeros(64, 16)
    assert base.data_ptr() % 16 == 0
    view = base.view(-1)[offset:offset + 32 * 16].view(32, 16)
    assert view.is_contiguous()
    if refused:
        with pytest.raises(ValueError, match="g must start on a 16-byte"):
            build.check_aligned("g", view)
    else:
        build.check_aligned("g", view)
