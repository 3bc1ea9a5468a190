"""Kernel K3 (rel-pos flash attention) and the attention modules.

espnet_slurp_tpu_torch/ops/kernels/flash_attention.py on CPU tensors runs
rel_flash_attention_plain; it is held to the Pallas kernel in interpret mode
at the shapes and chunk settings of tests/test_flash_attention.py, valid
query rows only. RelPosMultiHeadAttention (both paths) and
MultiHeadAttention are held to their flax modules. The CUDA kernel is held
to the plain version on the card by chip_smoke.py. fp32; tolerance atol
1e-5 / rtol 1e-4. rel_flash_attention_bwd_plain, the backward at the
kernels' rounding points, is held to jax.vjp of the Pallas kernel in fp32
and bf16, and to the plain version's autograd; its forward counterpart
rel_flash_attention_fwd_tiled_plain to the Pallas forward in fp32 and bf16,
and to the plain version.
At dropout 0.1 (the reference's K3 mask has no CPU path,
ops/pallas/flash_attention.py:110-115) the masked plain version is held to
jax.vjp of the reference's eager rel-pos composition (models/attention.py:
rel_shift) with the same mask on the softmax, and the masked backward and
tiled forward to the plain version's autograd, fully masked rows included,
at Dh 16 and at the WMMA routes' shapes (fp32 Dh 64, bf16 Dh 128); the
modules' kernel and eager routes draw from the generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import attention as jatt
from espnet_slurp_tpu.ops.pallas.flash_attention import (
    rel_flash_attention as jax_rel_flash)
from espnet_slurp_tpu_torch.models import attention as tatt
from espnet_slurp_tpu_torch.ops.kernels import philox
from espnet_slurp_tpu_torch.ops.kernels.flash_attention import (
    allowed_mask, rel_flash_attention, rel_flash_attention_bwd_plain,
    rel_flash_attention_fwd, rel_flash_attention_fwd_tiled_plain,
    rel_flash_attention_plain)
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t

NEG = -1e30

B, H, T, DH = 2, 2, 256, 32
SCALE = 1.0 / np.sqrt(DH)
LENGTHS = np.asarray([T, 190], np.int32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
    qu, qv, k, v = (f(B, H, T, DH) for _ in range(4))
    p = f(H, 2 * T, DH)
    p[:, -1] = 0.0
    return qu, qv, k, v, p


def _valid_rows(x, lengths=LENGTHS):
    m = (np.arange(T)[None, :] < lengths[:, None])[:, None, :, None]
    return np.where(m, np.asarray(x), 0.0)


@pytest.mark.parametrize("chunk", [(0, -1), (64, -1), (64, 1)])
def test_plain_matches_pallas_interpret(data, chunk):
    cs, lc = chunk
    ref = jax_rel_flash(*map(jnp.asarray, data), jnp.asarray(LENGTHS),
                       scale=SCALE, chunk_size=cs, left_chunks=lc,
                       interpret=True)
    out, lse = rel_flash_attention_plain(*map(t, data), t(LENGTHS),
                                         scale=SCALE, chunk_size=cs,
                                         left_chunks=lc)
    np.testing.assert_allclose(_valid_rows(out), _valid_rows(ref), atol=1e-5,
                               rtol=1e-4)
    assert lse.shape == (B, H, T) and torch.isfinite(lse).all()


def test_wrapper_on_cpu_is_plain_and_not_counted(data):
    args = tuple(map(t, data)) + (t(LENGTHS),)
    before = rel_flash_attention_fwd.launches
    out = rel_flash_attention(*args, scale=SCALE)
    assert rel_flash_attention_fwd.launches == before
    torch.testing.assert_close(
        out, rel_flash_attention_plain(*args, scale=SCALE)[0], atol=0, rtol=0)
    # At dropout the CPU wrapper is the plain version with the kernels'
    # Philox mask of the seed; a rate outside [0, 1) is refused.
    seed = torch.tensor([77], dtype=torch.int32)
    out = rel_flash_attention(*args, seed, scale=SCALE, dropout_rate=0.1)
    assert rel_flash_attention_fwd.launches == before
    keep = philox.keep_mask(seed, 0.1, T, T, planes=B * H)
    torch.testing.assert_close(out, rel_flash_attention_plain(
        *args, scale=SCALE, dropout_rate=0.1, keep=keep)[0], atol=0, rtol=0)
    with pytest.raises(ValueError):
        rel_flash_attention(*args, seed, scale=SCALE, dropout_rate=1.0)
    with pytest.raises(ValueError):
        rel_flash_attention(*args[:4], args[4][:, :-1], args[5], scale=SCALE)


def test_rel_shift_matches():
    x = np.random.RandomState(3).randn(2, 3, 5, 9).astype(np.float32)
    np.testing.assert_array_equal(tatt.rel_shift(t(x)).numpy(),
                                  np.asarray(jatt.rel_shift(jnp.asarray(x))))


def _rel_mha_case(seed=1, b=2, t_len=37, d=32, h=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t_len, d).astype(np.float32)
    from espnet_slurp_tpu.models.embedding import rel_positional_embedding
    pos = np.asarray(rel_positional_embedding(t_len, d))
    lens = np.asarray([t_len, 23], np.int32)
    mask = (np.arange(t_len)[None, :] < lens[:, None])[:, None, None, :]
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    mod = jatt.RelPosMultiHeadAttention(h, d)
    params = mod.init(jax.random.PRNGKey(seed), x, pos, bias)["params"]
    # pos_bias_u/v initialise to zero; make them count.
    params = jax.tree.map(np.asarray, params)
    params["pos_bias_u"] = rng.randn(h, d // h).astype(np.float32)
    params["pos_bias_v"] = rng.randn(h, d // h).astype(np.float32)
    ref = mod.apply({"params": params}, x, pos, bias)
    return x, pos, lens, bias, params, np.asarray(ref)


@pytest.mark.parametrize("use_flash", [True, False])
def test_rel_pos_mha_matches_flax_eager(use_flash):
    x, pos, lens, bias, params, ref = _rel_mha_case()
    mod = tatt.RelPosMultiHeadAttention(4, 32, use_flash=use_flash)
    mod.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out = mod(t(x), t(pos), t(bias), lengths=t(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)


def test_abs_mha_matches_flax():
    rng = np.random.RandomState(4)
    q = rng.randn(2, 5, 32).astype(np.float32)
    kv = rng.randn(2, 7, 32).astype(np.float32)
    bias = np.where(np.arange(7)[None, None, None, :] < 6, 0.0,
                    -1e9).astype(np.float32)
    mod = jatt.MultiHeadAttention(4, 32)
    params = mod.init(jax.random.PRNGKey(0), q, kv, kv, bias)["params"]
    ref = mod.apply({"params": params}, q, kv, kv, bias)
    port = tatt.MultiHeadAttention(4, 32)
    port.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = port(t(q), t(kv), t(kv), t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("chunk", [(0, -1), (64, 1)])
def test_plain_gradients_match_pallas_interpret(data, chunk):
    """dq_u, dq_v, dk, dv and dp of the plain version's autograd against
    jax.grad of the Pallas kernel (its _dkv_kernel and _dq_kernel) in
    interpret mode, T = 256, ragged lengths, the cotangent on valid query
    rows only; within 1e-4 of max |ref| as in
    tests/test_flash_attention.py."""
    cs, lc = chunk
    cot = _valid_rows(np.random.RandomState(9).randn(B, H, T, DH)
                      .astype(np.float32))
    ref = jax.grad(
        lambda *a: jnp.sum(jax_rel_flash(*a, jnp.asarray(LENGTHS),
                                         scale=SCALE, chunk_size=cs,
                                         left_chunks=lc, interpret=True)
                           * cot), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, data))
    leaves = [t(a).requires_grad_(True) for a in data]
    out = rel_flash_attention(*leaves, t(LENGTHS), scale=SCALE,
                              chunk_size=cs, left_chunks=lc)
    (out * t(cot)).sum().backward()
    for name, a, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_fully_masked_rows_follow_autograd_not_the_kernel():
    """Documented divergence (ROADMAP.md queue 3): for a query row with no
    visible key the reference's backward takes exp(s - lse) = 1 per key
    (lse rounds to NEG) and keeps the masked scores' gradient, so its dv
    is T times the forward's uniform weights and dq/dk are non-zero. The
    port gives the plain version's autograd: uniform 1/T, no score
    gradient. Rows with visible keys agree to 1e-4 of max |ref|."""
    b, h, tl, dh = 2, 1, 128, 32
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = np.asarray([tl, 0], np.int32)
    cot = f(b, h, tl, dh)
    ref = jax.grad(lambda *a: jnp.sum(jax_rel_flash(
        *a, jnp.asarray(lens), scale=dh ** -0.5, interpret=True) * cot),
        argnums=(0, 2, 3))(*map(jnp.asarray, args))
    leaves = [t(a).requires_grad_(True) for a in args]
    out, _ = rel_flash_attention_plain(*leaves, t(lens), scale=dh ** -0.5)
    (out * t(cot)).sum().backward()
    for name, a, r in zip(("dq_u", "dk", "dv"),
                          (leaves[0], leaves[2], leaves[3]), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.grad[0].numpy(), r[0], rtol=0,
                                   atol=1e-4 * np.abs(r[0]).max(),
                                   err_msg=name)
    assert float(leaves[0].grad[1].abs().max()) == 0.0
    assert float(leaves[2].grad[1].abs().max()) == 0.0
    assert np.abs(np.asarray(ref[0])[1]).max() > 0.1
    dv = leaves[3].grad[1].numpy()
    np.testing.assert_allclose(np.asarray(ref[2])[1], tl * dv, rtol=1e-4,
                               atol=1e-5)


GRAD_NAMES = ("dq_u", "dq_v", "dk", "dv", "dp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "chunk,lengths",
    [((0, -1), LENGTHS), ((64, 1), LENGTHS), ((16, 4), LENGTHS),
     ((0, -1), np.asarray([64, 129], np.int32))],
    ids=["chunk0", "chunk1", "chunk16_4", "whole_key_tiles_masked"])
def test_bwd_plain_matches_pallas_vjp(data, dtype, chunk, lengths):
    """rel_flash_attention_bwd_plain against jax.vjp of the Pallas kernel
    (its _dkv_kernel and _dq_kernel, interpret mode) at T = 256 with ragged
    lengths, the cotangent on valid query rows; out from the Pallas forward,
    lse from the plain forward. Each of dq_u, dq_v, dk, dv and dp within tol
    of its max |ref|. fp32: sums in another order, tol 1e-4. bf16: both
    sides round P, ds and rawg to bf16 at the same points and return bf16,
    so what differs is the fp32 summation order, which can flip a rounding
    by one unit in the last place (2^-8 to 2^-7 of a value): tol 2^-7.
    Lengths 64 and 129 end on and one past a 64-key tile edge, so whole
    tiles of keys are invisible to every query (ds is 0 on each of their
    pairs), and chunk 16 / left 4 gives each query a window."""
    cs, lc = chunk
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(scale=SCALE, chunk_size=cs, left_chunks=lc)
    cot = _valid_rows(np.random.RandomState(9).randn(B, H, T, DH)
                      .astype(np.float32), lengths)
    out, vjp = jax.vjp(
        lambda *a: jax_rel_flash(*a, jnp.asarray(lengths), interpret=True,
                                 **kw), *(jnp.asarray(a, jdt) for a in data))
    ref = vjp(jnp.asarray(cot, jdt))
    args = [t(a).to(tdt) for a in data] + [t(lengths)]
    _, lse = rel_flash_attention_plain(*args, **kw)
    got = rel_flash_attention_bwd_plain(
        *args, t(np.asarray(out, np.float32)).to(tdt), lse, t(cot).to(tdt),
        **kw)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    for name, a, r in zip(GRAD_NAMES, got, ref):
        r = np.asarray(r, np.float32)
        assert a.dtype == tdt and a.shape == r.shape, name
        np.testing.assert_allclose(a.float().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("chunk", [(0, -1), (5, 0)])
def test_bwd_plain_matches_plain_autograd(chunk):
    """fp32, T = 70 (not a tile multiple), lengths 70, 0 and 33: every
    gradient of rel_flash_attention_bwd_plain within 1e-5 of max |ref| of
    the plain version's autograd, fully masked rows included."""
    cs, lc = chunk
    kw = dict(scale=0.25, chunk_size=cs, left_chunks=lc)
    b, h, tl, dh = 3, 2, 70, 16
    rng = np.random.RandomState(5)
    f = lambda *s: t(rng.randn(*s).astype(np.float32) * 0.5)
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = t(np.asarray([tl, 0, 33], np.int32))
    cot = f(b, h, tl, dh)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out, lse = rel_flash_attention_plain(*leaves, lens, **kw)
    (out * cot).sum().backward()
    got = rel_flash_attention_bwd_plain(*args, lens, out.detach(),
                                        lse.detach(), cot, **kw)
    for name, a, r in zip(GRAD_NAMES, got, leaves):
        r = r.grad.numpy()
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_bwd_plain_fully_masked_rows_follow_autograd_not_the_kernel():
    """The divergence of test_fully_masked_rows_follow_autograd_not_the_kernel
    holds for rel_flash_attention_bwd_plain too: against jax.grad of the
    Pallas kernel, the utterance with visible keys agrees within 1e-4 of
    max |ref|; the fully masked one has dq_u = dk = 0 and dv = 1/T of the
    reference's."""
    b, h, tl, dh = 2, 1, 128, 32
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = np.asarray([tl, 0], np.int32)
    cot = f(b, h, tl, dh)
    ref = jax.grad(lambda *a: jnp.sum(jax_rel_flash(
        *a, jnp.asarray(lens), scale=dh ** -0.5, interpret=True) * cot),
        argnums=(0, 2, 3))(*map(jnp.asarray, args))
    targs = [t(a) for a in args] + [t(lens)]
    out, lse = rel_flash_attention_plain(*targs, scale=dh ** -0.5)
    dq_u, _, dk, dv, _ = rel_flash_attention_bwd_plain(
        *targs, out, lse, t(cot), scale=dh ** -0.5)
    for name, a, r in zip(("dq_u", "dk", "dv"), (dq_u, dk, dv), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a[0].numpy(), r[0], rtol=0,
                                   atol=1e-4 * np.abs(r[0]).max(),
                                   err_msg=name)
    assert float(dq_u[1].abs().max()) == 0.0
    assert float(dk[1].abs().max()) == 0.0
    np.testing.assert_allclose(np.asarray(ref[2])[1], tl * dv[1].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 4)])
def test_fwd_tiled_plain_matches_pallas_interpret(dtype, chunk):
    """rel_flash_attention_fwd_tiled_plain at block_k 128 against the Pallas
    forward (its _fwd_kernel, interpret mode, 128-row query and key tiles)
    at T = 256 with key lengths 256, 131 and 0: out on every row, fully
    masked rows (length 0, and chunked rows past 131) included; lse against
    the plain version's logsumexp. fp32: sums in another order, out within
    1e-5 of max |ref|. bf16: both round exp(s - m) to bf16 before P v and
    return bf16, so what differs is the fp32 summation order, which can
    flip the output's rounding by one unit in the last place (2^-8 to 2^-7
    of a value): 2^-7 of max |ref|. lse within 1e-5 relative on rows with a
    visible key; the same rows fully masked on both sides."""
    cs, lc = chunk
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    b, h, tl, dh = 3, 2, 256, 32
    rng = np.random.RandomState(11)
    f = lambda *s: rng.randn(*s).astype(np.float32) * 0.5
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    args[4][:, -1] = 0.0
    lens = np.asarray([tl, 131, 0], np.int32)
    kw = dict(scale=dh ** -0.5, chunk_size=cs, left_chunks=lc)
    ref = jax_rel_flash(*(jnp.asarray(a, jdt) for a in args),
                        jnp.asarray(lens), block_q=128, block_k=128,
                        interpret=True, **kw)
    targs = [t(a).to(tdt) for a in args] + [t(lens)]
    out, lse = rel_flash_attention_fwd_tiled_plain(*targs, block_k=128, **kw)
    _, ref_lse = rel_flash_attention_plain(*targs, **kw)
    assert out.dtype == tdt and lse.dtype == torch.float32
    r = np.asarray(ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(out.float().numpy(), r, rtol=0,
                               atol=tol * np.abs(r).max())
    seen = ref_lse > 0.5 * NEG
    assert torch.equal(seen, lse > 0.5 * NEG) and not seen.all()
    torch.testing.assert_close(lse[seen], ref_lse[seen], rtol=1e-5, atol=0)


@pytest.mark.parametrize("chunk", [(0, -1), (5, 0)])
def test_fwd_tiled_plain_matches_plain(chunk):
    """fp32, T = 70 over key tiles of 32 (a ragged last tile), lengths 70,
    0, -1 and 33: rel_flash_attention_fwd_tiled_plain's out within 1e-5 of
    max |ref| of rel_flash_attention_plain on every row, fully masked rows
    (uniform weights) included, and lse within 1e-5 relative on rows with a
    visible key."""
    cs, lc = chunk
    kw = dict(scale=0.25, chunk_size=cs, left_chunks=lc)
    b, h, tl, dh = 4, 2, 70, 16
    rng = np.random.RandomState(6)
    f = lambda *s: t(rng.randn(*s).astype(np.float32) * 0.5)
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = t(np.asarray([tl, 0, -1, 33], np.int32))
    out, lse = rel_flash_attention_fwd_tiled_plain(*args, lens, block_k=32,
                                                   **kw)
    ref, ref_lse = rel_flash_attention_plain(*args, lens, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    seen = ref_lse > 0.5 * NEG
    assert torch.equal(seen, lse > 0.5 * NEG) and not seen.all()
    torch.testing.assert_close(lse[seen], ref_lse[seen], rtol=1e-5, atol=0)


RATE = 0.1


def _jax_rel_attention(qu, qv, k, v, p, allowed, keep, scale):
    """The reference's eager rel-pos attention (models/attention.py:
    RelPosMultiHeadAttention's materialised path) with a given keep mask on
    the softmax: softmax((q_u k^T + rel_shift(q_v p^T)) scale, masked) ->
    dropout -> @ v. p: [H, 2T, Dh], its last row unused."""
    t = qu.shape[2]
    ac = jnp.einsum("bhqd,bhkd->bhqk", qu, k)
    bd = jatt.rel_shift(jnp.einsum("bhqd,hkd->bhqk", qv, p[:, :2 * t - 1]))
    s = jnp.where(allowed, (ac + bd) * scale, NEG)
    probs = jax.nn.softmax(s, axis=-1)
    probs = jnp.where(keep, probs / (1.0 - RATE), 0.0)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v)


def _shape_cases(chunks):
    """The chunk settings at Dh 16 in fp32 (ids chunk0, chunk1), then each
    again at the WMMA routes' shapes: fp32 at Dh 64 (the default
    ASRConfig's) and bf16 at Dh 128."""
    cases = [pytest.param(c, "float32", 16, id=f"chunk{i}")
             for i, c in enumerate(chunks)]
    cases += [pytest.param(c, dt, dh, id=f"chunk{i}-{dt}-dh{dh}")
              for dt, dh in (("float32", 64), ("bfloat16", 128))
              for i, c in enumerate(chunks)]
    return cases


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


BF16_TOL = 2e-2  # of max |ref|, the card's tolerance for the bf16 launches


@pytest.mark.parametrize("chunk,dtype,dh", _shape_cases([(0, -1), (16, 2)]))
def test_plain_dropout_matches_jax_eager_vjp(chunk, dtype, dh):
    """rel_flash_attention_plain at rate 0.1 against jax.vjp of the
    reference's eager composition with the same mask (the kernels' Philox
    mask of a seed), T = 96, key lengths 96, 45 and 0 (a fully masked
    utterance): out and dq_u, dq_v, dk, dv, dp. fp32 (Dh 16, and Dh 64 of
    K3's fp32 WMMA route): out to atol 1e-5 / rtol 1e-4 and each gradient
    within 1e-4 of its max |ref|, as at rate 0. bf16 at Dh 128 (K3's bf16
    WMMA route): the composition in fp32 on the same bf16 values, each
    output within 2e-2 of its max |ref|."""
    cs, lc = chunk
    tdt = getattr(torch, dtype)
    b, h, tl = 3, 2, 96
    rng = np.random.RandomState(21)
    f = lambda *s: np.asarray(t(rng.randn(*s).astype(np.float32) * 0.5)
                              .to(tdt).float())
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = np.asarray([tl, 45, 0], np.int32)
    cot = f(b, h, tl, dh)
    seed = torch.tensor([5], dtype=torch.int32)
    keep = philox.keep_mask(seed, RATE, tl, tl, planes=b * h).reshape(
        b, h, tl, tl)
    allowed = allowed_mask(tl, t(lens), cs, lc)
    ref, vjp = jax.vjp(lambda *a: _jax_rel_attention(
        *a, jnp.asarray(allowed.numpy()), jnp.asarray(keep.numpy()),
        dh ** -0.5), *map(jnp.asarray, args))
    ref_grads = vjp(jnp.asarray(cot))
    leaves = [t(a).to(tdt).requires_grad_(True) for a in args]
    out, _ = rel_flash_attention_plain(*leaves, t(lens), scale=dh ** -0.5,
                                       dropout_rate=RATE, keep=keep,
                                       chunk_size=cs, left_chunks=lc)
    assert out.dtype == tdt
    (out * t(cot).to(tdt)).sum().backward()
    if dtype == "bfloat16":
        for name, a, r in zip(("out",) + GRAD_NAMES,
                              [out.detach()] + [a.grad for a in leaves],
                              [ref] + list(ref_grads)):
            err = _max_rel(a.float().numpy(), r)
            assert err <= BF16_TOL, f"{name}: {err:.3e}"
        return
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)
    for name, a, r in zip(GRAD_NAMES, leaves, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(a.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("chunk,dtype,dh", _shape_cases([(0, -1), (5, 0)]))
def test_bwd_plain_dropout_matches_masked_autograd(chunk, dtype, dh):
    """rel_flash_attention_bwd_plain at rate 0.1 against the masked plain
    version's autograd (the same seed), T = 70, lengths 70, 0 and 33: every
    gradient within 1e-5 of max |ref| in fp32 (Dh 16 and 64); in bf16 at
    Dh 128, where both round P to bf16 but autograd differentiates through
    the unrounded ds, within 2^-7 (as K2's bf16 case). Fully masked rows
    (uniform weights, dropped like any row) included."""
    cs, lc = chunk
    tdt = getattr(torch, dtype)
    kw = dict(scale=0.25, dropout_rate=RATE, chunk_size=cs, left_chunks=lc)
    b, h, tl = 3, 2, 70
    rng = np.random.RandomState(22)
    f = lambda *s: t(rng.randn(*s).astype(np.float32) * 0.5).to(tdt)
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = t(np.asarray([tl, 0, 33], np.int32))
    seed = torch.tensor([9], dtype=torch.int32)
    cot = f(b, h, tl, dh)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out, lse = rel_flash_attention_plain(*leaves, lens, seed, **kw)
    (out * cot).sum().backward()
    got = rel_flash_attention_bwd_plain(*args, lens, out.detach(),
                                        lse.detach(), cot, seed, **kw)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, r in zip(GRAD_NAMES, got, leaves):
        assert a.dtype == tdt, name
        r = r.grad.float().numpy()
        np.testing.assert_allclose(a.float().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)
    # The dropped uniform weights of the fully masked utterance still feed
    # dv; its score gradients stay 0.
    assert float(got[3][1].abs().max()) > 0.0
    assert float(got[0][1].abs().max()) == 0.0


@pytest.mark.parametrize("chunk,dtype,dh", _shape_cases([(0, -1), (5, 0)]))
def test_fwd_tiled_plain_dropout_matches_plain(chunk, dtype, dh):
    """rel_flash_attention_fwd_tiled_plain at rate 0.1 over the kernel's key
    tiles (32 in fp32, 64 in bf16; a ragged last tile) against
    rel_flash_attention_plain with the same seed, lengths 70, 0 and 33: out
    within 1e-5 of max |ref| on every row in fp32 (Dh 16 and 64), within
    2^-7 in bf16 at Dh 128 (the outputs' last-place rounding, as the bf16
    rate-0 case), and lse the undropped one (equal to rate 0's within
    1e-5)."""
    cs, lc = chunk
    tdt = getattr(torch, dtype)
    kw = dict(scale=0.25, chunk_size=cs, left_chunks=lc)
    b, h, tl = 3, 2, 70
    rng = np.random.RandomState(23)
    f = lambda *s: t(rng.randn(*s).astype(np.float32) * 0.5).to(tdt)
    args = [f(b, h, tl, dh) for _ in range(4)] + [f(h, 2 * tl, dh)]
    lens = t(np.asarray([tl, 0, 33], np.int32))
    seed = torch.tensor([10], dtype=torch.int32)
    out, lse = rel_flash_attention_fwd_tiled_plain(
        *args, lens, seed, dropout_rate=RATE,
        block_k=32 if dtype == "float32" else 64, **kw)
    ref, ref_lse = rel_flash_attention_plain(*args, lens, seed,
                                             dropout_rate=RATE, **kw)
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=0, atol=tol * ref.abs().max().item())
    _, lse0 = rel_flash_attention_plain(*args, lens, **kw)
    seen = lse0 > 0.5 * NEG
    torch.testing.assert_close(lse[seen], lse0[seen], rtol=1e-5, atol=0)
    torch.testing.assert_close(ref_lse, lse0, rtol=0, atol=0)
    assert not torch.allclose(ref, rel_flash_attention_plain(*args, lens,
                                                             **kw)[0])


@pytest.mark.parametrize("use_flash", [True, False])
def test_rel_pos_mha_dropout_routes(use_flash):
    """RelPosMultiHeadAttention at rate 0.1 with train and a generator: the
    kernel route draws one seed and equals rel_flash_attention with it (its
    plain version on the CPU); the eager route drops the softmax with
    torch.rand from the generator. Without train both equal the flax
    module's output."""
    x, pos, lens, bias, params, ref = _rel_mha_case()
    mod = tatt.RelPosMultiHeadAttention(4, 32, use_flash=use_flash,
                                        dropout_rate=RATE)
    mod.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out0 = mod(t(x), t(pos), t(bias), lengths=t(lens))
        np.testing.assert_allclose(out0.numpy(), ref, atol=1e-5, rtol=1e-4)
        g1 = torch.Generator().manual_seed(8)
        g2 = torch.Generator().manual_seed(8)
        out = mod(t(x), t(pos), t(bias), lengths=t(lens), train=True,
                  generator=g1)
        b, tl, d = x.shape
        if use_flash:
            seed = philox.draw_seed(g2, torch.device("cpu"))
            keep = philox.keep_mask(seed, RATE, tl, tl, planes=b * 4)
        else:
            keep = torch.rand(b, 4, tl, tl, generator=g2) >= RATE
        drop = keep.reshape(b, 4, tl, tl).float() / (1 - RATE)
        # The same attention with the mask folded into v's weights: redo
        # the eager composition by hand.
        h, dh = 4, d // 4
        q = mod.linear_q(t(x)).reshape(b, tl, h, dh)
        k = mod.linear_k(t(x)).reshape(b, tl, h, dh).transpose(1, 2)
        v = mod.linear_v(t(x)).reshape(b, tl, h, dh).transpose(1, 2)
        p = mod.linear_pos(t(pos)).reshape(1, -1, h, dh).transpose(1, 2)
        q_u = (q + mod.pos_bias_u).transpose(1, 2)
        q_v = (q + mod.pos_bias_v).transpose(1, 2)
        s = (q_u @ k.transpose(-1, -2)
             + tatt.rel_shift(q_v @ p.transpose(-1, -2))) * dh ** -0.5
        allowed = allowed_mask(tl, t(lens))
        attn = torch.softmax(s.masked_fill(~allowed, NEG), -1) * drop
        want = mod.linear_out((attn @ v).transpose(1, 2).reshape(b, tl, d))
        if not use_flash:
            # The eager route adds the bias rather than masking.
            attn = torch.softmax(s + t(bias), -1) * drop
            want = mod.linear_out((attn @ v).transpose(1, 2).reshape(
                b, tl, d))
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-4)
        assert not np.allclose(out.numpy(), ref, atol=1e-3)


def test_abs_mha_dropout():
    """MultiHeadAttention at rate 0.1 (reference :42-43): without train the
    flax output; with train the softmax dropped by torch.rand from the
    generator."""
    rng = np.random.RandomState(4)
    q = rng.randn(2, 5, 32).astype(np.float32)
    kv = rng.randn(2, 7, 32).astype(np.float32)
    mod = jatt.MultiHeadAttention(4, 32)
    params = mod.init(jax.random.PRNGKey(0), q, kv, kv)["params"]
    ref = mod.apply({"params": params}, q, kv, kv)
    port = tatt.MultiHeadAttention(4, 32, dropout_rate=RATE)
    port.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        np.testing.assert_allclose(port(t(q), t(kv), t(kv)).numpy(),
                                   np.asarray(ref), atol=1e-5, rtol=1e-4)
        g1 = torch.Generator().manual_seed(2)
        g2 = torch.Generator().manual_seed(2)
        out = port(t(q), t(kv), t(kv), train=True, generator=g1)
        split = lambda x: x.reshape(2, -1, 4, 8).transpose(1, 2)
        qq, kk, vv = (split(port.linear_q(t(q))), split(port.linear_k(t(kv))),
                      split(port.linear_v(t(kv))))
        attn = torch.softmax(qq @ kk.transpose(-1, -2) / 8 ** 0.5, -1)
        keep = torch.rand(attn.shape, generator=g2) >= RATE
        attn = torch.where(keep, attn / (1 - RATE), 0.0)
        want = port.linear_out((attn @ vv).transpose(1, 2).reshape(2, 5, 32))
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-4)
