"""Kernel K6 (fused conv module) against the JAX package, on the CPU.

espnet_slurp_tpu_torch/ops/kernels/conv_module.py:fused_conv_module runs its
plain version on CPU tensors. It is held to the reference's Pallas kernel
(espnet_slurp_tpu/ops/pallas/conv_module.py:fused_conv_module, interpret
mode) and to the unfused flax ConvModule, at the shapes and tolerances of
tests/test_fused_conv.py (d 128, T 37, k 15, ragged lengths; forward within
2e-4, dx within 3e-4, parameter gradients within 3e-3 x max(1, max |ref|)).
The weights are the flax module's, converted by flax_to_torch (the kernel
takes nn.Linear's and Conv1d's layouts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from espnet_slurp_tpu.models.conformer import ConvModule as JaxConvModule
from espnet_slurp_tpu.ops.pallas.conv_module import \
    fused_conv_module as jax_fused
from espnet_slurp_tpu_torch.models.conformer import ConvModule
from espnet_slurp_tpu_torch.ops.kernels.conv_module import fused_conv_module
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

PARAM_NAMES = ("pointwise1.weight", "pointwise1.bias", "depthwise.weight",
               "depthwise.bias", "norm.weight", "norm.bias",
               "pointwise2.weight", "pointwise2.bias")


def _mk(batch=3, t=37, d=128, k=15, causal=False, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, t, d).astype(np.float32)
    lens = np.asarray([t, t - 9, t // 2][:batch], np.int32)
    ref = JaxConvModule(d, kernel_size=k, causal=causal, use_flash=False)
    pad_mask = jnp.arange(t)[None, :] < jnp.asarray(lens)[:, None]
    params = ref.init(jax.random.key(seed), jnp.asarray(x), pad_mask)
    params = jax.tree.map(
        lambda p: p + 0.02 * jnp.asarray(rng.randn(*p.shape), p.dtype),
        params)
    gvec = np.random.RandomState(7).randn(batch, t, d).astype(np.float32)
    return x, lens, ref, jax.tree.map(np.asarray, params), gvec


def _port(x, lens, params, k, causal, gvec=None):
    """(out, {name: grad} incl. "x") of the port's wrapper on CPU tensors."""
    sd = flax_to_torch(params["params"])
    leaves = {n: sd[n].clone().requires_grad_(True) for n in PARAM_NAMES}
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    d = x.shape[-1]
    out = fused_conv_module(
        xt, None if lens is None else torch.from_numpy(lens),
        leaves["pointwise1.weight"], leaves["pointwise1.bias"],
        leaves["depthwise.weight"].view(d, k), leaves["depthwise.bias"],
        leaves["norm.weight"], leaves["norm.bias"],
        leaves["pointwise2.weight"], leaves["pointwise2.bias"],
        kernel_size=k, causal=causal)
    if gvec is None:
        return out.detach().numpy(), None
    (out * torch.from_numpy(gvec)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in leaves.items()}
    grads["x"] = xt.grad.numpy()
    return out.detach().numpy(), grads


def _jax_fused(x, lens, params, k, causal):
    p = params["params"]
    d = x.shape[-1]
    return lambda pp, xx: jax_fused(
        xx, None if lens is None else jnp.asarray(lens),
        pp["pointwise1"]["kernel"], pp["pointwise1"]["bias"],
        pp["depthwise"]["kernel"].reshape(k, d), pp["depthwise"]["bias"],
        pp["norm"]["scale"], pp["norm"]["bias"], pp["pointwise2"]["kernel"],
        pp["pointwise2"]["bias"], kernel_size=k, causal=causal,
        interpret=True), p


def _jax_refs(x, lens, ref, params, k, causal, gvec):
    """{"unfused": (out, grads), "pallas": (out, grads)}, the gradients as
    a port state_dict plus "x"."""
    t = x.shape[1]
    mask = None if lens is None else (jnp.arange(t)[None, :]
                                      < jnp.asarray(lens)[:, None])
    fused, p = _jax_fused(x, lens, params, k, causal)
    fns = {"unfused": (lambda pp, xx: ref.apply({"params": pp}, xx, mask)),
           "pallas": fused}
    out = {}
    for name, fn in fns.items():
        y = fn(p, jnp.asarray(x))
        gp, gx = jax.grad(lambda pp, xx: jnp.sum(fn(pp, xx) * gvec),
                          argnums=(0, 1))(p, jnp.asarray(x))
        grads = flax_to_torch(jax.tree.map(np.asarray, gp))
        grads = {n: v.numpy() for n, v in grads.items()}
        grads["x"] = np.asarray(gx)
        out[name] = (np.asarray(y), grads)
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_gradients_match_jax(causal):
    k = 15
    x, lens, ref, params, gvec = _mk(causal=causal)
    out, grads = _port(x, lens, params, k, causal, gvec)
    for name, (y, rg) in _jax_refs(x, lens, ref, params, k, causal,
                                   gvec).items():
        np.testing.assert_allclose(out, y, rtol=0, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(grads["x"], rg["x"], rtol=0, atol=3e-4,
                                   err_msg=name)
        for n in PARAM_NAMES:
            np.testing.assert_allclose(
                grads[n], rg[n], rtol=0,
                atol=3e-3 * max(1.0, float(np.abs(rg[n]).max())),
                err_msg=f"{name} {n}")


def test_no_mask_matches_jax():
    k = 15
    x, _, ref, params, _ = _mk(t=32)
    out, _ = _port(x, None, params, k, False)
    y_ref = ref.apply(params, jnp.asarray(x), None)
    fused, p = _jax_fused(x, None, params, k, False)
    np.testing.assert_allclose(out, np.asarray(y_ref), rtol=0, atol=2e-4)
    np.testing.assert_allclose(out, np.asarray(fused(p, jnp.asarray(x))),
                               rtol=0, atol=2e-4)


def test_padding_is_isolated():
    """Content after the valid length must not change valid-frame outputs."""
    k = 15
    x, lens, _, params, _ = _mk(t=40)
    valid = np.arange(40)[None, :] < lens[:, None]
    y1, _ = _port(x, lens, params, k, False)
    y2, _ = _port(x + np.where(valid[..., None], 0.0, 37.0).astype(
        np.float32), lens, params, k, False)
    np.testing.assert_allclose(y1[valid], y2[valid], rtol=0, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_module_path_matches_eager_module(causal):
    """The port's ConvModule with ``fused`` (the kernel's plain version on
    the CPU) against its eager layers, fp32, with lengths from the mask."""
    torch.manual_seed(0)
    d, k, t = 64, 7, 23
    eager = ConvModule(d, k, causal)
    fused = ConvModule(d, k, causal, fused=True)
    with torch.no_grad():
        for p in eager.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    fused.load_state_dict(eager.state_dict())
    x = torch.randn(2, t, d)
    lens = torch.tensor([t, 15])
    mask = torch.arange(t)[None, :] < lens[:, None]
    torch.testing.assert_close(fused(x, mask, lens), eager(x, mask, lens),
                               rtol=1e-5, atol=1e-5)



def _jax_vjp(x, lens, params, k, causal, gvec, dtype=jnp.float32):
    """{port name: grad} plus "x" of the Pallas kernel's vjp (interpret
    mode) at cotangent gvec, with x and gvec in ``dtype``; fp32 numpy."""
    fused, p = _jax_fused(x, lens, params, k, causal)
    _, vjp = jax.vjp(fused, p, jnp.asarray(x, dtype))
    gp, gx = vjp(jnp.asarray(gvec, dtype))
    grads = flax_to_torch(jax.tree.map(
        lambda v: np.asarray(v, np.float32), gp))
    grads = {n: v.numpy() for n, v in grads.items()}
    grads["x"] = np.asarray(gx, np.float32)
    return grads


def _bwd_plain(x, lens, params, k, causal, gvec, dtype):
    """fused_conv_module_bwd_plain's gradients as {port name: grad} plus
    "x" (fp32 numpy), with x, w1, w2 and the cotangent in ``dtype``."""
    from espnet_slurp_tpu_torch.ops.kernels.conv_module import \
        fused_conv_module_bwd_plain
    sd = flax_to_torch(params["params"])
    d = x.shape[-1]
    grads = fused_conv_module_bwd_plain(
        torch.from_numpy(x.copy()).to(dtype),
        None if lens is None else torch.from_numpy(lens),
        sd["pointwise1.weight"].to(dtype), sd["pointwise1.bias"],
        sd["depthwise.weight"].view(d, k), sd["depthwise.bias"],
        sd["norm.weight"], sd["norm.bias"], sd["pointwise2.weight"].to(dtype),
        torch.from_numpy(gvec.copy()).to(dtype), kernel_size=k, causal=causal)
    out = dict(zip(("x",) + PARAM_NAMES, (g.float().numpy() for g in grads)))
    out["depthwise.weight"] = out["depthwise.weight"].reshape(d, 1, k)
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_vjp_fp32(causal):
    """fused_conv_module_bwd_plain (the kernels' rounding points, which in
    fp32 round nothing) against the Pallas vjp, at the file's tolerances."""
    k = 15
    x, lens, _, params, gvec = _mk(causal=causal)
    got = _bwd_plain(x, lens, params, k, causal, gvec, torch.float32)
    ref = _jax_vjp(x, lens, params, k, causal, gvec)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=3e-4)
    for n in PARAM_NAMES:
        np.testing.assert_allclose(
            got[n], ref[n], rtol=0,
            atol=3e-3 * max(1.0, float(np.abs(ref[n]).max())), err_msg=n)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_vjp_bf16(causal):
    """bf16 x, w1, w2 and a cotangent exact in bf16: both sides round sw and
    du to bf16 at the same points and differ only in fp32 summation order,
    which can move a bf16 rounding (du, dx, dW1, dW2) by one unit in the
    last place, 2^-8 of an element: each gradient within 1e-2 of its max
    |ref| (the card tests' BWD_PLAIN_TOL)."""
    k = 15
    x, lens, _, params, gvec = _mk(causal=causal)
    bf = jnp.bfloat16
    xb = np.asarray(jnp.asarray(x, bf).astype(jnp.float32))
    gb = np.asarray(jnp.asarray(gvec, bf).astype(jnp.float32))
    got = _bwd_plain(xb, lens, params, k, causal, gb, torch.bfloat16)
    ref = _jax_vjp(xb, lens, params, k, causal, gb, bf)
    for n in ("x",) + PARAM_NAMES:
        err = float(np.abs(got[n] - ref[n]).max()) / float(
            np.abs(ref[n]).max())
        assert err <= 1e-2, (n, err)


def _fixed_order_sum(parts):
    """Sum over parts[p] in csrc/conv_module.cu's sum launch's order: lane
    group w adds the parts p = w, w + 8, ... in turn, then the 8 group sums
    are added in order."""
    groups = [torch.zeros_like(parts[0]) for _ in range(8)]
    for p in range(parts.shape[0]):
        groups[p % 8] = groups[p % 8] + parts[p]
    total = groups[0]
    for w in range(1, 8):
        total = total + groups[w]
    return total


def _bwd_f32_mirror(x, lens, sd, k, causal, go, nsplit, tile=32):
    """The fp32 backward as csrc/conv_module.cu's conv_f32 decomposes it,
    in plain PyTorch: g and sigmoid(gate) from pw1 (glu_sig), dsw = go W2,
    the conv and LayerNorm again and dc (rows), the transposed conv, the
    mask and the GLU backward into du [N, 2D] (du), dx = du W1; the row
    tiles' partial sums of dgamma, dbeta, dbdw, db1 and of the tap
    gradient (the tile's frames of g against dc), dW1 = du^T x, dW2 = go^T
    sw and db2 over splits of N (kchunk rows, rounded up to 16), each
    summed in the sum launch's fixed order."""
    from espnet_slurp_tpu_torch.ops.kernels.conv_module import left_pad
    b, t, d = x.shape
    pl = left_pad(k, causal)
    pr = k - 1 - pl
    w1, b1 = sd["pointwise1.weight"], sd["pointwise1.bias"]
    wdw, bdw = sd["depthwise.weight"].view(d, k), sd["depthwise.bias"]
    gamma, beta = sd["norm.weight"], sd["norm.bias"]
    w2 = sd["pointwise2.weight"]
    m = (torch.arange(t)[None, :] < lens[:, None]).float()[..., None]
    u = x @ w1.t() + b1
    sig = torch.sigmoid(u[..., d:])
    g = u[..., :d] * sig * m
    dsw = go @ w2
    gp = F.pad(g, (0, 0, pl, pr))
    c = bdw.expand_as(g)
    for j in range(k):
        c = c + wdw[:, j] * gp[:, j:j + t]
    mu = c.mean(-1, keepdim=True)
    rstd = torch.rsqrt((c - mu).square().mean(-1, keepdim=True) + 1e-6)
    chat = (c - mu) * rstd
    nrm = chat * gamma + beta
    sn = torch.sigmoid(nrm)
    sw = nrm * sn
    dn = dsw * sn * (1.0 + nrm * (1.0 - sn))
    dchat = dn * gamma
    dc = rstd * (dchat - dchat.mean(-1, keepdim=True)
                 - chat * (dchat * chat).mean(-1, keepdim=True))
    dcp = F.pad(dc, (0, 0, pr, pl))
    dg = torch.zeros_like(dc)
    for j in range(k):
        dg = dg + wdw[:, j] * dcp[:, k - 1 - j:k - 1 - j + t]
    dg = dg * m
    du = torch.cat([dg * sig, dg * g * (1.0 - sig)], -1)
    dx = du @ w1
    # Row-tile partials: [tiles, ...] in the order b ceil(T / tile) + i.
    tiles = [(i, r0) for i in range(b) for r0 in range(0, t, tile)]
    taps = torch.stack([g * dcp[:, k - 1 - j:k - 1 - j + t]
                        for j in range(k)], -1)  # [B, T, D, k]
    per_tile = {name: torch.stack([v[i, r0:r0 + tile].sum(0)
                                   for i, r0 in tiles])
                for name, v in (("dgamma", dn * chat), ("dbeta", dn),
                                ("dbdw", dc), ("db1", du), ("dwdw", taps))}
    # Split partials over the N = B T rows.
    n = b * t
    cdiv = lambda a, q: -(-a // q)
    kchunk = cdiv(cdiv(n, nsplit), 16) * 16
    flat = lambda v: v.reshape(n, -1)
    splits = [(s * kchunk, min(n, (s + 1) * kchunk)) for s in range(nsplit)]
    dw1p = torch.stack([flat(du)[a:e].t() @ flat(x)[a:e] for a, e in splits])
    dw2p = torch.stack([flat(go)[a:e].t() @ flat(sw)[a:e] for a, e in splits])
    db2p = torch.stack([flat(go)[a:e].sum(0) for a, e in splits])
    sums = {name: _fixed_order_sum(v) for name, v in per_tile.items()}
    return {"x": dx, "pointwise1.weight": _fixed_order_sum(dw1p),
            "pointwise1.bias": sums["db1"],
            "depthwise.weight": sums["dwdw"].view(d, 1, k),
            "depthwise.bias": sums["dbdw"], "norm.weight": sums["dgamma"],
            "norm.bias": sums["dbeta"],
            "pointwise2.weight": _fixed_order_sum(dw2p),
            "pointwise2.bias": _fixed_order_sum(db2p)}


@pytest.mark.parametrize("causal", [False, True])
def test_fp32_backward_decomposition_matches_pallas_vjp(causal):
    """The fp32 card route's backward decomposition (scratch g, sigmoid
    (gate), dc, du; row-tile partials; dW over 3 splits of N = 111 rows,
    not a multiple of the 48-row split) against the Pallas vjp, every
    gradient within 1e-5 of its max |ref|."""
    k = 15
    x, lens, _, params, gvec = _mk(causal=causal)
    sd = flax_to_torch(params["params"])
    got = _bwd_f32_mirror(torch.from_numpy(x), torch.from_numpy(lens), sd, k,
                          causal, torch.from_numpy(gvec), nsplit=3)
    ref = _jax_vjp(x, lens, params, k, causal, gvec)
    for n in ("x",) + PARAM_NAMES:
        err = float(np.abs(got[n].numpy() - ref[n]).max()) / float(
            np.abs(ref[n]).max())
        assert err <= 1e-5, (n, err)
