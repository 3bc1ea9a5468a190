"""The port's CUDA kernels against their plain versions, on the card, at
edge shapes the smoke run does not reach: a single row, ragged N, narrow
widths, T shorter than a tile or just past one, Dh 32 to 128, key lengths
of 0 and below (Speech2Text's padding rows), chunk masks; for the backward
passes and the CTC kernels also U = 0, U > T and duplicate labels in ext;
for the RNN-T lattice U1 from 1 to 300 (both routes: one warp per utterance
up to 256, one block past it) and tlen 0, 1 and T, and the transducer
train step's lattice; for the fused
conv module k 3 to 33, SAME and causal, lengths 0, 1, full and None, its
route by host counts and its bf16 backward against the plain backward at
its rounding points; for K2's
and K3's launches, bf16, fp32 and the WMMA ones, the dropout at rate 0.1
(0.5 for two fp32 cases) and its Philox mask; K2's fp32 launches at N 1 to
4097, widths 32 to 512 and F 128 to 2048; FeedForward's width route;
K3's fp32 kernels at T 1 to 468, Dh 32 to 128, chunk masks and rates 0,
0.1 and 0.5, and their route by Dh; K4's fp32 route from 128-row tiles
that span 8 utterances to the default train shape, and its plan; K4's bf16
forward (lse on the mma.sync mainloop, gather) at the same shapes; K1's
two routes (one warp per utterance up to 256 states, one block past it)
from S 1 to 3072, tlen 0, 1 and T, every skip off and empty labels. The
routes of K1, K4, K5 and K6 are read from the library's host-side launch
counts.
Gradients are held to the plain versions' autograd gradients.

Needs a CUDA device and nvcc; skips otherwise. The tests directory's
conftest imports JAX, which the card's machine lacks, so run there with:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
Tolerances are relative to max |ref|: 2e-2 in bf16 (rounding of the hidden
or the probabilities before the second product) and 1e-4 in fp32 (the
lattice is fp32 only).
"""
import pytest
import torch

from espnet_slurp_tpu_torch.ops.kernels import ffn
from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
import torch_parity  # noqa: F401  (each test worker's CPU threads)

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The bf16 FFN and attention backward passes against fused_ffn_bwd_plain
# and rel_flash_attention_bwd_plain (the same rounding points): what remains
# is fp32 summation order, which can move a bf16 output by one unit in the
# last place (2^-8 to 2^-7 of itself); chip_smoke.py states the margin.
BWD_PLAIN_TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(out, ref, floor=1e-30):
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max().clamp_min(
        floor)).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,f,d2", [(1, 256, 1024, 256), (33, 64, 128, 32),
                                      (100, 128, 256, 128)])
def test_fused_ffn(gen, dtype, n, d, f, d2):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    args = (r(n, d).to(dtype), (r(d, f) * d ** -0.5).to(dtype), r(f) * 0.1,
            (r(f, d2) * f ** -0.5).to(dtype), r(d2) * 0.1)
    before = ffn.fused_ffn.launches
    out = ffn.fused_ffn(*args)
    torch.cuda.synchronize()
    assert ffn.fused_ffn.launches == before + 1
    assert out.shape == (n, d2) and out.dtype == dtype
    assert _rel(out, ffn.fused_ffn_plain(*args)) <= TOL[dtype]


def _instances(call):
    """{kernel instance: launches} that call() makes, by the library's
    host-side counts (build.launch_counts: each kernel by its name with its
    template arguments), with no profiler window."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    before = build.launch_counts()
    call()
    torch.cuda.synchronize()
    return build.launch_delta(before, build.launch_counts())


@pytest.mark.parametrize("n,d,f,d2", [
    # below one 64-row tile, ragged, the serving shape (F split 4 ways),
    # the flagship train shape, F split 2 ways (192), narrow and wide D
    (17, 256, 1024, 256), (4097, 256, 1024, 256), (3768, 256, 1024, 256),
    (29952, 256, 1024, 256), (3768, 256, 192, 256), (100, 64, 128, 32),
    (300, 128, 256, 64), (200, 512, 512, 128)])
def test_fused_ffn_fwd_bf16_kernel(gen, n, d, f, d2):
    """The bf16 forward is ffn_fwd::fwd_kernel<D2, false> (by the host
    counts), with ffn_fwd::reduce_kernel where F is split, within
    BWD_PLAIN_TOL of fused_ffn_plain, which rounds hd and the output where
    the kernel does."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    args = (r(n, d).to(bf), (r(d, f) * d ** -0.5).to(bf), r(f) * 0.1,
            (r(f, d2) * f ** -0.5).to(bf), r(d2) * 0.1)
    before = ffn.fused_ffn.launches
    out = ffn.fused_ffn(*args)
    torch.cuda.synchronize()
    assert ffn.fused_ffn.launches == before + 1
    assert out.shape == (n, d2) and out.dtype == bf
    assert torch.isfinite(out).all()
    assert _rel(out, ffn.fused_ffn_plain(*args)) <= BWD_PLAIN_TOL
    from espnet_slurp_tpu_torch.ops.kernels import build
    splits = build.library().espnet_fused_ffn_fwd_splits(n, d, f, d2)
    want = {f"ffn_fwd::fwd_kernel<{d2}, false>": 1}
    if splits > 1:
        want["ffn_fwd::reduce_kernel"] = 1
    assert _instances(lambda: ffn._launch_fwd(*args)) == want


def test_fused_ffn_refuses_what_it_cannot_take(gen):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, w1, b1, w2, b2 = r(8, 64), r(64, 80), r(80), r(80, 64), r(64)
    with pytest.raises(ValueError):  # F not a multiple of the chunk
        ffn.fused_ffn(x, w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ffn.fused_ffn(r(8, 128)[:, :64], r(64, 128), r(128), r(128, 64),
                      b2)
    bf = torch.bfloat16  # output widths the bf16 forward does not hold
    for d2 in (48, 512):
        with pytest.raises(ValueError):
            ffn.fused_ffn(r(8, 64).to(bf), r(64, 128).to(bf), r(128),
                          r(128, d2).to(bf), r(d2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,dh", [(1, 64), (17, 32), (65, 64), (130, 128)])
@pytest.mark.parametrize("chunk", [(0, -1), (5, 0), (16, 2)])
def test_rel_flash_attention(gen, dtype, t, dh, chunk):
    b, h = 4, 2
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    lengths = torch.tensor([t, max(t - 7, 1), 0, -1], dtype=torch.int32,
                           device="cuda")
    p = r(h, 2 * t, dh)
    p[:, -1] = 0.0
    args = [r(b, h, t, dh).to(dtype) for _ in range(4)] + [p.to(dtype),
                                                           lengths]
    cs, lc = chunk
    before = fa.rel_flash_attention_fwd.launches
    out, lse = fa.rel_flash_attention_fwd(*args, scale=dh ** -0.5,
                                          chunk_size=cs, left_chunks=lc)
    torch.cuda.synchronize()
    assert fa.rel_flash_attention_fwd.launches == before + 1
    ref, ref_lse = fa.rel_flash_attention_plain(*args, scale=dh ** -0.5,
                                                chunk_size=cs, left_chunks=lc)
    # every row, fully masked ones (lengths 0 and -1) included
    assert _rel(out, ref) <= TOL[dtype]
    seen = ref_lse > -1e29  # rows with at least one visible key
    assert torch.equal(seen, lse > -1e29)
    assert _rel(lse[seen], ref_lse[seen]) <= TOL[dtype]


def test_rel_flash_attention_refuses_what_it_cannot_take(gen):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    q = r(1, 2, 8, 24)  # Dh not a multiple of 16
    lengths = torch.tensor([8], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        fa.rel_flash_attention(q, q, q, q, r(2, 16, 24), lengths, scale=1.0)
    q = r(1, 2, 8, 32)
    with pytest.raises(TypeError):
        fa.rel_flash_attention(q, q, q, q.half(), r(2, 16, 32), lengths,
                               scale=1.0)


# ---- Backward passes and the CTC kernels (K1, K4) ---------------------------
# Each kernel's gradients are held to the plain version's autograd gradients
# on the same inputs, every output and gradient within TOL of its max |ref|,
# with max |ref| floored at 1e-3: some gradients are exactly 0 in the
# reference (T = 1: the score gradient of a softmax over one key, where
# dP - delta cancels) and come out at rounding level (~3e-8) from the
# kernel, which sums dP and delta in another order.


def _grads(fn, args, cot, n_diff=None):
    """Outputs and the gradients of <outputs, cot> w.r.t. the float args
    (the first ``n_diff`` of them when given)."""
    n_diff = len(args) if n_diff is None else n_diff
    leaves = [a.detach().clone().requires_grad_(
        a.is_floating_point() and i < n_diff) for i, a in enumerate(args)]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    (out.float() * cot).sum().backward()
    return out.detach(), [a.grad for a in leaves if a.requires_grad]


def _check_grads(kernel_fn, plain_fn, args, cot, tol, names):
    out, grads = _grads(kernel_fn, args, cot)
    ref, ref_grads = _grads(plain_fn, args, cot)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= tol, "output"
    for name, a, r in zip(names, grads, ref_grads):
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=1e-3) <= tol, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,f,d2", [
    (1, 256, 1024, 256), (33, 64, 128, 32), (100, 128, 256, 128),
    (1000, 256, 1024, 256),
    # the bf16 kernels' tile edges: N around a 128-row tile, N split into
    # 8 ranges of 544 rows with a ragged last one (4097), F a multiple of
    # the F multiple but not of a 128-wide dW tile, D2 = 32 under one
    (127, 128, 256, 128), (128, 128, 256, 128), (129, 128, 256, 128),
    (4097, 256, 1024, 256), (300, 256, 192, 256), (200, 256, 256, 32)])
def test_fused_ffn_backward(gen, dtype, n, d, f, d2):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    args = (r(n, d).to(dtype), (r(d, f) * d ** -0.5).to(dtype), r(f) * 0.1,
            (r(f, d2) * f ** -0.5).to(dtype), r(d2) * 0.1)
    before = ffn.fused_ffn.bwd_launches
    _check_grads(ffn.fused_ffn, ffn.fused_ffn_plain, args, r(n, d2),
                 TOL[dtype], ("dx", "dw1", "db1", "dw2", "db2"))
    assert ffn.fused_ffn.bwd_launches == before + 1


@pytest.mark.parametrize("n,d,f,d2", [(129, 128, 256, 128),
                                      (4097, 256, 1024, 256),
                                      (200, 256, 192, 32)])
def test_fused_ffn_backward_bf16_at_its_rounding_points(gen, n, d, f, d2):
    """The bf16 backward kernels against fused_ffn_bwd_plain, which rounds
    hd and ds where they do: within BWD_PLAIN_TOL of max |ref| per output."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    args = (r(n, d).to(bf), (r(d, f) * d ** -0.5).to(bf), r(f) * 0.1,
            (r(f, d2) * f ** -0.5).to(bf), r(n, d2).to(bf))
    out = ffn._launch_bwd(*args)
    ref = ffn.fused_ffn_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) <= BWD_PLAIN_TOL, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,dh", [(1, 64), (17, 32), (65, 64), (130, 128)])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 4), (5, 0)])
def test_rel_flash_attention_backward(gen, dtype, t, dh, chunk):
    b, h = 4, 2
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    lengths = torch.tensor([t, max(t - 7, 1), 0, -1], dtype=torch.int32,
                           device="cuda")
    p = r(h, 2 * t, dh)
    p[:, -1] = 0.0
    args = [r(b, h, t, dh).to(dtype) for _ in range(4)] + [p.to(dtype),
                                                           lengths]
    cs, lc = chunk
    kw = dict(scale=dh ** -0.5, chunk_size=cs, left_chunks=lc)
    before = fa.rel_flash_attention_fwd.bwd_launches
    _check_grads(lambda *a: fa.rel_flash_attention_fwd(*a, **kw),
                 lambda *a: fa.rel_flash_attention_plain(*a, **kw), args,
                 r(b, h, t, dh), TOL[dtype],
                 ("dq_u", "dq_v", "dk", "dv", "dp"))
    assert fa.rel_flash_attention_fwd.bwd_launches == before + 1


def _attention_case(gen, t, dh, b=4, h=2, lengths=None):
    """bf16 q_u, q_v, k, v, p and key lengths (by default t, t - 7, 0 and
    -1)."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    if lengths is None:
        lengths = [t, max(t - 7, 1), 0, -1][:b]
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    p = r(h, 2 * t, dh)
    p[:, -1] = 0.0
    bf = torch.bfloat16
    return [r(b, h, t, dh).to(bf) for _ in range(4)] + [p.to(bf), lengths]


@pytest.mark.parametrize("t", [1, 63, 64, 65, 129, 468])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 4), (5, 0)])
def test_rel_flash_attention_backward_bf16_at_its_rounding_points(gen, t, dh,
                                                                  chunk):
    """The bf16 backward launch (Dh 32 and 64: the register-accumulator dkv
    and dq kernels; Dh 128: the 32 x 32 WMMA kernels) against
    rel_flash_attention_bwd_plain, which rounds P, ds and rawg where the
    kernels do: dq_u, dq_v, dk, dv and dp each within BWD_PLAIN_TOL of max
    |ref| (floored at 1e-3, as in _check_grads), fully masked rows
    included."""
    cs, lc = chunk
    args = _attention_case(gen, t, dh)
    scale = dh ** -0.5
    out, lse = fa._launch_fwd(*args, scale, cs, lc)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         .to(torch.bfloat16))
    before = fa.rel_flash_attention_fwd.bwd_launches
    got = fa._launch_bwd(*args, out, lse, g, scale, cs, lc)
    assert fa.rel_flash_attention_fwd.bwd_launches == before + 1
    ref = fa.rel_flash_attention_bwd_plain(*args, out, lse, g, scale=scale,
                                           chunk_size=cs, left_chunks=lc)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=1e-3) <= BWD_PLAIN_TOL, name


@pytest.mark.parametrize("t", [1, 63, 64, 65, 129, 468, 471])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 4), (5, 0)])
def test_rel_flash_attention_fwd_bf16_at_its_rounding_points(gen, t, dh,
                                                             chunk):
    """The bf16 forward at Dh 32 and 64 (the register-resident kernel)
    against rel_flash_attention_fwd_tiled_plain at the kernel's key tile,
    which rounds exp(s - m) where the kernel does: out within BWD_PLAIN_TOL
    of max |ref|, and within TOL of rel_flash_attention_plain, on every row,
    fully masked rows (lengths 0 and -1) included; lse within 1e-4 of max
    |ref| (fp32 sums in another order) on rows with a visible key, and the
    same rows fully masked."""
    cs, lc = chunk
    args = _attention_case(gen, t, dh)
    kw = dict(scale=dh ** -0.5, chunk_size=cs, left_chunks=lc)
    before = fa.rel_flash_attention_fwd.launches
    out, lse = fa._launch_fwd(*args, kw["scale"], cs, lc)
    torch.cuda.synchronize()
    assert fa.rel_flash_attention_fwd.launches == before + 1
    ref, ref_lse = fa.rel_flash_attention_fwd_tiled_plain(
        *args, block_k=fa.FWD_BLOCK_K, **kw)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _rel(out, ref) <= BWD_PLAIN_TOL
    assert _rel(out, fa.rel_flash_attention_plain(*args, **kw)[0]) <= \
        TOL[torch.bfloat16]
    seen = ref_lse > -1e29
    assert torch.equal(seen, lse > -1e29)
    assert _rel(lse[seen], ref_lse[seen]) <= 1e-4


@pytest.mark.parametrize("t", [65, 468])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 4)])
def test_rel_flash_attention_backward_takes_the_fwd_kernel_lse(gen, t, dh,
                                                               chunk):
    """The bf16 backward launch fed the register-resident forward's out and
    lse against rel_flash_attention_bwd_plain fed the tiled plain forward's:
    dq_u, dq_v, dk, dv and dp each within BWD_PLAIN_TOL of max |ref|
    (floored at 1e-3), fully masked rows (lse at NEG) included."""
    cs, lc = chunk
    args = _attention_case(gen, t, dh)
    scale = dh ** -0.5
    kw = dict(scale=scale, chunk_size=cs, left_chunks=lc)
    out, lse = fa._launch_fwd(*args, scale, cs, lc)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         .to(torch.bfloat16))
    got = fa._launch_bwd(*args, out, lse, g, scale, cs, lc)
    ref_out, ref_lse = fa.rel_flash_attention_fwd_tiled_plain(
        *args, block_k=fa.FWD_BLOCK_K, **kw)
    ref = fa.rel_flash_attention_bwd_plain(*args, ref_out, ref_lse, g, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=1e-3) <= BWD_PLAIN_TOL, name


@pytest.mark.parametrize("t", [129, 468])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 0)])
def test_rel_flash_attention_dq_over_invisible_key_tiles(gen, t, dh, chunk):
    """Key lengths 64, 65, 128 and 129 end on and one past a 64-key tile
    edge, and chunk 16 / left 0 lets each query see one chunk: whole key
    tiles that the bf16 dq kernel at Dh 32 / 64 walks are invisible to
    every query of its block and must add nothing. dq_u and dq_v (and dk,
    dv, dp) against
    rel_flash_attention_bwd_plain, each within BWD_PLAIN_TOL of max |ref|
    (floored at 1e-3)."""
    cs, lc = chunk
    args = _attention_case(gen, t, dh, lengths=[64, 65, 128, 129])
    scale = dh ** -0.5
    out, lse = fa._launch_fwd(*args, scale, cs, lc)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         .to(torch.bfloat16))
    got = fa._launch_bwd(*args, out, lse, g, scale, cs, lc)
    ref = fa.rel_flash_attention_bwd_plain(*args, out, lse, g, scale=scale,
                                           chunk_size=cs, left_chunks=lc)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=1e-3) <= BWD_PLAIN_TOL, name


def test_rel_flash_attention_dq_two_blocks_per_sm(gen):
    """The bf16 dq kernel's shared memory and registers let two blocks
    share an SM at both Dh it takes, and it takes no other Dh."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    assert lib.espnet_rel_flash_dq_blocks_per_sm(64) >= 2
    assert lib.espnet_rel_flash_dq_blocks_per_sm(32) >= 2
    assert lib.espnet_rel_flash_dq_blocks_per_sm(128) == 0


def test_rel_flash_attention_fwd_two_blocks_per_sm(gen):
    """The bf16 forward kernel's shared memory and registers let two blocks
    share an SM at both Dh it takes, and it takes no other Dh."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    assert lib.espnet_rel_flash_fwd_blocks_per_sm(64) >= 2
    assert lib.espnet_rel_flash_fwd_blocks_per_sm(32) >= 2
    assert lib.espnet_rel_flash_fwd_blocks_per_sm(128) == 0


def test_rel_flash_attention_dkv_two_blocks_per_sm(gen):
    """The bf16 dkv kernel's shared memory and registers let two blocks
    share an SM at both Dh it takes."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    assert lib.espnet_rel_flash_dkv_blocks_per_sm(64) >= 2
    assert lib.espnet_rel_flash_dkv_blocks_per_sm(32) >= 2
    assert lib.espnet_rel_flash_dkv_blocks_per_sm(128) == 0


# ---- K3 in fp32 at Dh 32 / 64 / 128: csrc/flash_attention.cu:rel_f32 -----
# The register micro-tile kernels (forward, dkv, dq) against
# rel_flash_attention_plain and rel_flash_attention_bwd_plain: in fp32
# there is no rounding point between them, only the summation order, so
# TOL (1e-4 of max |ref|). At T = 1 every gradient but dv is the rounding
# noise of dP - delta (a softmax over one key; the plain version gives
# exactly 0 on the card), ~|dP| 2^-23 scale |k|: 1.6e-7 was seen at Dh 32,
# where the kernel's dP (an fma chain over Dh) and the wrapper's delta (a
# torch sum) differ in their last bits. Gradients are floored at
# F32_GRAD_FLOOR, which admits 1e-6 of such noise; from T = 17 on max |ref|
# is O(1) and the floor plays no part.
F32_GRAD_FLOOR = 1e-2


def _f32_case(gen, t, dh, b=4, h=2):
    """fp32 q_u, q_v, k, v, p, key lengths t, t - 7, 0 and -1 (fully masked
    rows), and a cotangent."""
    args = [a.float() if a.is_floating_point() else a
            for a in _attention_case(gen, t, dh, b=b, h=h)]
    return args, torch.randn(b, h, t, dh, generator=gen, device="cuda")


@pytest.mark.parametrize("t", [1, 17, 65, 130, 468])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("chunk", [(0, -1), (5, 0), (16, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_rel_flash_attention_fp32_kernels(gen, t, dh, chunk, rate):
    """The fp32 forward (out, lse) and backward (dq_u, dq_v, dk, dv, dp) at
    ragged T, key lengths with fully masked rows, chunk masks and dropout
    rates 0, 0.1 and 0.5 (the same seed on both sides), within TOL of the
    plain versions."""
    cs, lc = chunk
    args, g = _f32_case(gen, t, dh)
    scale = dh ** -0.5
    seed = _drop_seed() if rate else None
    kw = dict(scale=scale, dropout_rate=rate, chunk_size=cs, left_chunks=lc)
    out, lse = fa._launch_fwd(*args, scale, cs, lc, seed, rate)
    got = fa._launch_bwd(*args, out, lse, g, scale, cs, lc, seed, rate)
    ref, ref_lse = fa.rel_flash_attention_plain(*args, seed, **kw)
    refs = fa.rel_flash_attention_bwd_plain(*args, out, lse, g, seed, **kw)
    torch.cuda.synchronize()
    seen = ref_lse > -1e29  # rows with a visible key (the rest sit at NEG)
    assert _rel(out, ref) <= TOL[torch.float32], "out"
    assert _rel(lse[seen], ref_lse[seen]) <= TOL[torch.float32], "lse"
    assert (lse[~seen] < -1e29).all(), "lse of fully masked rows"
    for name, a, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, refs):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=F32_GRAD_FLOOR) <= TOL[torch.float32], name


@pytest.mark.parametrize("dh,want", [
    (32, "rel_f32::"), (64, "rel_f32::"), (128, "rel_f32::"),
    (48, "rel_flash_")])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_flash_attention_fp32_routes(gen, dh, want, rate):
    """fp32 at Dh 32, 64 and 128 launches the register micro-tile kernels
    (rel_f32::fwd_kernel, dkv_kernel, dq_kernel) and at any other Dh (48)
    the WMMA float kernels (rel_flash_fwd_kernel<float, ...>,
    rel_flash_dkv_kernel, rel_flash_dq_kernel), the dropout instantiation
    at a rate above 0, by the host counts; both agree with the plain
    versions."""
    args, g = _f32_case(gen, 65, dh)
    scale = dh ** -0.5
    seed = _drop_seed() if rate else None
    kw = dict(scale=scale, dropout_rate=rate)
    out, lse = fa._launch_fwd(*args, scale, 0, -1, seed, rate)
    call = lambda: (fa._launch_fwd(*args, scale, 0, -1, seed, rate),
                    fa._launch_bwd(*args, out, lse, g, scale, 0, -1, seed,
                                   rate))
    launched = _instances(call)
    names = sorted(launched)
    flag = "true>" if rate else "false>"
    kinds = ("fwd_kernel", "dkv_kernel", "dq_kernel") if want == "rel_f32::" \
        else ("rel_flash_fwd_kernel<float", "rel_flash_dkv_kernel<float",
              "rel_flash_dq_kernel<float")
    assert len(names) == 3 and set(launched.values()) == {1}, launched
    for kind in kinds:
        assert any(want in k and kind in k and flag in k for k in names), \
            names
    ref, _ = fa.rel_flash_attention_plain(*args, seed, **kw)
    refs = fa.rel_flash_attention_bwd_plain(*args, out, lse, g, seed, **kw)
    got = fa._launch_bwd(*args, out, lse, g, scale, 0, -1, seed, rate)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= TOL[torch.float32]
    for a, r in zip(got, refs):
        assert _rel(a, r, floor=1e-3) <= TOL[torch.float32]


def test_rel_flash_attention_fp32_blocks_per_sm(gen):
    """The fp32 forward's shared memory and registers let two blocks share
    an SM at Dh 32 and 64 (one at 128); dkv and dq fit one block at every
    Dh they take; no fp32 micro-tile kernel takes Dh 48."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    assert lib.espnet_rel_flash_f32_blocks_per_sm(0, 64) >= 2
    assert lib.espnet_rel_flash_f32_blocks_per_sm(0, 32) >= 2
    for dh in (32, 64, 128):
        for kernel in (0, 1, 2):
            assert lib.espnet_rel_flash_f32_blocks_per_sm(kernel, dh) >= 1
    for kernel in (0, 1, 2):
        assert lib.espnet_rel_flash_f32_blocks_per_sm(kernel, 48) == 0


# ---- Dropout: the Philox keep mask in K2's and K3's launches --------------
# Each dropout launch against its plain version with the same seed (the
# kernels' rounding points, the mask from ops/kernels/philox.py): the bf16
# mma.sync launches within BWD_PLAIN_TOL, as at rate 0; the WMMA launches
# within TOL.

DROP_RATE, DROP_SEED = 0.1, 20241017


def _drop_seed():
    return torch.tensor([DROP_SEED], dtype=torch.int32, device="cuda")


def test_philox_answer_vectors_on_the_card(gen):
    """csrc/philox.cuh reproduces Random123's Philox4x32-10 answers."""
    import numpy as np
    from espnet_slurp_tpu_torch.ops.kernels import build
    kat = np.asarray([[0] * 6, [0xFFFFFFFF] * 6,
                      [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344,
                       0xA4093822, 0x299F31D0]], np.uint32)
    want = np.asarray([[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
                       [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
                       [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]],
                      np.uint32)
    ck = torch.from_numpy(kat.view(np.int32)).cuda()
    out = torch.empty(3, 4, dtype=torch.int32, device="cuda")
    build.check(build.library().espnet_philox4x32_10(
        ck.data_ptr(), out.data_ptr(), 3, build.stream_ptr(out)), "philox")
    assert np.array_equal(out.cpu().numpy().view(np.uint32), want)


@pytest.mark.parametrize("planes,rows,cols", [
    (1, 29952, 1024), (1, 33, 70), (8, 65, 130), (256, 468, 468)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_philox_device_mask_equals_the_torch_mask(gen, planes, rows, cols,
                                                  rate):
    """The keep mask the dropout launches draw, written out by the
    library's test entry, equals ops/kernels/philox.py's bit for bit,
    ragged rows and columns included."""
    from espnet_slurp_tpu_torch.ops.kernels import build, philox
    seed = _drop_seed()
    dev = torch.empty(planes, rows, cols, dtype=torch.uint8, device="cuda")
    build.check(build.library().espnet_philox_keep_mask(
        seed.data_ptr(), philox.threshold(rate), planes, rows, cols,
        dev.data_ptr(), build.stream_ptr(dev)), "philox keep mask")
    assert torch.equal(dev.bool(), philox.keep_mask(seed, rate, rows, cols,
                                                    planes=planes))


@pytest.mark.parametrize("planes,rows,cols", [
    (1, 29952, 2048), (1, 33, 70), (8, 65, 130), (256, 468, 468)])
def test_philox_tile_fill_equals_the_torch_mask(gen, planes, rows, cols):
    """The keep mask as the WMMA launches draw it (philox.cuh:fill_keep_tile
    into 64 x 64 shared tiles, written out by the library's test entry)
    equals ops/kernels/philox.py's bit for bit, ragged rows and columns
    included."""
    from espnet_slurp_tpu_torch.ops.kernels import build, philox
    seed = _drop_seed()
    dev = torch.empty(planes, rows, cols, dtype=torch.uint8, device="cuda")
    build.check(build.library().espnet_philox_keep_tiles(
        seed.data_ptr(), philox.threshold(DROP_RATE), planes, rows, cols,
        dev.data_ptr(), build.stream_ptr(dev)), "philox keep tiles")
    assert torch.equal(dev.bool(), philox.keep_mask(
        seed, DROP_RATE, rows, cols, planes=planes))


@pytest.mark.parametrize("n,d,f,d2", [
    (1, 256, 1024, 256), (129, 128, 256, 128), (4097, 256, 1024, 256),
    (3768, 256, 1024, 256), (200, 256, 192, 32)])
def test_fused_ffn_dropout_bf16(gen, n, d, f, d2):
    """K2's bf16 forward (F split or not) and backward at rate 0.1 against
    fused_ffn_plain / fused_ffn_bwd_plain with the same seed, each output
    within BWD_PLAIN_TOL of max |ref| (floored at 1e-3); the wrapper's
    autograd path launches once each way and agrees with the plain
    version's autograd within TOL."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    args = (r(n, d).to(bf), (r(d, f) * d ** -0.5).to(bf), r(f) * 0.1,
            (r(f, d2) * f ** -0.5).to(bf), r(d2) * 0.1)
    g = r(n, d2).to(bf)
    seed = _drop_seed()
    kw = dict(dropout_rate=DROP_RATE)
    out = ffn._launch_fwd(*args, seed, DROP_RATE)
    x, w1, b1, w2, _ = args
    grads = ffn._launch_bwd(x, w1, b1, w2, g, seed, DROP_RATE)
    refs = (ffn.fused_ffn_plain(*args, seed, **kw),
            *ffn.fused_ffn_bwd_plain(x, w1, b1, w2, g, seed, **kw))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dx", "dw1", "db1", "dw2", "db2"),
                          (out, *grads), refs):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel(a, b, floor=1e-3) <= BWD_PLAIN_TOL, name
    before = (ffn.fused_ffn.launches, ffn.fused_ffn.bwd_launches)
    _check_grads(lambda *a: ffn.fused_ffn(*a, seed, **kw),
                 lambda *a: ffn.fused_ffn_plain(*a, seed, **kw), args,
                 g.float(), TOL[bf], ("dx", "dw1", "db1", "dw2", "db2"))
    assert (ffn.fused_ffn.launches, ffn.fused_ffn.bwd_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("t", [1, 65, 129, 468])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("chunk", [(0, -1), (16, 4)])
def test_rel_flash_attention_dropout_bf16(gen, t, dh, chunk):
    """K3's three bf16 launches at rate 0.1 (key lengths t, t - 7, 0 and
    -1: fully masked rows included) against rel_flash_attention_fwd_tiled_
    plain and rel_flash_attention_bwd_plain with the same seed: out, dq_u,
    dq_v, dk, dv and dp each within BWD_PLAIN_TOL of max |ref| (floored at
    1e-3); lse the undropped one (rate 0's within 1e-4 on rows with a
    visible key)."""
    cs, lc = chunk
    args = _attention_case(gen, t, dh)
    scale = dh ** -0.5
    seed = _drop_seed()
    kw = dict(scale=scale, chunk_size=cs, left_chunks=lc)
    out, lse = fa._launch_fwd(*args, scale, cs, lc, seed, DROP_RATE)
    g = (torch.randn(out.shape, generator=gen, device="cuda")
         .to(torch.bfloat16))
    got = fa._launch_bwd(*args, out, lse, g, scale, cs, lc, seed, DROP_RATE)
    ref, _ = fa.rel_flash_attention_fwd_tiled_plain(
        *args, seed, dropout_rate=DROP_RATE, block_k=fa.FWD_BLOCK_K, **kw)
    refs = fa.rel_flash_attention_bwd_plain(*args, out, lse, g, seed,
                                            dropout_rate=DROP_RATE, **kw)
    _, lse0 = fa._launch_fwd(*args, scale, cs, lc)
    torch.cuda.synchronize()
    seen = lse0 > -1e29
    assert _rel(lse[seen], lse0[seen]) <= 1e-4
    for name, a, r in zip(("out", "dq_u", "dq_v", "dk", "dv", "dp"),
                          (out, *got), (ref, *refs)):
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=1e-3) <= BWD_PLAIN_TOL, name


# K2's fp32 launches (ffn_f32) and K3's fp32 launches (the register
# micro-tile kernels) at the widths the default ASRConfig gives them (d_model 256,
# d_ff 2048, Dh 64), and K3's WMMA launches in bf16 at Dh 128; one case
# each at rate 0.5, where a wrong mask moves the output far outside the
# tolerance.
WMMA_DROP_CASES = [
    ("K2", torch.float32, 0, 0.1), ("K3", torch.float32, 64, 0.1),
    ("K3", torch.bfloat16, 128, 0.1), ("K2", torch.float32, 0, 0.5),
    ("K3", torch.float32, 64, 0.5)]


def _wmma_drop_case(gen, kernel, dtype, dh, rate, direction, seed):
    """(call, plain outputs, names, kernel names the call must launch) of
    one case of WMMA_DROP_CASES."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    if kernel == "K2":
        n, d, f = 300, 256, 2048
        args = (r(n, d).to(dtype), (r(d, f) * d ** -0.5).to(dtype), r(f) * 0.1,
                (r(f, d) * f ** -0.5).to(dtype), r(d) * 0.1)
        if direction == "fwd":
            return (lambda: (ffn._launch_fwd(*args, seed, rate),),
                    (ffn.fused_ffn_plain(*args, seed, dropout_rate=rate),),
                    ("out",), ("ffn_f32::hidden_kernel<true>",
                               "ffn_f32::out_kernel"))
        x, w1, b1, w2, _ = args
        g = r(n, d).to(dtype)
        return (lambda: ffn._launch_bwd(x, w1, b1, w2, g, seed, rate),
                ffn.fused_ffn_bwd_plain(x, w1, b1, w2, g, seed,
                                        dropout_rate=rate),
                ("dx", "dw1", "db1", "dw2", "db2"),
                ("ffn_f32::rows_kernel<true>", "ffn_f32::dx_kernel",
                 "ffn_f32::dw_kernel"))
    t = 129
    args = [a.to(dtype) if a.is_floating_point() else a
            for a in _attention_case(gen, t, dh)]
    scale = dh ** -0.5
    kw = dict(scale=scale, dropout_rate=rate)
    # fp32 at Dh 64 takes the register micro-tile kernels (rel_f32), bf16
    # at Dh 128 the WMMA ones.
    if dtype == torch.float32:
        kernels = (f"rel_f32::fwd_kernel<{dh}, true>",
                   f"rel_f32::dkv_kernel<{dh}, true>",
                   f"rel_f32::dq_kernel<{dh}, true>")
    else:
        kernels = ("rel_flash_fwd_kernel<__nv_bfloat16, 64, 64, true>",
                   "rel_flash_dkv_kernel<__nv_bfloat16, 32, 32, true>",
                   "rel_flash_dq_kernel<__nv_bfloat16, 32, 32, true>")
    if direction == "fwd":
        if dtype == torch.float32:
            ref = fa.rel_flash_attention_plain(*args, seed, **kw)[0]
        else:
            ref = fa.rel_flash_attention_fwd_tiled_plain(*args, seed,
                                                         block_k=64, **kw)[0]
        return (lambda: fa._launch_fwd(*args, scale, 0, -1, seed, rate)[:1],
                (ref,), ("out",), kernels[:1])
    out, lse = fa._launch_fwd(*args, scale, 0, -1, seed, rate)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (lambda: fa._launch_bwd(*args, out, lse, g, scale, 0, -1, seed,
                                   rate),
            fa.rel_flash_attention_bwd_plain(*args, out, lse, g, seed, **kw),
            ("dq_u", "dq_v", "dk", "dv", "dp"), kernels[1:])


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("kernel,dtype,dh,rate", WMMA_DROP_CASES)
def test_wmma_routes_draw_dropout(gen, kernel, dtype, dh, rate, direction):
    """K2's fp32 launches (N 300, D 256, F 2048) and K3's fp32 and bf16
    Dh-128 launches (B 4, H 2, T 129, key lengths T, T - 7, 0 and -1: fully
    masked rows included) at a rate above 0 against their plain versions with the same seed (K3
    in bf16 against the tiled forward at the kernel's key tile of 64 and
    rel_flash_attention_bwd_plain, the kernels' rounding points): every
    output within TOL of max |ref| (floored at 1e-3 for gradients, as in
    _check_grads); the launches are the dropout instantiations, each once,
    by the host counts."""
    seed = _drop_seed()
    call, refs, names, want = _wmma_drop_case(gen, kernel, dtype, dh, rate,
                                              direction, seed)
    got = call()
    torch.cuda.synchronize()
    for name, a, ref in zip(names, got, refs):
        assert a.shape == ref.shape and a.dtype == ref.dtype, name
        assert torch.isfinite(a).all(), name
        floor = 1e-30 if name == "out" else 1e-3
        assert _rel(a, ref, floor=floor) <= TOL[dtype], name
    assert _instances(call) == dict.fromkeys(want, 1)


def test_draw_seed_takes_a_cpu_generator_for_the_card(gen):
    """A CPU generator draws the card's seeds on the CPU: equal to a CPU
    draw from an equally seeded generator, int32 [1] on the card; a
    generator on the card draws there."""
    from espnet_slurp_tpu_torch.ops.kernels import philox
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    a = philox.draw_seed(g1, torch.device("cuda"))
    assert a.device.type == "cuda" and a.dtype == torch.int32
    assert tuple(a.shape) == (1,)
    assert torch.equal(a.cpu(), philox.draw_seed(g2, torch.device("cpu")))
    b = philox.draw_seed(gen, torch.device("cuda"))
    assert b.device.type == "cuda" and tuple(b.shape) == (1,)


# K2's fp32 launches at N around the 128-row tile (one row, ragged on both
# sides, many tiles), D = D2 from 32 to 512 and F from one 128-column tile
# to the default ASRConfig's 2048, at rate 0 and at DROP_RATE.
F32_FFN_N = (1, 127, 129, 4097)
F32_FFN_D = (32, 64, 256, 512)
F32_FFN_F = (128, 1024, 2048)


def _ffn_f32_case(gen, n, d, f, d2):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return ((r(n, d), r(d, f) * d ** -0.5, r(f) * 0.1, r(f, d2) * f ** -0.5,
             r(d2) * 0.1), r(n, d2))


def _hold_ffn_f32(args, g, rate):
    """The fp32 launches both ways at ``rate`` against fused_ffn_plain /
    fused_ffn_bwd_plain with the same seed: every output within TOL of max
    |ref| (gradients floored at 1e-3)."""
    seed = _drop_seed() if rate else None
    x, w1, b1, w2, _ = args
    got = (ffn._launch_fwd(*args, seed, rate),
           *ffn._launch_bwd(x, w1, b1, w2, g, seed, rate))
    refs = (ffn.fused_ffn_plain(*args, seed, dropout_rate=rate),
            *ffn.fused_ffn_bwd_plain(x, w1, b1, w2, g, seed,
                                     dropout_rate=rate))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got,
                          refs):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        floor = 1e-30 if name == "out" else 1e-3
        assert _rel(a, b, floor=floor) <= TOL[torch.float32], name


@pytest.mark.parametrize("rate", [0.0, DROP_RATE])
@pytest.mark.parametrize("f", F32_FFN_F)
@pytest.mark.parametrize("d", F32_FFN_D)
@pytest.mark.parametrize("n", F32_FFN_N)
def test_fused_ffn_fp32_launches(gen, n, d, f, rate):
    """K2's fp32 launches (ffn_f32, D2 = D) against the plain versions at
    rate 0 and DROP_RATE with the same seed, within TOL."""
    _hold_ffn_f32(*_ffn_f32_case(gen, n, d, f, d), rate)


@pytest.mark.parametrize("n,d,f,d2", [
    # D != D2, F ragged against the 128-column tile (160, 96) and the
    # 64-column rows tile (96), widths that are not powers of two (48)
    (129, 48, 160, 32), (300, 64, 96, 512), (4097, 512, 160, 48),
    (200, 256, 2048, 64)])
@pytest.mark.parametrize("rate", [0.0, DROP_RATE])
def test_fused_ffn_fp32_uneven_widths(gen, n, d, f, d2, rate):
    """The fp32 launches at uneven widths, within TOL of the plain versions;
    every launch once by the host counts (hidden and out forward, rows, dx
    and dw backward; the dropout instantiations at a rate above 0)."""
    args, g = _ffn_f32_case(gen, n, d, f, d2)
    _hold_ffn_f32(args, g, rate)
    seed = _drop_seed() if rate else None
    x, w1, b1, w2, _ = args
    launched = _instances(lambda: (ffn._launch_fwd(*args, seed, rate),
                                   ffn._launch_bwd(x, w1, b1, w2, g, seed,
                                                   rate)))
    flag = "true>" if rate else "false>"
    assert launched == dict.fromkeys((
        "ffn_f32::hidden_kernel<" + flag, "ffn_f32::out_kernel",
        "ffn_f32::rows_kernel<" + flag, "ffn_f32::dx_kernel",
        "ffn_f32::dw_kernel"), 1)


@pytest.mark.parametrize("rate", [DROP_RATE, 0.5])
def test_fused_ffn_fp32_draws_the_philox_mask(gen, rate):
    """The fp32 forward's hidden launch keeps exactly the elements of
    ops/kernels/philox.py:keep_mask: with W2 the identity and b2 0, out is
    the dropped hidden itself (each output one exact product), zero where
    the mask drops."""
    from espnet_slurp_tpu_torch.ops.kernels import philox
    n, d, f = 300, 64, 128
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, w1, b1 = r(n, d), r(d, f) * d ** -0.5, r(f) * 0.1
    eye, zero = torch.eye(f, device="cuda"), torch.zeros(f, device="cuda")
    seed = _drop_seed()
    out = ffn._launch_fwd(x, w1, b1, eye, zero, seed, rate)
    torch.cuda.synchronize()
    keep = philox.keep_mask(seed, rate, n, f)
    assert torch.equal(out != 0, keep)
    ref = ffn.fused_ffn_plain(x, w1, b1, eye, zero, seed, dropout_rate=rate)
    assert _rel(out, ref) <= TOL[torch.float32]


def test_fused_ffn_fp32_kernel_info(gen):
    """Each fp32 launch (hidden and rows at rate 0 and with dropout, out,
    dx, dw) reports its registers, a static shared-memory ring, no local
    (spill) bytes and at least one block per SM; an unknown index is
    refused."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    for which in range(7):
        info = (ctypes.c_int * 4)()
        assert lib.espnet_fused_ffn_f32_info(which, info) == 0
        regs, smem, local, blocks = info
        assert 0 < regs <= 255 and smem > 0 and local == 0 and blocks >= 1
    assert lib.espnet_fused_ffn_f32_info(7, (ctypes.c_int * 4)()) != 0


@pytest.mark.parametrize("n,d,f,d2,want", [
    # the default ASRConfig's step on 132 SMs: 64 dW tiles x 4 splits fill
    # 256 of 264 block slots
    (64 * 468, 256, 2048, 256, 4),
    # the flagship's widths in fp32: 32 tiles x 8
    (64 * 468, 256, 1024, 256, 8),
    # d_model 512: 128 tiles x 2
    (64 * 468, 512, 2048, 512, 2),
    # fewer rows than two splits take; narrow widths bound by rows
    (2 * 150, 256, 2048, 256, 1), (5000, 48, 160, 32, 4),
    # more tiles than slots
    (64 * 468, 4096, 4096, 4096, 1)])
def test_fused_ffn_fp32_dw_splits_fill_the_card(gen, n, d, f, d2, want):
    """The library's plan of the fp32 dW launch's splits of N on a card of
    132 SMs, dw_kernel at two blocks an SM: as many as fill the block slots
    with (dW1 + dW2 tiles) x splits, each split at least 1024 rows, at
    least one; bad arguments give a negated error code."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    info = (ctypes.c_int * 4)()
    assert lib.espnet_fused_ffn_f32_info(6, info) == 0
    assert info[3] == 2
    got = lib.espnet_fused_ffn_f32_dw_splits(n, d, f, d2, 132)
    assert got == want
    tile = lambda a: -(-a // 128)
    blocks = got * (tile(d) * tile(f) + tile(f) * tile(d2))
    assert got == 1 or blocks <= 132 * info[3]
    assert got == 1 or n // got >= 1024
    assert lib.espnet_fused_ffn_f32_dw_splits(n, d, f, d2, 0) < 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ffn_backward_refuses_a_misaligned_cotangent(gen, dtype):
    """A cotangent g that starts off a 16-byte boundary (a contiguous view
    at an odd offset) raises before the backward launches: its loads are
    16-byte vectors."""
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    x = rnd(256, 64).to(dtype).requires_grad_(True)
    w1, w2 = (rnd(64, 128) * 0.1).to(dtype), (rnd(128, 64) * 0.1).to(dtype)
    b1 = torch.zeros(128, device="cuda")
    b2 = torch.zeros(64, device="cuda")
    out = ffn.fused_ffn(x, w1, b1, w2, b2)
    g = torch.ones(out.numel() + 1, dtype=dtype, device="cuda")[1:]
    g = g.view_as(out)
    assert g.is_contiguous() and g.data_ptr() % 16
    with pytest.raises(ValueError, match="g must start on a 16-byte"):
        out.backward(g)


def test_fused_ffn_fp32_takes_what_its_launches_take(gen):
    """fused_ffn_takes in fp32: D and D2 multiples of 16 and F of 32, any
    width (d_model 512 / d_ff 2048 too); F 80 and D 40 refused."""
    f32 = torch.float32
    assert ffn.fused_ffn_takes(29952, 256, 2048, 256, f32)
    assert ffn.fused_ffn_takes(1, 512, 2048, 512, f32)
    assert ffn.fused_ffn_takes(100, 48, 160, 16, f32)
    assert not ffn.fused_ffn_takes(8, 64, 80, 64, f32)
    assert not ffn.fused_ffn_takes(8, 40, 128, 64, f32)
    assert not ffn.fused_ffn_takes(8, 64, 128, 40, f32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,f,routes", [
    (512, 2048, {torch.bfloat16: "eager", torch.float32: "K2"}),
    (256, 1024, {torch.bfloat16: "K2", torch.float32: "K2"}),
    (48, 128, {torch.bfloat16: "eager", torch.float32: "K2"})])
def test_feedforward_routes_by_width(gen, dtype, d, f, routes):
    """models/conformer.py:FeedForward asks fused_ffn_takes before any
    launch: d_model 512 / d_ff 2048 (bench.py's 17 x 512 config) takes the
    eager route in bf16 (output width 512 has no register tile) and K2 in
    fp32 (its launches take any width whose multiples fit), D2 48 the
    eager route in bf16 too; the flagship's widths take K2. Forward and backward within TOL of the plain
    version's autograd on the same weights."""
    from espnet_slurp_tpu_torch.models.conformer import FeedForward
    torch.manual_seed(0)
    mod = FeedForward(d, f, use_flash=True).cuda()
    x0 = torch.randn(4, 100, d, generator=gen, device="cuda")
    cot = torch.randn(4, 100, d, generator=gen, device="cuda").to(dtype)
    x = x0.to(dtype).requires_grad_(True)
    before = (ffn.fused_ffn.launches, ffn.fused_ffn.bwd_launches)
    out = mod(x)
    out.backward(cot)
    moved = (ffn.fused_ffn.launches - before[0],
             ffn.fused_ffn.bwd_launches - before[1])
    assert moved == ((1, 1) if routes[dtype] == "K2" else (0, 0))
    w = [mod.w1.weight, mod.w1.bias, mod.w2.weight, mod.w2.bias]
    leaves = [x0.to(dtype).requires_grad_(True)] + [
        p.detach().clone().requires_grad_(True) for p in w]
    ref = ffn.fused_ffn_plain(leaves[0], leaves[1].t().to(dtype), leaves[2],
                              leaves[3].t().to(dtype), leaves[4])
    ref.backward(cot)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= TOL[dtype]
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"),
                          [x.grad] + [p.grad for p in w],
                          [a.grad for a in leaves]):
        assert _rel(a, r, floor=1e-3) <= TOL[dtype], name


def _lattice_case(gen, t, u_lens, v=9):
    """Log-prob emissions of label sequences with repeats, U = 0 and U > T
    rows among them."""
    b, u = len(u_lens), max(max(u_lens), 1)
    lp = torch.log_softmax(torch.randn(b, t, v, generator=gen,
                                       device="cuda"), -1)
    labels = torch.randint(1, v, (b, u), generator=gen, device="cuda")
    labels[:, 1::3] = labels[:, ::3][:, :labels[:, 1::3].shape[1]]
    ulen = torch.tensor(u_lens, device="cuda")
    tlen = torch.tensor([max(t - 3 * i, 1) for i in range(b)], device="cuda")
    from espnet_slurp_tpu_torch.ops.kernels.ctc import (extend_labels,
                                                        mask_emit)
    ext, skip, smax, last = extend_labels(labels, ulen)
    emit = mask_emit(lp.gather(2, ext[:, None, :].expand(b, t, -1)), smax)
    return emit.contiguous(), skip, tlen.to(torch.int32), last


@pytest.mark.parametrize("t", [1, 17, 65, 130])
@pytest.mark.parametrize("u_lens", [(0,), (3, 0, 5, 40), (1, 2, 7)])
def test_ctc_lattice(gen, t, u_lens):
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
    emit, skip, tlen, last = _lattice_case(gen, t, u_lens)
    # Rows whose likelihood saturates get g = 0, as zero_infinity gives them.
    ref_loss = kctc.ctc_lattice_plain(emit, skip, tlen, last)
    cot = torch.where(ref_loss < 1e29, torch.rand(ref_loss.shape,
                                                  generator=gen,
                                                  device="cuda"), 0.0)
    before = (kctc.ctc_lattice.launches, kctc.ctc_lattice.bwd_launches)
    args = (emit, skip, tlen, last)
    out, (g,) = _grads(kctc.ctc_lattice, args, cot, n_diff=1)
    _, (g_ref,) = _grads(kctc.ctc_lattice_plain, args, cot, n_diff=1)
    torch.cuda.synchronize()
    assert (kctc.ctc_lattice.launches, kctc.ctc_lattice.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ok = ref_loss < 1e29
    assert torch.equal(ok, out < 1e29)
    assert _rel(out[ok], ref_loss[ok]) <= 1e-4 if ok.any() else True
    assert torch.isfinite(g).all()
    assert torch.equal(g[~ok], torch.zeros_like(g[~ok]))
    assert _rel(g, g_ref) <= 1e-4 if g_ref.abs().max() > 0 else \
        torch.equal(g, g_ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,v", [(1, 128, 77), (17, 256, 130),
                                   (65, 128, 5000), (130, 256, 333),
                                   # the KA2G recipe's D: a 16-wide K tail
                                   # past the bf16 gemms' BK 32
                                   (37, 144, 301)])
def test_fused_ctc_head(gen, dtype, t, d, v):
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    b, s = 3, 2 * 9 + 1
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    ext = torch.randint(0, v, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    ext[:, ::2] = 0  # blanks: one label, many states
    ext[:, 3] = ext[:, 5]  # a repeated label
    args = ((r(b, t, d) * 0.5).to(dtype), (r(v, d) * d ** -0.5).to(dtype),
            r(v) * 0.1, ext)
    before = (kh.fused_ctc_head_emit.launches,
              kh.fused_ctc_head_emit.bwd_launches)
    _check_grads(kh.fused_ctc_head_emit, kh.fused_ctc_head_emit_plain, args,
                 r(b, t, s), TOL[dtype], ("dhs", "dw", "db"))
    assert (kh.fused_ctc_head_emit.launches,
            kh.fused_ctc_head_emit.bwd_launches) == (before[0] + 1,
                                                     before[1] + 1)


@pytest.mark.parametrize("b,t,d,v", [
    # 128-row tiles that span 8 utterances (T 17), two (T 100: a boundary
    # inside a tile), and the flagship train shape (T 468, V 5000); V 77,
    # 130 and 333 ragged against 128-column tiles and not multiples of 8
    (8, 17, 128, 77), (3, 100, 256, 130), (2, 129, 64, 333),
    (64, 468, 256, 5000)])
def test_fused_ctc_head_bwd_bf16_at_its_rounding_points(gen, b, t, d, v):
    """The bf16 backward (ctc_head_bwd's rows, dx and dw kernels once each,
    by the host counts) against fused_ctc_head_emit_bwd_plain, which rounds dlg
    where they do: within BWD_PLAIN_TOL of max |ref| per output."""
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    bf, s = torch.bfloat16, 2 * 9 + 1
    ext = torch.randint(0, v, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    ext[:, ::2] = 0  # blanks: one label, many states
    ext[:, 3] = ext[:, 5]  # a repeated label
    ext[0, 1] = v - 1  # the last, ragged column
    hs, w, bias = (r(b, t, d) * 0.5).to(bf), (r(v, d) * d ** -0.5).to(bf), \
        r(v) * 0.1
    g = r(b, t, s)
    _, z = kh._launch_fwd(hs, w, bias, ext)
    before = kh.fused_ctc_head_emit.bwd_launches
    out = kh._launch_bwd(hs, w, bias, ext, z, g)
    assert kh.fused_ctc_head_emit.bwd_launches == before + 1
    ref = kh.fused_ctc_head_emit_bwd_plain(hs, w, bias, ext, z, g)
    torch.cuda.synchronize()
    for name, a, e in zip(("dhs", "dw", "db"), out, ref):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel(a, e) <= BWD_PLAIN_TOL, name
    assert _instances(lambda: kh._launch_bwd(hs, w, bias, ext, z, g)) == {
        f"ctc_head_bwd::{part}_kernel": 1 for part in ("rows", "dx", "dw")}


# K4's fp32 launches (csrc/ctc_head.cu, ctc_head_f32) by their host counts.
CTC_HEAD_F32 = ("ctc_head_f32::lse_kernel", "ctc_head_fwd::gather_kernel<float>",
                "ctc_head_f32::rows_kernel", "ctc_head_f32::dx_kernel",
                "ctc_head_f32::dw_kernel")


def _ctc_head_f32_case(gen, b, t, d, v, s=2 * 9 + 1):
    """fp32 hs, w [V, D], bias, ext and a cotangent [B, T, S]: blanks on
    every other state, a repeated label and the last, ragged column V - 1."""
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    ext = torch.randint(0, v, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    ext[:, ::2] = 0  # blanks: one label, many states
    ext[:, 3] = ext[:, 5]  # a repeated label
    ext[0, 1] = v - 1  # the last, ragged column
    return (r(b, t, d) * 0.5, r(v, d) * d ** -0.5, r(v) * 0.1, ext), \
        r(b, t, s)


@pytest.mark.parametrize("b,t,d,v", [
    # 128-row tiles that span 8 utterances (T 17) and two (T 100); V 77,
    # 130 and 333 ragged against 128-column tiles and not multiples of 4,
    # 333 in 3 V splits; the default train shape (lse in 10 V splits on 132
    # SMs, dW in 3)
    (8, 17, 128, 77), (3, 100, 256, 130), (2, 129, 64, 333),
    (64, 468, 256, 5000)])
def test_fused_ctc_head_fp32_route(gen, b, t, d, v):
    """K4's fp32 route (ctc_head_f32's lse, the fp32 gather forward,
    ctc_head_f32's rows, dx and dw backward, once each and nothing else by
    the host counts) against fused_ctc_head_emit_plain's output and autograd
    gradients within TOL of max |ref|, one launch each way a call."""
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    args, cot = _ctc_head_f32_case(gen, b, t, d, v)
    before = (kh.fused_ctc_head_emit.launches,
              kh.fused_ctc_head_emit.bwd_launches)
    _check_grads(kh.fused_ctc_head_emit, kh.fused_ctc_head_emit_plain, args,
                 cot, TOL[torch.float32], ("dhs", "dw", "db"))
    assert (kh.fused_ctc_head_emit.launches,
            kh.fused_ctc_head_emit.bwd_launches) == (before[0] + 1,
                                                     before[1] + 1)
    hs, w, bias, ext = args
    _, z = kh._launch_fwd(*args)
    assert _instances(lambda: (kh._launch_fwd(*args), kh._launch_bwd(
        hs, w, bias, ext, z, cot))) == {k: 1 for k in CTC_HEAD_F32}


def test_fused_ctc_head_fp32_plan_and_kernel_info(gen):
    """The library's plan at the flagship / default train shape on 132 SMs,
    in both dtypes: lse in 10 V splits of 4 tiles (2,340 blocks in 9 waves
    of 264 against 40 tiles for the 234 row tiles alone) and dW in 3 splits
    of N (240 of 264 slots); one row tile takes one split each. Each launch
    of either dtype reports registers, shared bytes, no spills and two
    blocks an SM (gather more); an unknown index or dtype is refused."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    out = (ctypes.c_int * 2)()
    for dtype in (0, 1):
        assert lib.espnet_ctc_head_plan(dtype, 64 * 468, 256, 5000, 132,
                                        out) == 0
        assert list(out) == [10, 3]
        assert lib.espnet_ctc_head_plan(dtype, 100, 256, 77, 132, out) == 0
        assert list(out) == [1, 1]
        assert lib.espnet_ctc_head_plan(dtype, 64 * 468, 256, 5000, 0,
                                        out) != 0
        for which in range(5):
            info = (ctypes.c_int * 4)()
            assert lib.espnet_ctc_head_info(dtype, which, info) == 0
            regs, smem, local, blocks = info
            assert 0 < regs <= 255 and smem > 0 and local == 0, (
                dtype, which, *info)
            assert blocks >= 2, (dtype, which, *info)
        assert lib.espnet_ctc_head_info(dtype, 5, (ctypes.c_int * 4)()) != 0
    assert lib.espnet_ctc_head_info(2, 0, (ctypes.c_int * 4)()) != 0


def _counts(names):
    from espnet_slurp_tpu_torch.ops.kernels import build
    return {k: build.launch_count(k) for k in names}


K1_ROUTES = tuple(f"ctc_{r}::{k}_kernel" for r in ("warp", "block")
                  for k in ("fwd", "bwd"))


@pytest.mark.parametrize("s", [1, 3, 32, 33, 129, 255, 256, 257, 1000,
                               3072])
def test_ctc_lattice_routes(gen, s):
    """K1 both ways against ctc_lattice_plain (loss and autograd gradient
    within 1e-4 of max |ref|) on either side of the warp route's limit
    (256 states): rows with every skip allowed (T = S / 2 + 40 frames make
    the last state reachable), tlen 0 and 1, every skip off with empty
    labels (last 0), a cotangent of 0; one launch each way, by the host
    counts of the route the library takes for S."""
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
    b, t = 5, s // 2 + 40
    lp = torch.log_softmax(torch.randn(b, t, 7, generator=gen,
                                       device="cuda") * 2, -1)
    idx = torch.randint(0, 7, (b, s), generator=gen, device="cuda")
    emit = lp.gather(2, idx[:, None, :].expand(b, t, s)).contiguous()
    skip = (torch.rand(b, s, generator=gen, device="cuda") > 0.3).float()
    skip[0] = 1.0
    skip[2] = 0.0
    tlen = torch.tensor([t, 0, 1, t - 3, t // 2], dtype=torch.int32,
                        device="cuda")
    last = torch.tensor([s - 1, min(s - 1, 4), 0, s // 2, s - 1],
                        dtype=torch.int32, device="cuda")
    ref_loss = kctc.ctc_lattice_plain(emit, skip, tlen, last)
    cot = torch.rand(b, generator=gen, device="cuda")
    cot[3] = 0.0
    cot = torch.where(ref_loss < 1e29, cot, 0.0)
    route = "warp" if s <= kctc.warp_states() else "block"
    before = _counts(K1_ROUTES)
    args = (emit, skip, tlen, last)
    out, (g,) = _grads(kctc.ctc_lattice, args, cot, n_diff=1)
    _, (g_ref,) = _grads(kctc.ctc_lattice_plain, args, cot, n_diff=1)
    torch.cuda.synchronize()
    after = _counts(K1_ROUTES)
    assert {k: after[k] - before[k] for k in K1_ROUTES} == {
        k: int(f"ctc_{route}::" in k) for k in K1_ROUTES}
    ok = ref_loss < 1e29
    assert ok[0] and ok[2], ref_loss
    assert torch.equal(ok, out < 1e29)
    assert _rel(out[ok], ref_loss[ok]) <= 1e-4
    assert torch.isfinite(g).all()
    assert torch.equal(g[1], torch.zeros_like(g[1]))  # tlen 0
    assert torch.equal(g[3], torch.zeros_like(g[3]))  # g 0
    assert torch.equal(g[4, t // 2:], torch.zeros_like(g[4, t // 2:]))
    assert _rel(g, g_ref) <= 1e-4


def test_ctc_lattice_kernel_info(gen):
    """The warp route's kernels at the flagship S 129 (J 5 states a lane)
    and the block route's at 257: registers, shared bytes, no spills, at
    least one block an SM; an S past 3072 is refused."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    lib = build.library()
    assert lib.espnet_ctc_warp_states() == 256
    for s in (129, 256, 257, 3072):
        for which in (0, 1):
            info = (ctypes.c_int * 4)()
            assert lib.espnet_ctc_info(which, s, info) == 0
            regs, smem, local, blocks = info
            assert 0 < regs <= 255 and local == 0 and blocks >= 1, (
                s, which, *info)
            assert smem > 0, (s, which, *info)
    assert lib.espnet_ctc_info(0, 3073, (ctypes.c_int * 4)()) != 0


# K4's bf16 forward launches by the names of their host counts (also parts
# of their profiler names).
CTC_HEAD_BF16_FWD = ("ctc_head_bf16::lse_kernel",
                     "ctc_head_fwd::gather_kernel<__nv_bfloat16>")


@pytest.mark.parametrize("b,t,d,v", [
    # as test_fused_ctc_head_fp32_route: 128-row tiles over 8 utterances
    # and over two, V ragged against 128-column tiles (333 in 3 V splits),
    # and the flagship train shape (10 V splits on 132 SMs)
    (8, 17, 128, 77), (3, 100, 256, 130), (2, 129, 64, 333),
    (64, 468, 256, 5000),
    # the KA2G recipe's D 144 (a K tail of 16 past BK 32) at its B 48
    (48, 75, 144, 301)])
def test_fused_ctc_head_bf16_forward(gen, b, t, d, v):
    """K4's bf16 forward (lse on the mma.sync mainloop, then the gather)
    against fused_ctc_head_emit_plain on the same bf16 operands, emit and
    z: the same fp32 arithmetic up to summation order, within 1e-4 of max
    |ref|. One launch of each a call, by the host counts; the fp32 route's
    launches not."""
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    args, _ = _ctc_head_f32_case(gen, b, t, d, v)
    hs, w, bias, ext = args[0].to(torch.bfloat16), args[1].to(
        torch.bfloat16), args[2], args[3]
    names = CTC_HEAD_BF16_FWD + ("ctc_head_f32::lse_kernel",
                                 "ctc_head_fwd::gather_kernel<float>")
    before = _counts(names)
    emit, z = kh._launch_fwd(hs, w, bias, ext)
    torch.cuda.synchronize()
    after = _counts(names)
    assert {k: after[k] - before[k] for k in names} == {
        k: int(k in CTC_HEAD_BF16_FWD) for k in names}
    assert _rel(emit, kh.fused_ctc_head_emit_plain(hs, w, bias, ext)) <= 1e-4
    ref_z = torch.logsumexp(hs.float() @ w.float().t() + bias, -1)
    assert _rel(z, ref_z) <= 1e-4


def test_fused_ctc_head_refuses_what_it_cannot_take(gen):
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    bf = torch.bfloat16
    ext = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # D not a multiple of 16
        kh.fused_ctc_head_emit(r(2, 5, 40).to(bf), r(77, 40).to(bf), r(77),
                               ext)


# ---- The transducer slice's kernels (K5, K6) ---------------------------------


K5_ROUTES = tuple(f"rnnt_{r}::{k}_kernel" for r in ("warp", "block")
                  for k in ("fwd", "bwd"))


@pytest.mark.parametrize("b,t,u1", [
    (5, 40, 1), (5, 40, 2), (5, 40, 33), (5, 40, 65), (5, 40, 129),
    (5, 40, 256), (5, 40, 257), (5, 40, 300),
    (32, 468, 65)])  # the transducer train step's lattice
def test_rnnt_lattice(gen, b, t, u1):
    """K5 against its plain version: U1 within a warp, across warps, at the
    warp route's limit (256) and past it, and at the transducer train
    step's lattice (B 32, T' 468, U1 65, tlen T' - 3 b, ulen 64 - b % 5);
    the small cases with rows of tlen 0, 1 and T and ulen 0; a zero
    cotangent on the last row (exact zero gradients there and at frames
    past tlen). One launch each way, by the host counts of the route the
    library takes for U1: one warp per utterance up to 256, one block past
    it."""
    from espnet_slurp_tpu_torch.ops.kernels import transducer as kt
    lp = torch.log_softmax(torch.randn(b, t, u1, 6, generator=gen,
                                       device="cuda"), -1)
    blank = lp[..., 0].contiguous()
    emit = lp[..., 1].clone()
    emit[..., -1] = kt.NEG
    if b == 5:
        tlen = [t, 1, 0, t - 13, t]
        ulen = [u1 - 1, min(3, u1 - 1), 0, 0, (u1 - 1) // 2]
    else:
        tlen = [t - 3 * i for i in range(b)]
        ulen = [u1 - 1 - i % 5 for i in range(b)]
    tlen = torch.tensor(tlen, dtype=torch.int32, device="cuda")
    ulen = torch.tensor(ulen, dtype=torch.int32, device="cuda")
    cot = torch.rand(b, generator=gen, device="cuda")
    cot[-1] = 0.0
    args = (blank, emit, tlen, ulen)
    route = "warp" if u1 <= kt.warp_states() else "block"
    before = (kt.rnnt_lattice.launches, kt.rnnt_lattice.bwd_launches)
    counts = _counts(K5_ROUTES)
    out, grads = _grads(kt.rnnt_lattice, args, cot, n_diff=2)
    torch.cuda.synchronize()
    after = _counts(K5_ROUTES)
    ref, ref_grads = _grads(kt.rnnt_lattice_plain, args, cot, n_diff=2)
    assert (kt.rnnt_lattice.launches, kt.rnnt_lattice.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert {k: after[k] - counts[k] for k in K5_ROUTES} == {
        k: int(f"rnnt_{route}::" in k) for k in K5_ROUTES}
    assert _rel(out, ref) <= 1e-4
    assert all(float(out[i]) == 0.0 for i in range(b) if tlen[i] == 0)
    frames = torch.arange(t, device="cuda")[None, :, None]
    dead = (frames >= tlen.long()[:, None, None]) | (cot == 0)[:, None, None]
    for name, g, r in zip(("dblank", "demit"), grads, ref_grads):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r, floor=1e-3) <= 1e-4, name
        assert torch.equal(g[dead.expand_as(g)],
                           torch.zeros_like(g[dead.expand_as(g)])), name


def test_rnnt_lattice_kernel_info(gen):
    """The warp route's kernels at U1 65 (J 3 states a lane) and 256 (J 8)
    and the block route's at 257 and 3072: registers, shared bytes, no
    spills, at least one block an SM; a U1 past 3072 is refused."""
    from espnet_slurp_tpu_torch.ops.kernels import transducer as kt
    assert kt.warp_states() == 256
    for u1 in (65, 256, 257, 3072):
        for which in (0, 1):
            regs, smem, local, blocks = kt.info(which, u1)
            assert 0 < regs <= 255 and smem > 0 and local == 0, (
                u1, which, regs, smem, local)
            assert blocks >= 1, (u1, which, blocks)
    with pytest.raises(RuntimeError):
        kt.info(0, 3073)


# K6's launches by dtype and direction, by their host-side launch counts
# (csrc/common.cuh's counted).
K6_LAUNCHES = {
    torch.bfloat16: (("conv_bf16::glu_kernel", "conv_bf16::out_kernel"),
                     ("conv_bf16::glu_sig_kernel", "conv_bf16::rows_kernel",
                      "conv_bf16::du_kernel", "conv_bf16::dx_kernel",
                      "conv_bf16::dw_kernel", "conv_bf16::sum_kernel")),
    torch.float32: (("conv_f32::glu_kernel", "conv_f32::norm_kernel",
                     "conv_f32::out_kernel"),
                    ("conv_f32::glu_sig_kernel", "conv_f32::dsw_kernel",
                     "conv_f32::rows_kernel", "conv_f32::du_kernel",
                     "conv_f32::dx_kernel", "conv_f32::dw_kernel",
                     "conv_f32::sum_kernel"))}
K6_NAMES = ("dx", "dw1", "db1", "dwdw", "dbdw", "dgamma", "dbeta", "dw2",
            "db2")


def _conv_case(gen, dtype, b, t, d, k):
    """(x, w1, b1, wdw, bdw, gamma, beta, w2, b2) and a cotangent."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    args = (r(b, t, d).to(dtype), (r(2 * d, d) * d ** -0.5).to(dtype),
            r(2 * d) * 0.1,
            r(d, k) * k ** -0.5, r(d) * 0.1, 1.0 + 0.1 * r(d), r(d) * 0.1,
            (r(d, d) * d ** -0.5).to(dtype), r(d) * 0.1)
    return args, r(b, t, d)


def _check_conv(kc, args, lengths, cot, dtype, kw):
    """K6 both ways against the plain version's autograd (TOL), the bf16
    backward also against fused_conv_module_bwd_plain (BWD_PLAIN_TOL), and
    its route: each of dtype's launches once each way (host counts), no
    other K6 launch."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    every = [n for ways in K6_LAUNCHES.values() for w in ways for n in w]
    before = {n: build.launch_count(n) for n in every}
    calls = (kc.fused_conv_module.launches,
             kc.fused_conv_module.bwd_launches)
    out, grads = _grads(
        lambda x, *p: kc.fused_conv_module(x, lengths, *p, **kw), args, cot)
    torch.cuda.synchronize()
    got = {n: build.launch_count(n) - before[n] for n in every}
    want = {n: int(n in K6_LAUNCHES[dtype][0] + K6_LAUNCHES[dtype][1])
            for n in every}
    assert got == want
    assert (kc.fused_conv_module.launches,
            kc.fused_conv_module.bwd_launches) == (calls[0] + 1, calls[1] + 1)
    ref, ref_grads = _grads(
        lambda x, *p: kc.fused_conv_module_plain(x, lengths, *p, **kw), args,
        cot)
    assert _rel(out, ref) <= TOL[dtype], "output"
    for name, a, r in zip(K6_NAMES, grads, ref_grads):
        assert torch.isfinite(a).all(), name
        assert _rel(a, r, floor=1e-3) <= TOL[dtype], name
    if dtype == torch.bfloat16:
        plain = kc.fused_conv_module_bwd_plain(
            args[0], lengths, *args[1:-1], cot.to(dtype), **kw)
        for name, a, r in zip(K6_NAMES, grads, plain):
            assert _rel(a, r, floor=1e-3) <= BWD_PLAIN_TOL, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,causal", [(3, False), (15, False), (31, False),
                                      (3, True), (15, True), (31, True),
                                      (33, True)])
@pytest.mark.parametrize("t,d", [(37, 64), (100, 256)])
def test_fused_conv_module(gen, dtype, k, causal, t, d):
    """K6 forward and backward against its plain version: T not a tile
    multiple, lengths 0, 1 and full, every gradient (x and the nine
    parameters), k past one 32-tap chunk (33), the route by host counts;
    bf16 also against the backward at the reference's rounding points."""
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    lengths = torch.tensor([t, 1, 0, t - 5], dtype=torch.int32,
                           device="cuda")
    args, cot = _conv_case(gen, dtype, 4, t, d, k)
    _check_conv(kc, args, lengths, cot, dtype,
                dict(kernel_size=k, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,d", [(2, 64, 128), (3, 468, 256)])
def test_fused_conv_module_without_lengths(gen, dtype, b, t, d):
    """lengths=None (every frame valid), T a tile multiple and the
    transducer's T' 468."""
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    args, cot = _conv_case(gen, dtype, b, t, d, 31)
    _check_conv(kc, args, None, cot, dtype,
                dict(kernel_size=31, causal=False))


@pytest.mark.parametrize("k,causal", [(31, False), (33, True)])
def test_fused_conv_module_fp32_at_d512(gen, k, causal):
    """The fp32 route at its widest D (512: rows_kernel's 512 threads, a
    channel each), ragged lengths, k 31 and past one 32-tap chunk."""
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    t = 70
    lengths = torch.tensor([t, 33], dtype=torch.int32, device="cuda")
    args, cot = _conv_case(gen, torch.float32, 2, t, 512, k)
    _check_conv(kc, args, lengths, cot, torch.float32,
                dict(kernel_size=k, causal=causal))


def test_fused_conv_module_refuses_what_it_cannot_take(gen):
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")

    def args(d, k):
        return (r(2, 9, d), None, r(2 * d, d), r(2 * d), r(d, k), r(d),
                r(d), r(d), r(d, d), r(d))
    with pytest.raises(ValueError):  # D not a multiple of 64
        kc.fused_conv_module(*args(96, 3), kernel_size=3)
    with pytest.raises(ValueError):  # SAME padding with an even kernel
        kc.fused_conv_module(*args(64, 4), kernel_size=4)
    with pytest.raises(RuntimeError):  # D past the routes' 512
        kc.fused_conv_module(*args(576, 3), kernel_size=3)
