"""The port's CUDA kernels against their plain versions, on the card, at
edge shapes the serving path's smoke run does not reach: a single row,
ragged N, narrow widths, T shorter than a tile or just past one, Dh 32 to
128, key lengths of 0 and below (Speech2Text's padding rows), chunk masks.

Needs a CUDA device and nvcc; skips otherwise. The tests directory's
conftest imports JAX, which the card's machine lacks, so run there with:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
Tolerances are relative to max |ref|: 2e-2 in bf16 (rounding of the hidden
or the probabilities before the second product) and 1e-4 in fp32.
"""
import pytest
import torch

from espnet_slurp_tpu_torch.ops.kernels import ffn
from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30)).item()


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


def test_fused_ffn_refuses_what_it_cannot_take(gen):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, w1, b1, w2, b2 = r(8, 64), r(64, 80), r(80), r(80, 64), r(64)
    with pytest.raises(ValueError):  # F not a multiple of the chunk
        ffn.fused_ffn(x, w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ffn.fused_ffn(r(8, 128)[:, :64], r(64, 128), r(128), r(128, 64),
                      b2)


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
