"""The dropout keep masks of kernels K2 and K3 (ops/kernels/philox.py).

ops/kernels/philox.py is the plain version of csrc/philox.cuh, the
Philox4x32-10 draw that K2's and K3's bf16 launches make in the kernel; on
the card chip_smoke.py holds the device mask to it bit for bit. Here:
Random123's answer vectors, the keep rate against its binomial spread, the
mask of a block equal to the same block of a larger mask (an element's bits
depend on its coordinates only, never on a tile), and seeds that differ.
"""
import numpy as np
import pytest
import torch

from espnet_slurp_tpu_torch.ops.kernels import philox
import torch_parity  # noqa: F401  (each test worker's CPU threads)

# Random123's kat_vectors for philox4x32_10: counter, key, output.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _seed(v):
    return torch.tensor([v], dtype=torch.int32)


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_answer_vectors(counter, key, want):
    c = [torch.tensor(v, dtype=torch.int64) for v in counter]
    k = [torch.tensor(v, dtype=torch.int64) for v in key]
    got = [int(w) for w in philox.philox4x32_10(c, k)]
    assert got == list(want), [f"{w:08x}" for w in got]


def test_keep_rate_within_six_sigma():
    """2^20 draws at rate 0.1: the kept share within 6 sigma of 0.9. The
    16-bit draw keeps 1 - floor(0.1 * 2^16) / 2^16 = 0.9000092, within
    1e-4 of 0.9."""
    keep = philox.keep_mask(_seed(7), 0.1, 1024, 1024)
    n = keep.numel()
    assert n == 2 ** 20
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(float(keep.float().mean()) - 0.9) <= 6 * sigma
    assert abs(philox.keep_probability(0.1) - 0.9) <= 1e-4


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.1, 0.3, 0.5, 0.9])
def test_keep_probability_within_1e4_of_one_minus_rate(rate):
    assert abs(philox.keep_probability(rate) - (1.0 - rate)) <= 1e-4


@pytest.mark.parametrize("planes", [None, 5])
def test_mask_of_a_block_is_the_block_of_the_mask(planes):
    """Rows 37..100, columns 5..299 (and planes 2..4) drawn alone equal that
    block of the full mask: no 16-row or 16-column alignment needed."""
    seed = _seed(12345)
    full = philox.keep_mask(seed, 0.1, 128, 320, planes=planes)
    rows, cols = torch.arange(37, 101), torch.arange(5, 300)
    if planes is None:
        part = philox.keep_mask(seed, 0.1, rows, cols)
        assert torch.equal(part, full[37:101, 5:300])
    else:
        part = philox.keep_mask(seed, 0.1, rows, cols,
                                planes=torch.arange(2, 5))
        assert torch.equal(part, full[2:5, 37:101, 5:300])


def test_two_seeds_give_different_masks():
    a = philox.keep_mask(_seed(1), 0.1, 64, 256, planes=2)
    b = philox.keep_mask(_seed(2), 0.1, 64, 256, planes=2)
    assert not torch.equal(a, b)
    # Planes are independent streams too.
    assert not torch.equal(a[0], a[1])
    # A negative int32 seed is its uint32 bit pattern, as the kernels read it.
    neg = philox.keep_mask(_seed(-5), 0.1, 64, 256)
    assert not torch.equal(neg, a[0])


def test_draws_follow_the_documented_counter_layout():
    """The 8 elements (r + 8 hf, c + 8 jj + e) share one Philox call: word
    2 hf + jj, its low 16 bits for e = 0 and its high 16 bits for e = 1
    (csrc/philox.cuh)."""
    seed = _seed(99)
    r, c = 16 * 3 + 5, 16 * 7 + 2 * 2
    words = philox.philox4x32_10(
        (torch.tensor((r >> 4) * 8 + (r & 7)),
         torch.tensor((c >> 4) * 4 + ((c >> 1) & 3)), torch.tensor(4), 0),
        (torch.tensor(99), 0))
    for hf in (0, 1):
        for jj in (0, 1):
            for e in (0, 1):
                got = philox.draw16(seed, torch.tensor(4),
                                    torch.tensor(r + 8 * hf),
                                    torch.tensor(c + 8 * jj + e))
                want = (int(words[2 * hf + jj]) >> (16 * e)) & 0xFFFF
                assert int(got) == want, (hf, jj, e)


def test_draw_seed_follows_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = philox.draw_seed(g1, torch.device("cpu"))
    assert a.dtype == torch.int32 and tuple(a.shape) == (1,)
    assert torch.equal(a, philox.draw_seed(g2, torch.device("cpu")))
    assert not torch.equal(philox.draw_seed(g1, torch.device("cpu")), a)
    with pytest.raises(ValueError):
        philox.threshold(1.0)
    assert np.isclose(philox.keep_probability(0.0), 1.0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_draw_seed_draws_where_the_generator_lives(device):
    """A CPU generator draws the seed on the CPU for any device and the seed
    is moved there: int32 [1] on ``device``, the generator advanced exactly
    as by a CPU draw (so two devices fed equally seeded CPU generators get
    the same seeds; the card test checks the values on the card). A draw
    for the generator's own device is torch.randint on that device, as
    before."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = philox.draw_seed(g1, torch.device(device))
    assert a.device.type == device and a.dtype == torch.int32
    assert tuple(a.shape) == (1,)
    first = torch.randint(0, 2 ** 31 - 1, (1,), generator=g2,
                          dtype=torch.int32)
    assert torch.equal(g1.get_state(), g2.get_state())
    if device == "cpu":
        assert torch.equal(a, first)
    assert torch.equal(philox.draw_seed(g1, torch.device("cpu")),
                       torch.randint(0, 2 ** 31 - 1, (1,), generator=g2,
                                     dtype=torch.int32))
