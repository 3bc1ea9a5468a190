"""The tiny flagship at its recipe's dropout 0.1 on the CPU.

conf/train_ls100_conformer.yaml:14 trains at dropout_rate 0.1. In the port
dropout acts where the reference's does (the encoder's FFN hiddens and
attention probabilities), through K2 and K3's plain versions with the
kernels' Philox masks (the kernel route) or through the eager layers'
torch.rand masks (flash "off"), every draw from the train step's generator.
The reference draws other bits (its TPU PRNG), so these tests pin the
port's own semantics: eval is the rate-0 model exactly, a train step's
loss is finite and moves with the mask, the same generator seed repeats
it, and the loss falls over three steps. __graft_entry__._flagship_cfg(
tiny=True) shapes; SpecAug off.
"""
import numpy as np
import pytest
import torch

from espnet_slurp_tpu_torch.train import optim as toptim
from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step
from torch_parity import t, tiny_jax_model, tiny_port_model, waveforms

RATE = 0.1


@pytest.fixture(scope="module")
def case():
    _, params = tiny_jax_model(specaug=None)
    x, lens = waveforms([4096, 3000], seed=11)
    text = np.asarray([[5, 9, 9, 17, 3], [40, 2, 7, -1, -1]], np.int32)
    tlens = np.asarray([5, 3], np.int32)
    batch = dict(speech=x, speech_lengths=lens, text=text, text_lengths=tlens)
    return params, {k: t(v) for k, v in batch.items()}


def _model(params, rate, flash="auto"):
    return tiny_port_model(params, specaug=None, dropout_rate=rate,
                           flash_attention=flash)


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_eval_equals_the_rate_zero_model(case, flash):
    """train=False draws nothing: loss, stats and the encoder output equal
    the rate-0 model's bit for bit, and the generator is not advanced."""
    params, batch = case
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    with torch.no_grad():
        a_loss, a_stats = _model(params, RATE, flash)(**batch, train=False,
                                                      generator=gen)
        b_loss, b_stats = _model(params, 0.0, flash)(**batch, train=False)
        a_hs, _ = _model(params, RATE, flash).encode(
            batch["speech"], batch["speech_lengths"])
        b_hs, _ = _model(params, 0.0, flash).encode(
            batch["speech"], batch["speech_lengths"])
    assert float(a_loss) == float(b_loss)
    assert all(float(a_stats[k]) == float(b_stats[k]) for k in b_stats)
    assert torch.equal(a_hs, b_hs)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_train_loss_is_finite_and_moves_with_the_mask(case, flash):
    """A train forward at rate 0.1 is finite and differs from rate 0; the
    same generator seed gives the same loss, another seed another."""
    params, batch = case
    model = _model(params, RATE, flash)
    losses = {}
    for name, seed in (("a", 3), ("again", 3), ("other", 4)):
        with torch.no_grad():
            loss, _ = model(**batch, train=True,
                            generator=torch.Generator().manual_seed(seed))
        losses[name] = float(loss)
    with torch.no_grad():
        ref, _ = _model(params, 0.0, flash)(**batch, train=True)
    assert np.isfinite(list(losses.values())).all()
    assert losses["a"] == losses["again"]
    assert losses["a"] != losses["other"]
    assert losses["a"] != float(ref)


def test_kernel_route_draws_one_seed_per_kernel_call(case):
    """On the kernel route a train forward draws one int32 seed from the
    generator per FFN and per attention call (2 FFNs and 1 attention per
    block, 2 blocks): 6 draws, replayed by draw_seed."""
    from espnet_slurp_tpu_torch.ops.kernels import ffn, flash_attention
    from espnet_slurp_tpu_torch.ops.kernels import philox
    params, batch = case
    seeds = []
    real = philox.draw_seed

    def spy(generator, device):
        seeds.append(real(generator, device))
        return seeds[-1]

    import espnet_slurp_tpu_torch.models.attention as att
    import espnet_slurp_tpu_torch.models.conformer as conf
    old = (att.draw_seed, conf.draw_seed)
    att.draw_seed = conf.draw_seed = spy
    launches = (ffn.fused_ffn.launches,
                flash_attention.rel_flash_attention_fwd.launches)
    try:
        with torch.no_grad():
            _model(params, RATE)(**batch, train=True,
                                 generator=torch.Generator().manual_seed(6))
    finally:
        att.draw_seed, conf.draw_seed = old
    assert len(seeds) == 6 and all(s.dtype == torch.int32 for s in seeds)
    g = torch.Generator().manual_seed(6)
    # SpecAug is off: the seeds are the generator's first six draws.
    replay = [real(g, torch.device("cpu")) for _ in range(6)]
    assert all(torch.equal(a, b) for a, b in zip(seeds, replay))
    # On the CPU the plain versions run: no kernel launch is counted.
    assert launches == (ffn.fused_ffn.launches,
                        flash_attention.rel_flash_attention_fwd.launches)


def test_equal_cpu_generators_repeat_the_seeds_and_the_loss(case):
    """The seed path of the card-against-CPU checks: two train forwards
    given equally seeded CPU generators draw the same six kernel seeds and
    give the same loss bit for bit; another seed draws other seeds and
    another loss."""
    import espnet_slurp_tpu_torch.models.attention as att
    import espnet_slurp_tpu_torch.models.conformer as conf
    from espnet_slurp_tpu_torch.ops.kernels import philox
    params, batch = case
    model = _model(params, RATE)
    real = philox.draw_seed
    runs = []
    for seed in (12, 12, 13):
        seeds = []

        def spy(generator, device):
            seeds.append(real(generator, device))
            return seeds[-1]

        old = (att.draw_seed, conf.draw_seed)
        att.draw_seed = conf.draw_seed = spy
        try:
            with torch.no_grad():
                loss, _ = model(**batch, train=True,
                                generator=torch.Generator().manual_seed(seed))
        finally:
            att.draw_seed, conf.draw_seed = old
        runs.append((torch.cat(seeds), float(loss)))
    (s1, l1), (s2, l2), (s3, l3) = runs
    assert s1.numel() == 6 and torch.equal(s1, s2) and l1 == l2
    assert not torch.equal(s1, s3) and l1 != l3


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_loss_falls_over_three_steps(case, flash):
    """make_train_step at rate 0.1 (Adam at constant lr 1e-3, the state's
    generator): three steps on one batch, each loss and grad norm finite,
    nothing skipped, the last loss below the first."""
    params, batch = case
    model = _model(params, RATE, flash)
    tx = toptim.build_optimizer(toptim.OptimConfig(lr=1e-3,
                                                   scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    losses = []
    for _ in range(3):
        state, stats = step(state, batch)
        assert float(stats["skipped"]) == 0.0
        assert np.isfinite(float(stats["grad_norm"]))
        losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
