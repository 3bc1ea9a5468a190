"""MBR / KB-MBR training against the reference, on the CPU in fp32.

- edit_distance and compact_masked: exactly the reference's, on seeded
  random token rows with ragged lengths (empty rows included).
- mbr_loss without and with the KB-MBR rare term (and the latter without
  the ground truth among the hypotheses), on a tiny model's
  encoder output: the loss and its stats at rtol 1e-4, the gradients
  with respect to every parameter and to the encoder states within 1e-4
  of each tensor's max |ref| (floored at 1e-4 of the largest, as
  tests/test_torch_train.py). Both n-best searches (beam 3, pre-beam 8,
  max_len 8, no CTC) give the same hypotheses, so the risks are equal.
- make_train_step with the MBR term as ``aux_loss_fn``: one SGD step's
  stats (loss, the MBR stats, grad_norm) at rtol 1e-4 and each
  parameter's move within 1e-4 of its max |ref| (floored as the
  gradients).
- conf/train_mbr_kb.yaml through bin/asr_train --device cpu at micro
  widths: one epoch, loss_mbr and mbr_expected_risk in reporter.json.
Weights come from the reference's init, converted by flax_to_torch.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.asr_model import ASRConfig as JASRConfig
from espnet_slurp_tpu.models.asr_model import ASRModel as JASRModel
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
from espnet_slurp_tpu.train import mbr as jmbr
from espnet_slurp_tpu.train import optim as joptim
from espnet_slurp_tpu.train import state as jstate
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.train import mbr as pmbr
from espnet_slurp_tpu_torch.train import optim as poptim
from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, waveforms

V = 20
ASR = dict(vocab_size=V, d_model=32, n_head=2, d_ff=64, num_encoder_blocks=1,
           num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
           dropout_rate=0.0, specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)
MBR = dict(weight=0.5, beam_size=3, pre_beam_size=8, max_len=8)
KB_TOKENS = (2, 5, 7, 11)


def _kb_mask(xp):
    mask = np.zeros(V, bool)
    mask[list(KB_TOKENS)] = True
    return xp(mask)


def test_edit_distance_and_compact_masked_equal_the_references():
    rng = np.random.RandomState(0)
    n, lh, lr = 40, 11, 9
    hyp = rng.randint(0, 6, (n, lh)).astype(np.int32)
    ref = rng.randint(0, 6, (n, lr)).astype(np.int32)
    hl = rng.randint(0, lh + 1, n).astype(np.int32)
    rl = rng.randint(0, lr + 1, n).astype(np.int32)
    hl[:3], rl[3:6] = 0, 0
    want = np.asarray(jmbr.edit_distance(jnp.asarray(hyp), jnp.asarray(hl),
                                         jnp.asarray(ref), jnp.asarray(rl)))
    got = pmbr.edit_distance(t(hyp).long(), t(hl), t(ref).long(), t(rl))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 3 and (want == 0).any()
    keep = np.zeros(6, bool)
    keep[[1, 4]] = True
    jt, jl = jmbr.compact_masked(jnp.asarray(hyp), jnp.asarray(hl),
                                 jnp.asarray(keep))
    pt, pl = pmbr.compact_masked(t(hyp).long(), t(hl), torch.from_numpy(keep))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    # the kept prefix is what the rare term reads; the rest is the rows'
    # other tokens in an order of the sort's own
    for i in range(n):
        np.testing.assert_array_equal(pt[i, :pl[i]].numpy(),
                                      np.asarray(jt)[i, :int(jl[i])])


@pytest.fixture(scope="module")
def case():
    jcfg = JASRConfig(frontend=JFront(**FRONT), flash_attention="off", **ASR)
    pcfg = ASRConfig(frontend=FrontendConfig(**FRONT), **ASR)
    jmodel = JASRModel(jcfg)
    x, lens = waveforms([4096, 3000], seed=11)
    text = np.asarray([[2, 4, 6, 7, 9, 11], [5, 6, 13, 2, 3, -1]], np.int32)
    batch = dict(speech=x, speech_lengths=lens, text=text,
                 text_lengths=(text >= 0).sum(1).astype(np.int32))
    params = jax.jit(lambda rng: jmodel.init(rng, **batch))(
        jax.random.PRNGKey(0))["params"]
    return jmodel, jax.tree.map(np.asarray, params), pcfg, batch


def _port(pcfg, params):
    model = ASRModel(pcfg, device="cpu")
    model.load_state_dict(flax_to_torch(params))
    return model


def _assert_grads(model, ref_tree):
    ref = flax_to_torch(jax.tree.map(np.asarray, ref_tree))
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for name, p in model.named_parameters():
        r = ref[name]
        g = torch.zeros_like(r) if p.grad is None else p.grad
        tol = max(1e-4 * float(r.abs().max()), floor)
        err = float((g - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
    return floor


@pytest.mark.parametrize("rare,gt", [(False, True), (True, True),
                                     (True, False)])
def test_mbr_loss_and_its_gradients_match(case, rare, gt):
    jmodel, params, pcfg, batch = case
    kw = dict(MBR, rare_weight=0.5 if rare else 0.0, kb_tokens=KB_TOKENS,
              include_gt=gt)
    jcfg, pcfg_mbr = jmbr.MBRConfig(**kw), pmbr.MBRConfig(**kw)
    hs, hl, _ = jax.jit(lambda p: jmodel.apply(
        {"params": p}, batch["speech"], batch["speech_lengths"],
        method=lambda m, s, sl: m.encode(s, sl)))(params)

    def jloss(p, h):
        return jmbr.mbr_loss(jmodel, p, h, hl, batch["text"],
                             batch["text_lengths"], jcfg,
                             kb_token_mask=_kb_mask(jnp.asarray))

    (ref_loss, ref_stats), (g_p, g_h) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, hs)
    model = _port(pcfg, params)
    ths = t(np.asarray(hs)).requires_grad_()
    loss, stats = pmbr.mbr_loss(model, ths, t(np.asarray(hl)),
                                t(batch["text"]), t(batch["text_lengths"]),
                                pcfg_mbr, kb_token_mask=_kb_mask(
                                    torch.from_numpy))
    want = {"mbr_expected_risk", "loss_mbr"} | (
        {"mbr_rare_risk"} if rare else set())
    assert set(stats) == set(ref_stats) == want
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(ref_stats["mbr_expected_risk"]) > 0
    if rare:
        assert float(ref_stats["mbr_rare_risk"]) > 0
    loss.backward()
    floor = _assert_grads(model, g_p)
    gh = np.asarray(g_h)
    err = float((ths.grad - t(gh)).abs().max())
    assert err <= max(1e-4 * float(np.abs(gh).max()), floor)


def test_train_step_with_the_mbr_term_matches(case):
    jmodel, params, pcfg, batch = case
    kw = dict(MBR, rare_weight=0.5, kb_tokens=KB_TOKENS)
    # SGD: the update is the clipped gradient itself, so the parameters'
    # moves compare as the gradients do (Adam would blow the rounding noise
    # of zero gradients up to full steps)
    opt = dict(name="sgd", lr=1e-3, scheduler="constant")
    jtx = joptim.build_optimizer(joptim.OptimConfig(**opt))
    jstep = jstate.make_train_step(
        jmodel, jtx, aux_loss_fn=jmbr.make_mbr_aux_loss(
            jmodel, jmbr.MBRConfig(**kw),
            kb_token_mask=_kb_mask(jnp.asarray)))
    jst = jstate.TrainState.create(params, jtx, jax.random.PRNGKey(0))
    jst, ref_stats = jstep(jst, batch)
    model = _port(pcfg, params)
    tx = poptim.build_optimizer(poptim.OptimConfig(**opt))
    step = make_train_step(model, tx, aux_loss_fn=pmbr.make_mbr_aux_loss(
        model, pmbr.MBRConfig(**kw), kb_token_mask=_kb_mask(
            torch.from_numpy)))
    _, stats = step(TrainState.create(model, tx, seed=0),
                    {k: t(v) for k, v in batch.items()})
    for k in ("loss", "loss_ctc", "loss_att", "loss_mbr",
              "mbr_expected_risk", "mbr_rare_risk", "grad_norm"):
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(stats["skipped"]) == 0.0
    before = flax_to_torch(params)
    moves = {k: v - before[k] for k, v in flax_to_torch(
        jax.tree.map(np.asarray, jst.params)).items()}
    floor = 1e-4 * max(float(r.abs().max()) for r in moves.values())
    for name, p in model.named_parameters():
        r = moves[name]
        tol = max(1e-4 * float(r.abs().max()), floor)
        err = float((p.detach() - before[name] - r).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_mbr_kb_yaml_trains_through_the_cli(tmp_path):
    """conf/train_mbr_kb.yaml as written but for its widths (micro), the
    data dirs, SpecAug off (its masks cover a 16-mel micro frontend), a
    short n-best (max_len 8) and kb_tokens for the rare term: one epoch
    through bin/asr_train on the CPU; reporter.json carries the MBR
    stats."""
    from espnet_slurp_tpu_torch.bin import asr_train
    from espnet_slurp_tpu_torch.data.mini_corpus import make_mini_corpus
    train_dir, dev_dir = make_mini_corpus(tmp_path / "corpus", n_train=6,
                                          n_dev=2)
    exp = tmp_path / "exp"
    sets = [f"exp_dir={exp}", f"data.train_dir={train_dir}",
            f"data.valid_dir={dev_dir}", "data.bpe_vocab_size=40",
            "data.batch_type=sorted", "data.batch_size=3", "max_epoch=1",
            "model.specaug=null", "model.d_model=32", "model.n_head=2",
            "model.d_ff=64", "model.num_encoder_blocks=1",
            "model.num_decoder_blocks=1", "model.decoder_d_ff=64",
            "model.kernel_size=7", "model.frontend.n_fft=128",
            "model.frontend.hop_length=64", "model.frontend.n_mels=16",
            "mbr.max_len=8", "mbr.kb_tokens=[3,4,5]"]
    asr_train.main(["--config", "conf/train_mbr_kb.yaml", "--set", *sets,
                    "--device", "cpu"])
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    train = hist[0]["train"]
    assert {"loss_mbr", "mbr_expected_risk", "mbr_rare_risk"} <= set(train)
    assert all(np.isfinite(v) for v in train.values())
    cfg = (exp / "config.yaml").read_text()
    assert "use_tcpgen: true" in cfg and "rare_weight: 0.5" in cfg
    assert (exp / "1epoch").exists()
