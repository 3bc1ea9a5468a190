"""The time-synchronous CTC prefix beam (decode/timesync.py) and the
lattice decode with n-best rescoring (decode/lattice.py) of the port
against the reference's, and Speech2Text's ``ctc_timesync`` / ``lattice``,
on the CPU, fp32, on the tiny flagship (its flax parameters converted).

One encoder output (the reference's, of three utterances padded as
Speech2Text pads them) goes through both packages. The third row's length
is cut to one frame, so that fewer than K paths are alive there and the
dead slots tie at NEG: the lax.top_k order decides them. Tokens and
lengths equal in every slot, scores within 1e-4 relative. The lattice
rescores with the decoder, a Transformer LM (flax parameters converted),
an ARPA trigram and a length bonus. Speech2Text with ``lattice`` reads
the LM and n-gram weights at every decode; with ``ctc_timesync`` a
positive LM or n-gram weight raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from espnet_slurp_tpu.data.tokenizer import CharTokenizer, TokenIDConverter
from espnet_slurp_tpu.decode import lattice as jlat
from espnet_slurp_tpu.decode import ngram as jng
from espnet_slurp_tpu.decode import timesync as jts
from espnet_slurp_tpu.decode.ngram_train import train_arpa
from espnet_slurp_tpu.models import lm as jlm
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from espnet_slurp_tpu_torch.decode import lattice as plat
from espnet_slurp_tpu_torch.decode import ngram as png
from espnet_slurp_tpu_torch.decode import timesync as pts
from espnet_slurp_tpu_torch.models import lm as plm
from espnet_slurp_tpu_torch.tasks import lm as ptask
from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import t, tiny_port_cfg, tiny_port_model

TOKENS = (["<blank>", "<unk>", "<space>"]
          + [chr(c) for c in range(ord("a"), ord("z") + 1)]
          + [str(i) for i in range(10)]
          + [chr(c) for c in range(ord("A"), ord("X") + 1)] + ["<sos/eos>"])
V = len(TOKENS)
SOS = V - 1
K, P, L = 10, 7, 8
LM = dict(vocab_size=V, d_model=16, n_head=2, d_ff=32, num_blocks=2)
RTOL = 1e-4


def _init(module, *args):
    return jax.tree.map(np.asarray, jax.jit(lambda rng: module.init(
        rng, *args))(jax.random.PRNGKey(7))["params"])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("lattice")
    jmodel = JaxASRModel(dataclasses.replace(_flagship_cfg(tiny=True),
                                             flash_attention="off"))
    batch = _example_batch(2, 2048, 5, V)
    params = _init(jmodel, batch["speech"], batch["speech_lengths"],
                   batch["text"], batch["text_lengths"])
    # a CTC head that emits labels, so that the paths differ in length
    params["ctc"]["kernel"] = params["ctc"]["kernel"] * 4.0
    rng = np.random.RandomState(5)
    speeches = [rng.randn(n).astype(np.float32) * 0.1
                for n in (5000, 3700, 2300)]
    s2t = Speech2Text(tiny_port_cfg(), flax_to_torch(params), TOKENS,
                      max_len=L, beam_size=K, device="cpu")
    buf, lens = s2t.pad_batch(speeches)
    hs, hl, _ = jax.jit(lambda p, s, sl: jmodel.apply(
        {"params": p}, s, sl, method=lambda m, s, sl: m.encode(s, sl)))(
            params, buf, lens)
    hl = np.array(hl)
    hl[2] = 1  # one frame: fewer than K paths alive
    jm = jlm.TransformerLM(jlm.LMConfig(**LM))
    lp = _init(jm, np.zeros((1, 4), np.int32), np.array([4]))
    pm = plm.TransformerLM(plm.LMConfig(**LM), device="cpu")
    pm.load_state_dict(flax_to_torch(lp))
    sents = [list(rng.choice(TOKENS[3:29], rng.randint(1, 7)))
             for _ in range(80)]
    arpa = train_arpa(sents, root / "lm.arpa", order=3)
    tok2id = {tok: i for i, tok in enumerate(TOKENS)}
    tok2id.update({"<s>": SOS, "</s>": SOS})
    return dict(root=root, jmodel=jmodel, params=params, speeches=speeches,
                hs=np.asarray(hs), hl=hl, lm=(jm, lp, pm), arpa=arpa,
                ngram=(jng.ArpaLM(str(arpa), tok2id, V),
                       png.ArpaLM(str(arpa), tok2id, V)),
                model=tiny_port_model(params))


def test_prefix_beam_full_equals_the_reference_in_every_slot(case):
    cfg = dict(beam_size=K, pre_beam_size=P, max_len=L)
    jmodel, params = case["jmodel"], case["params"]
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda p, hs, hl: jts.ctc_prefix_beam_full(
            jmodel, p, hs, hl, jts.TimeSyncConfig(**cfg)))(
                params, case["hs"], case["hl"]))
    got = pts.ctc_prefix_beam_full(case["model"], t(case["hs"]),
                                   t(case["hl"]), pts.TimeSyncConfig(**cfg))
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=RTOL)
    dead = ref[2][2] < -1e29
    assert 0 < dead.sum() < K and not (ref[2][:2] < -1e29).any()
    assert len(set(ref[1].ravel().tolist())) > 1  # paths of several lengths


@pytest.mark.parametrize("att_weight", [0.0, 0.3])
def test_timesync_search_equals_the_reference(case, att_weight):
    cfg = dict(beam_size=4, pre_beam_size=P, max_len=L, att_weight=att_weight)
    jmodel, params = case["jmodel"], case["params"]
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda p, hs, hl: jts.ctc_timesync_beam_search(
            jmodel, p, hs, hl, jts.TimeSyncConfig(**cfg)))(
                params, case["hs"], case["hl"]))
    got = pts.ctc_timesync_beam_search(case["model"], t(case["hs"]),
                                       t(case["hl"]),
                                       pts.TimeSyncConfig(**cfg))
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_array_equal(got[1].numpy(), ref[1])


def _hooks(case):
    jng_lm, png_lm = case["ngram"]
    return (jng.make_ngram_fusion(jng_lm, SOS),
            png.make_ngram_fusion(png_lm, SOS, device="cpu"))


LATTICE = {"ctc": {}, "att": dict(att_weight=0.3),
           "all": dict(att_weight=0.3, lm_weight=0.5, ngram_weight=0.4,
                       length_bonus=0.7)}


@pytest.mark.parametrize("name", sorted(LATTICE))
def test_lattice_rescoring_equals_the_reference(case, name):
    cfg = dict(beam_size=4, pre_beam_size=P, max_len=L, **LATTICE[name])
    jmodel, params = case["jmodel"], case["params"]
    jm, lp, pm = case["lm"]
    jh, ph = _hooks(case)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda p, hs, hl: jlat.lattice_rescore_decode(
            jmodel, p, hs, hl, jlat.LatticeConfig(**cfg), lm_model=jm,
            lm_params=lp, ngram_step_init=jh))(
                params, case["hs"], case["hl"]))
    got = plat.lattice_rescore_decode(
        case["model"], t(case["hs"]), t(case["hl"]), plat.LatticeConfig(**cfg),
        lm_model=pm, ngram_step_init=ph)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_allclose(got[2][k].numpy(), ref[2][k], rtol=RTOL,
                                   err_msg=k)


def test_sequence_scores_equal_the_reference(case):
    """lm_seq_scores and ngram_seq_scores on the prefix beam's paths."""
    jlm_, jlp, plm_ = case["lm"]
    toks, lens, _ = pts.ctc_prefix_beam_full(
        case["model"], t(case["hs"]), t(case["hl"]),
        pts.TimeSyncConfig(beam_size=4, pre_beam_size=P, max_len=L))
    jt, jl = toks.numpy().astype(np.int32), lens.numpy().astype(np.int32)
    want = np.asarray(jlat.lm_seq_scores(jlm_, jlp, jt, jl, SOS, SOS))
    np.testing.assert_allclose(
        plat.lm_seq_scores(plm_, toks, lens, SOS, SOS).numpy(), want,
        rtol=RTOL)
    jh, ph = _hooks(case)
    want = np.asarray(jlat.ngram_seq_scores(jh, jt, jl, SOS))
    np.testing.assert_allclose(
        plat.ngram_seq_scores(ph, toks, lens, SOS).numpy(), want, rtol=RTOL)


def _lm_exp(case):
    """A port LM experiment over TOKENS holding the converted flax LM."""
    root = case["root"]
    exp = root / "lm_exp"
    if not (exp / "1epoch").exists():
        text = root / "lm_text"
        text.write_text("u1 a b\nu2 b c\n")
        exp.mkdir()
        (exp / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
        m = {k: v for k, v in LM.items() if k != "vocab_size"}
        ptask.LMTask.train(ptask.LMTaskConfig(
            exp_dir=str(exp), model=ptask.LMConfig(**m), max_epoch=1,
            data=ptask.LMDataConfig(train_text=str(text),
                                    valid_text=str(text))), device="cpu")
        ckpt = exp / "1epoch" / CKPT_FILE
        tree = torch.load(ckpt, weights_only=True)
        tree["params"] = case["lm"][2].state_dict()
        torch.save(tree, ckpt)
    return exp


def _reference_lattice_texts(case, lm_weight, ngram_weight):
    jmodel, params = case["jmodel"], case["params"]
    jm, lp, _ = case["lm"]
    jh, _ = _hooks(case)
    buf, lens = case["s2t_pad"]
    tokens, lengths, _ = jax.jit(lambda p, s, sl: jlat.lattice_rescore_decode(
        jmodel, p, *jmodel.apply({"params": p}, s, sl,
                                 method=lambda m, s, sl: m.encode(s, sl))[:2],
        jlat.LatticeConfig(beam_size=K, max_len=L, att_weight=0.3,
                           lm_weight=lm_weight, ngram_weight=ngram_weight),
        lm_model=jm, lm_params=lp, ngram_step_init=jh))(params, buf, lens)
    tok, conv = CharTokenizer(), TokenIDConverter(TOKENS)
    return [tok.tokens2text(conv.ids2tokens(np.asarray(tokens)[i, :int(
        lengths[i])])) for i in range(len(case["speeches"]))]


def test_speech2text_lattice_reads_the_current_fusion_weights(case):
    npz = case["root"] / "lm.npz"
    case["ngram"][1].save_binary(str(npz))
    s2t = Speech2Text(tiny_port_cfg(), case["model"].state_dict(), TOKENS,
                      max_len=L, beam_size=K, device="cpu",
                      lm_exp_dir=str(_lm_exp(case)), lm_weight=0.5,
                      ngram_file=str(npz), ngram_weight=0.4, lattice=True,
                      lattice_att_weight=0.3)
    case["s2t_pad"] = s2t.pad_batch(case["speeches"])
    first = s2t.decode_batch(case["speeches"])
    assert first == _reference_lattice_texts(case, 0.5, 0.4)
    s2t.set_fusion_weights(lm_weight=0.0, ngram_weight=20.0)
    again = s2t.decode_batch(case["speeches"])
    assert again == _reference_lattice_texts(case, 0.0, 20.0)
    assert again != first  # the new weights moved the choice


def test_speech2text_timesync_refuses_fusion_weights(case):
    state = case["model"].state_dict()
    s2t = Speech2Text(tiny_port_cfg(), state, TOKENS, max_len=L,
                      beam_size=4, device="cpu", ctc_timesync=True)
    want = pts.ctc_timesync_beam_search(
        case["model"], *case["model"].encode(*map(torch.from_numpy,
                                                  s2t.pad_batch(
                                                      case["speeches"]))),
        pts.TimeSyncConfig(beam_size=4, max_len=L))
    tok, conv = CharTokenizer(), TokenIDConverter(TOKENS)
    assert s2t.decode_batch(case["speeches"]) == [
        tok.tokens2text(conv.ids2tokens(want[0][i, :int(want[1][i])].numpy()))
        for i in range(len(case["speeches"]))]
    s2t.set_fusion_weights(lm_weight=0.3)
    with pytest.raises(ValueError, match="ctc_timesync.*lm_weight"):
        s2t.decode_batch(case["speeches"])
    with pytest.raises(ValueError, match="ngram_weight"):
        Speech2Text(tiny_port_cfg(), state, TOKENS, device="cpu",
                    ctc_timesync=True, ngram_weight=0.2)
    with pytest.raises(ValueError, match="choose one"):
        Speech2Text(tiny_port_cfg(), state, TOKENS, device="cpu",
                    ctc_timesync=True, lattice=True)
    with pytest.raises(ValueError, match="lattice.*ilm_weight"):
        Speech2Text(tiny_port_cfg(), state, TOKENS, device="cpu",
                    lattice=True, ilm_weight=0.2)
