"""Shallow fusion, n-gram fusion and internal-LM subtraction in the port's
beam search (decode/beam.py) and Speech2Text, against the reference's on
the CPU, fp32, on the tiny flagship (its flax parameters converted).

One encoder output (the reference's, of three utterances padded as
Speech2Text pads them) goes through both searches (beam 3, pre-beam 8,
ctc_weight 0.3, max_len 8, n-best): with a Transformer LM and with an
LSTM LM (flax parameters converted), with an ARPA trigram (written by
train_arpa), with both scaled by their own weights as Speech2Text
composes them, with ILM subtraction beside the LM, and at ilm_weight 0
(the reference runs the ILM pass, the port skips it). Tokens and lengths
of the best and of the n-best must be equal and the n-best scores within
1e-4 relative. Speech2Text with ``lm_exp_dir`` and ``ngram_file`` (a port
LM experiment holding the converted flax LM; the trigram's .npz cache)
must decode the texts of the reference's composition, before and after
``set_fusion_weights``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.data.tokenizer import CharTokenizer, TokenIDConverter
from espnet_slurp_tpu.decode import ngram as jng
from espnet_slurp_tpu.decode.beam import BeamSearchConfig as JBeamConfig
from espnet_slurp_tpu.decode.beam import batch_beam_search as j_beam
from espnet_slurp_tpu.decode.ngram_train import train_arpa
from espnet_slurp_tpu.models import lm as jlm
from espnet_slurp_tpu.tasks.lm import make_lm_fusion as j_lm_fusion
from espnet_slurp_tpu_torch.decode import ngram as png
from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                batch_beam_search)
from espnet_slurp_tpu_torch.models import lm as plm
from espnet_slurp_tpu_torch.tasks import lm as ptask
from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from __graft_entry__ import _example_batch, _flagship_cfg
from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
from torch_parity import t, tiny_port_cfg, tiny_port_model

TOKENS = (["<blank>", "<unk>", "<space>"]
          + [chr(c) for c in range(ord("a"), ord("z") + 1)]
          + [str(i) for i in range(10)]
          + [chr(c) for c in range(ord("A"), ord("X") + 1)] + ["<sos/eos>"])
V = len(TOKENS)
SOS = V - 1
BEAM = dict(beam_size=3, pre_beam_size=8, ctc_weight=0.3, max_len=8)
LM = dict(vocab_size=V, d_model=16, n_head=2, d_ff=32, num_blocks=2,
          num_layers=1)
RTOL = 1e-4


def _init(module, *args):
    """numpy parameters of a flax module, its init jitted."""
    return jax.tree.map(np.asarray, jax.jit(lambda rng: module.init(
        rng, *args))(jax.random.PRNGKey(7))["params"])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusion")
    # torch_parity.tiny_jax_model's model (the tiny flagship, eager
    # attention), its init jitted
    jmodel = JaxASRModel(dataclasses.replace(_flagship_cfg(tiny=True),
                                             flash_attention="off"))
    batch = _example_batch(2, 2048, 5, V)
    params = _init(jmodel, batch["speech"], batch["speech_lengths"],
                   batch["text"], batch["text_lengths"])
    rng = np.random.RandomState(5)
    speeches = [rng.randn(n).astype(np.float32) * 0.1
                for n in (5000, 3700, 2300)]
    s2t = Speech2Text(tiny_port_cfg(), flax_to_torch(params), TOKENS,
                      max_len=8, beam_size=3, ctc_weight=0.3, device="cpu")
    buf, lens = s2t.pad_batch(speeches)
    hs, hl, _ = jax.jit(lambda p, s, sl: jmodel.apply(
        {"params": p}, s, sl, method=lambda m, s, sl: m.encode(s, sl)))(
            params, buf, lens)
    lms = {}
    for arch in ("transformer", "lstm"):
        jm = (jlm.TransformerLM if arch == "transformer" else jlm.LSTMLM)(
            jlm.LMConfig(arch=arch, **LM))
        lp = _init(jm, np.zeros((1, 4), np.int32), np.array([4]))
        pm = (plm.TransformerLM if arch == "transformer" else plm.LSTMLM)(
            plm.LMConfig(arch=arch, **LM), device="cpu")
        pm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, lp)))
        lms[arch] = (jm, lp, pm)
    # a trigram over sentences of the token list's letters
    sents = [list(rng.choice(TOKENS[3:29], rng.randint(1, 7)))
             for _ in range(80)]
    arpa = train_arpa(sents, root / "lm.arpa", order=3)
    tok2id = {tok: i for i, tok in enumerate(TOKENS)}
    tok2id.update({"<s>": SOS, "</s>": SOS})
    ngram = (jng.ArpaLM(str(arpa), tok2id, V), png.ArpaLM(str(arpa), tok2id,
                                                           V))
    return dict(root=root, jmodel=jmodel, params=params, speeches=speeches,
                hs=np.asarray(hs), hl=np.asarray(hl), lms=lms, ngram=ngram,
                arpa=arpa, s2t=s2t)


def _scorers(case, names):
    """(jax hooks, port hooks) per scorer name."""
    out = []
    for name in names:
        if name == "ngram":
            jl, pl = case["ngram"]
            out.append((jng.make_ngram_fusion(jl, SOS),
                        png.make_ngram_fusion(pl, SOS, device="cpu")))
        else:
            jm, lp, pm = case["lms"][name]
            out.append((j_lm_fusion(jm, lp, 0, BEAM["max_len"]),
                        ptask.make_lm_fusion(pm, BEAM["max_len"])))
    return out


def _compose(hooks, weights, stack):
    """Speech2Text's composition: each scorer's rows times its weight."""
    def init(n):
        return [h[1](n) for h in hooks]

    def step(y, states):
        rows, new = [], []
        for (s, _), w, st in zip(hooks, weights, states):
            row, st = s(y, st)
            rows.append(w * row)
            new.append(st)
        return stack(rows), new
    return step, init


CASES = {  # name: (scorers, their weights, lm_weight, ilm_weight)
    "transformer_lm": (["transformer"], [1.0], 0.3, None),
    "lstm_lm": (["lstm"], [1.0], 0.3, None),
    "ngram": (["ngram"], [1.0], 0.5, None),
    "lm_and_ngram": (["transformer", "ngram"], [0.3, 0.4], 1.0, None),
    "lm_and_ilm": (["transformer"], [1.0], 0.3, 0.2),
    "ilm_weight_zero": (["transformer"], [1.0], 0.3, 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_beam_search_matches(case, name):
    names, weights, w_lm, w_ilm = CASES[name]
    hooks = _scorers(case, names)
    jstep, jinit = _compose([h[0] for h in hooks], weights, sum)
    pstep, pinit = _compose([h[1] for h in hooks], weights, sum)
    jmodel, params = case["jmodel"], case["params"]

    @jax.jit
    def run(params, hs, hl):
        return j_beam(jmodel, params, hs, hl,
                      JBeamConfig(lm_weight=w_lm, **BEAM), lm_step=jstep,
                      lm_init=jinit, return_nbest=True, ilm_weight=w_ilm)

    ref = jax.tree.map(np.asarray, run(params, case["hs"], case["hl"]))
    model = tiny_port_model(params)
    got = batch_beam_search(model, t(case["hs"]), t(case["hl"]),
                            BeamSearchConfig(lm_weight=w_lm,
                                             ilm_weight=w_ilm or 0.0, **BEAM),
                            lm_step=pstep, lm_init=pinit, return_nbest=True)
    for i, what in enumerate(("tokens", "lengths", "n-best tokens",
                              "n-best lengths")):
        np.testing.assert_array_equal(got[i].numpy(), ref[i], err_msg=what)
    np.testing.assert_allclose(got[4].numpy(), ref[4], rtol=RTOL)
    # the fusion changed the search
    plain = batch_beam_search(model, t(case["hs"]), t(case["hl"]),
                              BeamSearchConfig(**BEAM), return_nbest=True)
    assert not np.allclose(plain[4].numpy(), got[4].numpy())


def _lm_exp(case):
    """A port LM experiment over TOKENS holding the converted flax
    Transformer LM (trained one step on the CPU, its parameters then
    replaced)."""
    root = case["root"]
    exp = root / "lm_exp"
    if not (exp / "1epoch").exists():
        text = root / "lm_text"
        text.write_text("u1 a b\nu2 b c\n")
        exp.mkdir()
        (exp / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
        m = LM.copy()
        m.pop("vocab_size")
        cfg = ptask.LMTaskConfig(
            exp_dir=str(exp), model=ptask.LMConfig(**m), max_epoch=1,
            data=ptask.LMDataConfig(train_text=str(text),
                                    valid_text=str(text)))
        ptask.LMTask.train(cfg, device="cpu")
        ckpt = exp / "1epoch" / CKPT_FILE
        tree = torch.load(ckpt, weights_only=True)
        tree["params"] = case["lms"]["transformer"][2].state_dict()
        torch.save(tree, ckpt)
    return exp


def _reference_texts(case, fusion, w_ilm=None):
    """The reference Speech2Text's decode: scorers scaled by fusion[0]
    (LM) and fusion[1] (n-gram), beam at lm_weight 1."""
    hooks = _scorers(case, ["transformer", "ngram"])
    step, init = _compose([h[0] for h in hooks], fusion, sum)
    jmodel, params = case["jmodel"], case["params"]
    tokens, lengths = jax.jit(lambda p, hs, hl: j_beam(
        jmodel, p, hs, hl, JBeamConfig(lm_weight=1.0, **BEAM), lm_step=step,
        lm_init=init, ilm_weight=w_ilm))(params, case["hs"], case["hl"])
    tok, conv = CharTokenizer(), TokenIDConverter(TOKENS)
    return [tok.tokens2text(conv.ids2tokens(np.asarray(tokens)[i, :int(
        lengths[i])])) for i in range(len(case["speeches"]))]


def test_speech2text_fuses_an_lm_experiment_and_an_ngram(case):
    exp = _lm_exp(case)
    npz = case["root"] / "lm.npz"
    case["ngram"][1].save_binary(str(npz))
    s2t = Speech2Text(tiny_port_cfg(), case["s2t"].model.state_dict(),
                      TOKENS, max_len=8, beam_size=3, ctc_weight=0.3,
                      device="cpu", lm_exp_dir=str(exp), lm_weight=0.3,
                      ngram_file=str(npz), ngram_weight=0.4)
    got = s2t.decode_batch(case["speeches"])
    assert got == _reference_texts(case, [0.3, 0.4])
    s2t.set_fusion_weights(lm_weight=0.8, ngram_weight=0.0)
    assert s2t.decode_batch(case["speeches"]) == _reference_texts(
        case, [0.8, 0.0])
    with pytest.raises(ValueError, match="sweep_fusion"):
        s2t.set_fusion_weights(ilm_weight=0.1)


def test_speech2text_sweeps_the_ilm_weight(case):
    exp = _lm_exp(case)
    s2t = Speech2Text(tiny_port_cfg(), case["s2t"].model.state_dict(),
                      TOKENS, max_len=8, beam_size=3, ctc_weight=0.3,
                      device="cpu", lm_exp_dir=str(exp), lm_weight=0.3,
                      ngram_file=str(case["arpa"]), ngram_weight=0.4,
                      sweep_fusion=True)
    base = s2t.decode_batch(case["speeches"])
    assert base == _reference_texts(case, [0.3, 0.4], w_ilm=0.0)
    s2t.set_fusion_weights(ilm_weight=0.5)
    assert s2t.decode_batch(case["speeches"]) == _reference_texts(
        case, [0.3, 0.4], w_ilm=0.5)


def test_an_lm_over_another_vocabulary_raises(case, tmp_path):
    exp = tmp_path / "other_lm"
    exp.mkdir()
    text = tmp_path / "text"
    text.write_text("u1 a b\n")
    (exp / "tokens.txt").write_text("\n".join(TOKENS[:-2] + TOKENS[-1:])
                                    + "\n")
    ptask.LMTask.train(ptask.LMTaskConfig(
        exp_dir=str(exp), max_epoch=1,
        model=ptask.LMConfig(d_model=8, n_head=2, d_ff=8, num_blocks=1),
        data=ptask.LMDataConfig(train_text=str(text), valid_text=str(text))),
        device="cpu")
    with pytest.raises(ValueError, match=f"{V - 1} tokens.*{V}"):
        Speech2Text(tiny_port_cfg(), case["s2t"].model.state_dict(), TOKENS,
                    beam_size=3, device="cpu", lm_exp_dir=str(exp),
                    lm_weight=0.3)
