"""slu/model.py and tasks/slu.py's decoding against the reference.

The reference's SLUModel is initialised once (two-pass, BERT postdecoder,
one deliberation block; its TextEncoder alone for the transformer
postdecoder) at tests/test_slu.py's tiny widths, with the vocabularies of
a slu/mini_corpus.py corpus; utils/params.py:flax_to_torch carries the
parameters to the port. Inputs come from np.random.RandomState. fp32 on
the CPU on both sides, the reference with eager attention (its "auto"
off the TPU), the port through its kernels' plain versions:

- TextEncoder, BertPostdecoder, DeliberationEncoder: outputs within MOD_TOL
  of max |ref|, with a transcript shorter than its padding (the fused
  memory's mask then has a hole);
- SLUModel single-pass and two-pass with deliberation, for both
  postdecoders: the loss and every stat within STAT_RTOL relative, every
  gradient within GRAD_TOL of its max |ref|, floored at GRAD_TOL of the
  largest gradient entry of the model (the key projections' biases have
  gradient 0 in exact arithmetic and hold only rounding noise);
- _greedy_over_memory and Speech2Understand: the same tokens and texts
  from the same weights, with GT transcripts, with a first pass and with
  dialogue history.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models.asr_model import ASRConfig as JASR
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
from espnet_slurp_tpu.slu import model as jslu
from espnet_slurp_tpu.tasks import slu as jtask
from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.slu import model as pslu
from espnet_slurp_tpu_torch.slu.mini_corpus import make_slu_mini_corpus
from espnet_slurp_tpu_torch.tasks import slu as ptask
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.utils.config import save_yaml
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

MOD_TOL, STAT_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
# tests/test_slu.py:17's TINY_ASR
TINY = dict(d_model=32, n_head=2, d_ff=64, num_encoder_blocks=2,
            num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
            dropout_rate=0.0, ctc_weight=0.3, specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)
TWO_PASS = dict(two_pass=True, text_encoder_blocks=1, text_encoder_d_ff=32,
                deliberation_blocks=1, deliberation_d_ff=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(vocab, t_vocab, postdecoder="bert", two_pass=True):
    kw = dict(TWO_PASS, postdecoder=postdecoder) if two_pass else {}
    j = jslu.SLUConfig(asr=JASR(vocab_size=vocab, frontend=JFront(**FRONT),
                                **TINY),
                       transcript_vocab_size=t_vocab, **kw)
    p = pslu.SLUConfig(asr=ASRConfig(vocab_size=vocab,
                                     frontend=FrontendConfig(**FRONT),
                                     **TINY),
                       transcript_vocab_size=t_vocab, **kw)
    return j, p


def _batch(vocab, t_vocab, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "speech": (rng.randn(2, 1600) * 0.1).astype(np.float32),
        "speech_lengths": np.asarray([1600, 800], np.int32),
        "text": rng.randint(1, vocab - 1, (2, 5)).astype(np.int32),
        "text_lengths": np.asarray([5, 3], np.int32),
        # the second transcript is shorter than its padding
        "transcript": rng.randint(1, t_vocab, (2, 8)).astype(np.int32),
        "transcript_lengths": np.asarray([8, 3], np.int32),
    }


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The corpus, the resolved vocab sizes, and the reference's parameters
    of each variant (numpy trees)."""
    root = tmp_path_factory.mktemp("slu")
    train_dir, dev_dir = make_slu_mini_corpus(root / "corpus", n_train=4,
                                              n_dev=3)
    jcfg = jtask.SLUTaskConfig(
        exp_dir=str(root / "exp"),
        model=jslu.SLUConfig(asr=JASR(frontend=JFront(**FRONT), **TINY),
                             postdecoder="bert", **TWO_PASS),
        data=jtask.DataConfig(train_dir=str(train_dir),
                              valid_dir=str(dev_dir),
                              speech_bucket_multiple=16384))
    _, conv, _, mcfg = jtask.SLUTask.prepare_vocab(jcfg)
    vocab, t_vocab = mcfg.asr.vocab_size, mcfg.transcript_vocab_size
    jc, _ = _cfgs(vocab, t_vocab)
    b = _batch(vocab, t_vocab)
    bert = _np(jax.jit(jslu.SLUModel(jc).init)(jax.random.PRNGKey(0),
                                               **b)["params"])
    enc = jslu.TextEncoder(t_vocab, 32, 2, 32, 1)
    tenc = _np(jax.jit(enc.init)(jax.random.PRNGKey(1), b["transcript"],
                                 b["transcript_lengths"])["params"])
    return dict(root=root, jcfg=jcfg, corpus=(train_dir, dev_dir),
                vocab=vocab, t_vocab=t_vocab, params={
                    "bert": bert, "transformer": {**bert, "text_encoder": tenc},
                    "single": {"asr": bert["asr"]}})


def _port(module, params):
    module.load_state_dict(flax_to_torch(params))
    return module


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def test_text_encoder_matches_the_reference(ref):
    t_vocab = ref["t_vocab"]
    b = _batch(ref["vocab"], t_vocab, seed=1)
    tok, lens = b["transcript"], b["transcript_lengths"]
    jm = jslu.TextEncoder(t_vocab, 32, 2, 32, 1)
    params = ref["params"]["transformer"]["text_encoder"]
    want, wmask = jax.jit(lambda p: jm.apply({"params": p}, tok, lens))(params)
    pm = _port(pslu.TextEncoder(t_vocab, 32, 2, 32, 1), params)
    got, gmask = pm(torch.from_numpy(tok), torch.from_numpy(lens))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    _close(got.detach(), want, MOD_TOL, "TextEncoder")


def test_bert_postdecoder_matches_the_reference(ref):
    t_vocab = ref["t_vocab"]
    b = _batch(ref["vocab"], t_vocab, seed=2)
    tok, lens = b["transcript"], b["transcript_lengths"]
    jm = jslu.BertPostdecoder(t_vocab, 32, n_head=2, d_ff=32, num_blocks=1)
    params = ref["params"]["bert"]["text_encoder"]
    want, wmask = jax.jit(lambda p: jm.apply({"params": p}, tok, lens))(params)
    pm = _port(pslu.BertPostdecoder(t_vocab, 32, n_head=2, d_ff=32,
                                    num_blocks=1), params)
    got, gmask = pm(torch.from_numpy(tok), torch.from_numpy(lens))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    _close(got.detach(), want, MOD_TOL, "BertPostdecoder")


def test_deliberation_encoder_matches_the_reference_over_a_hole(ref):
    """The fused memory [acoustic T' = 12 (10 valid) ++ text L = 8 (3
    valid)]: its mask has a hole between the streams. Outputs agree, the
    masked positions are 0, and what lies in the holes does not reach the
    valid positions (the attention's mask, and the conv module's pad mask
    zeroing them before the depthwise conv of kernel 15; the rel-pos table
    spans T' + L)."""
    rng = np.random.RandomState(3)
    a_mask = np.arange(12)[None] < np.asarray([[12], [10]])
    t_mask = np.arange(8)[None] < np.asarray([[8], [3]])
    mask = np.concatenate([a_mask, t_mask], 1)
    x = rng.randn(2, 20, 32).astype(np.float32)
    jm = jslu.DeliberationEncoder(32, 2, 32, 1)
    params = ref["params"]["bert"]["deliberation"]
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, mask))(params, x)
    pm = _port(pslu.DeliberationEncoder(32, 2, 32, 1), params)
    got = pm(torch.from_numpy(x), torch.from_numpy(mask)).detach()
    _close(got, want, MOD_TOL, "DeliberationEncoder")
    assert not got.numpy()[~mask].any()
    noisy = x.copy()
    noisy[~mask] = rng.randn(int((~mask).sum()), 32) * 100
    again = pm(torch.from_numpy(noisy), torch.from_numpy(mask)).detach()
    np.testing.assert_allclose(again.numpy()[mask], got.numpy()[mask],
                               rtol=0, atol=1e-5)


def _ref_loss_and_grads(jm, params, b):
    def lf(p):
        return jm.apply({"params": p}, **b)
    (loss, stats), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        params)
    return float(loss), _np(stats), flax_to_torch(_np(grads))


@pytest.mark.parametrize("variant", ["single", "transformer", "bert"])
def test_slu_model_loss_stats_and_gradients_match_the_reference(ref,
                                                                  variant):
    vocab, t_vocab = ref["vocab"], ref["t_vocab"]
    two_pass = variant != "single"
    jc, pc = _cfgs(vocab, t_vocab, "transformer" if variant == "single"
                   else variant, two_pass=two_pass)
    params = ref["params"][variant]
    b = _batch(vocab, t_vocab, seed=4)
    loss_r, stats_r, grads_r = _ref_loss_and_grads(jslu.SLUModel(jc), params,
                                                   b)
    pm = _port(pslu.SLUModel(pc, device="cpu"), params)
    loss, stats = pm(**{k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    assert sorted(stats) == sorted(stats_r) == ["acc", "loss", "loss_att",
                                                "loss_ctc"]
    for k, v in stats_r.items():
        np.testing.assert_allclose(float(stats[k].detach()), float(v),
                                   rtol=STAT_RTOL,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), loss_r, rtol=STAT_RTOL)
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(got) == sorted(grads_r)
    floor = GRAD_TOL * max(float(g.abs().max()) for g in grads_r.values())
    for k, want in grads_r.items():
        err = float((got[k] - want).abs().max())
        assert err <= max(GRAD_TOL * float(want.abs().max()), floor), (k, err)
    if two_pass:  # the fusion is live: the text encoder learns
        assert any(float(g.abs().max()) > 0 for k, g in got.items()
                   if k.startswith("text_encoder."))


def test_greedy_over_memory_matches_the_reference(ref):
    """The fused memory of a two-pass batch (a short transcript: the mask
    has a hole), decoded greedily by both from the same weights."""
    vocab, t_vocab = ref["vocab"], ref["t_vocab"]
    jc, pc = _cfgs(vocab, t_vocab)
    params = ref["params"]["bert"]
    jm = jslu.SLUModel(jc)
    b = _batch(vocab, t_vocab, seed=5)
    memory, mask = jax.jit(lambda p: jm.apply(
        {"params": p}, b["speech"], b["speech_lengths"], b["transcript"],
        b["transcript_lengths"], method=lambda m, *a: m.encode(*a)))(params)
    want_t, want_l = jax.jit(lambda p, m, k: jtask._greedy_over_memory(
        jm, p, m, k, 12))(params, memory, mask)
    pm = _port(pslu.SLUModel(pc, device="cpu"), params)
    with torch.no_grad():
        got_m, got_k = pm.encode(*(torch.from_numpy(b[k]) for k in (
            "speech", "speech_lengths", "transcript", "transcript_lengths")))
    _close(got_m, memory, MOD_TOL, "fused memory")
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(mask))
    tokens, lengths = ptask._greedy_over_memory(
        pm, torch.from_numpy(np.array(memory)),
        torch.from_numpy(np.array(mask)), 12)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_l))


_REF_DECODES = {}


class _FirstPass:
    """A first-pass recognizer for both sides: the utterance's GT
    transcript with its words reversed, found by the waveform's length."""

    def __init__(self, by_length):
        self.by_length = by_length

    def __call__(self, speech):
        return " ".join(reversed(self.by_length[len(speech)].split()))


@pytest.fixture(scope="module")
def exp(ref):
    """An experiment directory both Speech2Understand classes read: the
    port's config.yaml and token lists, the converted weights as the n-best
    average; the reference's checkpoint reader returns its own tree."""
    jcfg = ref["jcfg"]
    exp = ref["root"] / "exp"
    _, pc = _cfgs(ref["vocab"], ref["t_vocab"])
    cfg = ptask.load_slu_config(None, {
        "exp_dir": str(exp), "model": {}, "data": {
            "train_dir": jcfg.data.train_dir,
            "valid_dir": jcfg.data.valid_dir,
            "speech_bucket_multiple": 16384}})
    save_yaml(dataclasses.replace(cfg, model=pc), exp / "config.yaml")
    ckpt = exp / "valid.loss.ave_1best"
    ckpt.mkdir()
    torch.save({"params": flax_to_torch(ref["params"]["bert"])},
               ckpt / CKPT_FILE)
    dev = ref["corpus"][1]
    wavs = {u: load_wav(p)[0] for u, p in
            read_2column_text(dev / "wav.scp").items()}
    trs = read_2column_text(dev / "transcript")
    assert len({len(w) for w in wavs.values()}) == len(wavs)
    return exp, wavs, trs, _FirstPass({len(wavs[u]): trs[u] for u in wavs})


@pytest.mark.parametrize("mode", ["gt_transcript", "first_pass", "history"])
def test_speech2understand_matches_the_reference(ref, exp, mode,
                                                 monkeypatch):
    from espnet_slurp_tpu.tasks import asr as jasr
    from espnet_slurp_tpu_torch.tasks import asr as pasr
    exp_dir, wavs, trs, first = exp
    params = ref["params"]["bert"]

    class JCkpt:
        def __init__(self, *a):
            pass

        def load_params(self, name):
            assert name == "valid.loss.ave_1best"
            return params

    class JFirst:
        def __init__(self, asr_exp_dir, beam_size=1):
            pass

        def __call__(self, speech):
            return first(speech)

    class PFirst:
        @classmethod
        def from_exp_dir(cls, asr_exp_dir, beam_size=1, device=None):
            return first

    monkeypatch.setattr(jtask, "CheckpointManager", JCkpt)
    monkeypatch.setattr(jasr, "Speech2Text", JFirst)
    monkeypatch.setattr(pasr, "Speech2Text", PFirst)
    kw = dict(max_len=10)
    if mode == "first_pass":
        kw.update(asr_exp_dir="unused", asr_beam_size=2)
    if mode == "history":
        kw.update(use_history=True, history_max_words=8)
    j = jtask.Speech2Understand(str(exp_dir), **kw)
    # The variants decode at one shape with one max_len: they share the
    # reference's compiled decode (its cache is keyed by the shapes).
    j._jit = _REF_DECODES
    p = ptask.Speech2Understand(str(exp_dir), device="cpu", **kw)
    if mode == "first_pass":
        assert isinstance(j.first_pass, JFirst) and p.first_pass is first
    else:
        assert j.first_pass is None and p.first_pass is None
    for uid in sorted(wavs):
        tr = None if mode == "first_pass" else trs[uid]
        want, got = j(wavs[uid], transcript=tr), p(wavs[uid], transcript=tr)
        assert got == want, uid
        assert p._history == j._history
    if mode == "history":
        assert p._history and len(p._history.split()) >= len(wavs)
        p.reset_history()
        assert p._history == ""
