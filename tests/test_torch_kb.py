"""The biasing knowledge base and the rare-word scorer against the
reference, exactly.

espnet_slurp_tpu_torch/slu/kb.py is the port's own copy of the reference's
numpy module: with the same inputs and the same seed, build_trie,
boundary_token_ids, walk_trie (both boundary conventions),
BiasingListSampler and TCPGenBatchAugmenter (tries, walks, ptr_label_mask,
smoothprob_scale) must give the reference's arrays bit for bit, the
augmenter's as CPU torch tensors. utils/metrics.py:rare_word_error_rate
must give the reference's rates and counts exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from espnet_slurp_tpu.slu import kb as jkb
from espnet_slurp_tpu.utils.metrics import \
    rare_word_error_rate as j_rare_wer
from espnet_slurp_tpu_torch.slu import kb as pkb
from espnet_slurp_tpu_torch.utils.metrics import rare_word_error_rate
import torch_parity  # noqa: F401  (each test worker's CPU threads)

# A suffix-marked token list (the fork's dictionary convention) and a
# prefix-marked one (HF Metaspace), each with <blank> 0 and <sos/eos> last.
SUFFIX_TOKENS = ["<blank>", "<unk>", "a", "b▁", "c", "d▁", "e▁", "fg", "h▁",
                 "ij", "k▁", "▁", "<sos/eos>"]
PREFIX_TOKENS = ["<blank>", "<unk>", "▁a", "b", "▁cd", "e", "▁f", "gh",
                 "▁ij", "k", "▁", "l", "<sos/eos>"]
WORDS = [[2, 3], [2, 4, 5], [4, 5], [7, 8], [9, 10], [2, 3, 6], [11],
         [7, 9, 10], [4, 6]]


def _trie_fields(t):
    return {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}


@pytest.mark.parametrize("pad,mb", [(64, None), (8, 6), (16, None)])
def test_build_trie_equals_the_references(pad, mb):
    got = _trie_fields(pkb.build_trie(WORDS, pad, mb))
    ref = _trie_fields(jkb.build_trie(WORDS, pad, mb))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k


@pytest.mark.parametrize("tokens", [SUFFIX_TOKENS, PREFIX_TOKENS,
                                    ["a", "b", "▁"]])
def test_boundary_token_ids_equal_the_references(tokens):
    assert pkb.boundary_token_ids(tokens) == jkb.boundary_token_ids(tokens)


@pytest.mark.parametrize("prefix", [False, True])
def test_walk_trie_equals_the_references(prefix):
    rng = np.random.RandomState(0)
    tokens = PREFIX_TOKENS if prefix else SUFFIX_TOKENS
    bset, conv = jkb.boundary_token_ids(tokens)
    assert conv == prefix
    trie = jkb.build_trie(WORDS, 16)
    eos = len(tokens) - 1
    seqs = rng.randint(2, eos + 1, size=(6, 14)).astype(np.int32)
    # teacher-forced word sequences too, so that the walk descends
    for i in range(3):
        w = [p for j in rng.permutation(len(WORDS))[:4] for p in WORDS[j]]
        seqs[i, :len(w[:14])] = w[:14]
    ref = jkb.walk_trie(trie, seqs, bset, eos, prefix_boundary=prefix)
    got = pkb.walk_trie(pkb.build_trie(WORDS, 16), seqs, bset, eos,
                        prefix_boundary=prefix)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert (ref[0] > 0).any()


def test_biasing_list_sampler_equals_the_references():
    refs = [[2, 3], [9, 10], [1, 1], [4, 6], [2, 3]]
    p = pkb.BiasingListSampler(WORDS, n_distractors=3, drop_prob=0.3, seed=4)
    j = jkb.BiasingListSampler(WORDS, n_distractors=3, drop_prob=0.3, seed=4)
    for _ in range(5):
        assert p.sample(refs) == j.sample(refs)


@pytest.mark.parametrize("prefix,sched,start", [(False, 3, 0), (True, 0, 1),
                                                (False, 0, 0)])
def test_augmenter_equals_the_references(prefix, sched, start):
    """Three batches over two epochs through wrap(): every key equal to
    the reference's, the trie keys as CPU torch tensors of the
    reference's dtypes."""
    tokens = PREFIX_TOKENS if prefix else SUFFIX_TOKENS
    bset, _ = jkb.boundary_token_ids(tokens)
    eos = len(tokens) - 1
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(3):
        text = np.full((4, 9), -1, np.int32)
        for i in range(4):
            w = [p for j in rng.permutation(len(WORDS))[:3] for p in WORDS[j]]
            n = rng.randint(3, 10)
            text[i, :min(n, len(w))] = w[:n]
        batches.append({"text": text, "text_lengths": (text >= 0).sum(1)})
    kw = dict(prefix_boundary=prefix, kb_len=4, db_drop=0.3,
              sched_epochs=sched, start_epoch=start, seed=7)
    pf = pkb.TCPGenBatchAugmenter(WORDS, bset, eos, eos, **kw).wrap(
        lambda epoch: iter(batches))
    jf = jkb.TCPGenBatchAugmenter(WORDS, bset, eos, eos, **kw).wrap(
        lambda epoch: iter(batches))
    seen = 0
    for epoch in (1, 2):
        for got, ref in zip(pf(epoch), jf(epoch)):
            assert sorted(got) == sorted(ref)
            for k, r in ref.items():
                g, r = got[k], np.asarray(r)
                if k in ("text", "text_lengths"):
                    assert g is batches[seen % 3][k]
                    continue
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
                assert str(g.dtype).split(".")[-1] == str(r.dtype), k
                np.testing.assert_array_equal(g.numpy(), r, err_msg=k)
            seen += 1
    assert seen == 6
    assert ("smoothprob_scale" in ref) == (sched > 0 or start > 0)


def test_rare_word_error_rate_equals_the_references():
    refs = {"u1": "the cat sat on kubernetes", "u2": "alpha beta gamma",
            "u3": "zyx dog", "u4": ""}
    hyps = {"u1": "the cat sat kuber netes", "u2": "alpha gamma gamma delta",
            "u3": "zyx", "u4": "extra"}
    rare = ["kubernetes", "gamma", "zyx", "absent"]
    got = rare_word_error_rate(refs, hyps, rare)
    ref = j_rare_wer(refs, hyps, rare)
    assert got[:2] == ref[:2]
    for g, r in zip(got[2:], ref[2:]):
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
    assert got[0] > 0 and got[1] > 0


def test_a_tcpgen_model_trains_with_the_augmenter_and_decodes_biased(
        tmp_path):
    """The fork's recipe through the port's ASRTask on the CPU, as the
    reference's recipe/ablation_run.py wires it: a suffix-marked BPE
    vocabulary, a use_tcpgen micro model, TCPGenBatchAugmenter wrapped
    around build_iter_factory (per-batch tries, db_drop 0.3, the pointer
    ramp), two epochs; the reporter carries the pointer's stats. Then
    Speech2Text(biasing_words=...) from the exp dir decodes with the
    biasing trie, whose beam scores differ from the unbiased search's."""
    import json

    from espnet_slurp_tpu_torch.data.mini_corpus import (WORDS as CWORDS,
                                                         make_mini_corpus)
    from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                    batch_beam_search)
    from espnet_slurp_tpu_torch.data.fileio import load_wav, \
        read_2column_text
    from espnet_slurp_tpu_torch.tasks.asr import (ASRTask, Speech2Text,
                                                  load_task_config)
    train_dir, dev_dir = make_mini_corpus(tmp_path / "corpus", n_train=8,
                                          n_dev=2)
    exp = tmp_path / "exp"
    cfg = load_task_config(None, {
        "exp_dir": str(exp), "max_epoch": 2,
        "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
                  "num_encoder_blocks": 1, "num_decoder_blocks": 1,
                  "decoder_d_ff": 64, "kernel_size": 7, "dropout_rate": 0.0,
                  "specaug": None, "use_mvn": "none", "use_tcpgen": True,
                  "tcpgen_ptr_loss_weight": 1.0,
                  "tcpgen_gate_loss_weight": 0.2,
                  "frontend": {"n_fft": 128, "hop_length": 64,
                               "n_mels": 16}},
        "optim": {"scheduler": "constant", "lr": 1e-3},
        "data": {"train_dir": str(train_dir), "valid_dir": str(dev_dir),
                 "token_type": "bpe", "bpe_marker": "suffix",
                 "bpe_vocab_size": 40, "batch_type": "sorted",
                 "batch_size": 4}})
    tokenizer, converter, model_cfg = ASRTask.prepare_vocab(cfg)
    words = list(CWORDS[:6])
    pieces = [converter.tokens2ids(tokenizer.text2tokens(w)) for w in words]
    bset, prefix = pkb.boundary_token_ids(converter.token_list)
    assert bset and not prefix  # the suffix convention
    aug = pkb.TCPGenBatchAugmenter(pieces, bset, model_cfg.sos_id,
                                   model_cfg.eos_id, prefix_boundary=prefix,
                                   kb_len=4, db_drop=0.3, sched_epochs=1,
                                   seed=7)

    class Task(ASRTask):
        @classmethod
        def build_iter_factory(cls, cfg_, dataset, shuffle=True):
            return aug.wrap(ASRTask.build_iter_factory(cfg_, dataset,
                                                       shuffle))

    Task.train(cfg, device="cpu")
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert len(hist) == 2
    for phase in ("train", "valid"):
        got = hist[-1][phase]
        assert {"p_gen", "p_gen_bias", "loss_ptr", "loss_gate"} <= set(got)
        assert all(np.isfinite(v) for v in got.values())
    s2t = Speech2Text.from_exp_dir(str(exp), beam_size=3, max_len=8,
                                   device="cpu", biasing_words=words)
    assert s2t.biasing["dead"] > 0 and not s2t.biasing["prefix_boundary"]
    wavs = [load_wav(p)[0] for _, p in
            sorted(read_2column_text(dev_dir / "wav.scp").items())]
    texts = s2t.decode_batch(wavs)
    assert len(texts) == len(wavs) and all(isinstance(x, str) for x in texts)
    buf, lens = s2t.pad_batch(wavs)
    with torch.inference_mode():
        hs, hl = s2t.model.encode(torch.from_numpy(buf),
                                  torch.from_numpy(lens))
        beam = BeamSearchConfig(beam_size=3, max_len=8)
        biased = batch_beam_search(s2t.model, hs, hl, beam,
                                   biasing=s2t.biasing, return_nbest=True)
        plain = batch_beam_search(s2t.model, hs, hl, beam,
                                  return_nbest=True)
    assert not torch.allclose(biased[4], plain[4])
