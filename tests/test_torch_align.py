"""CTC segmentation (decode/ctc_segmentation.py) and bin/asr_align of the
port against the reference's, on the CPU.

The Viterbi alignment and the word merge are host numpy copies: equal
outputs on the same posteriors. The CLI: a micro model (char tokens, so
that align_words merges the pieces at <space>) at the reference's init,
the port's experiment holding the same weights (converted); the two
bin/asr_align runs write equal ``segments``. The
port's frame duration takes the frontend's ``fs`` where the reference
assumes 16 kHz (ROADMAP.md queue 3): equal on every conf/*.yaml, and a
factor 16000 / fs apart elsewhere.
"""
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from espnet_slurp_tpu.bin import asr_align as j_align
from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.decode import ctc_segmentation as jseg
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu_torch.bin import asr_align as p_align
from espnet_slurp_tpu_torch.decode import ctc_segmentation as pseg
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

CONF = Path(__file__).resolve().parent.parent / "conf"


def _log_probs(rng, t, v):
    x = rng.randn(t, v).astype(np.float32) * 3.0
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("seed,t,tokens", [
    (0, 30, [3, 5, 5, 2]),      # a repeat: the skip is barred
    (1, 12, [4, 1, 6, 2, 7]),
    (2, 6, [1, 2, 3]),
    (3, 9, []),
])
def test_viterbi_alignment_equals_the_reference(seed, t, tokens):
    lp = _log_probs(np.random.RandomState(seed), t, 8)
    assert pseg.ctc_viterbi_align(lp, tokens, 0) == \
        jseg.ctc_viterbi_align(lp, tokens, 0)


def test_align_words_equals_the_reference():
    timings = [(0, 2, 0.5), (2, 3, 0.25), (3, 5, 0.75), (6, 9, 0.125),
               (9, 11, 1.0), (11, 12, 0.5)]
    for toks in (["ca", "t▁", "<space>", "d", "og▁", "s"],
                 ["a", "b", "<space>", "c", "<space>", "d"]):
        assert pseg.align_words(timings, toks) == \
            jseg.align_words(timings, toks)


def test_frame_duration_takes_the_frontend_rate():
    """The reference's frame is hop x 4 / 16000 s whatever the frontend;
    the port's hop x the subsampling / fs: the same on every ASR
    conf/*.yaml (all at 16 kHz), twice as long at 8 kHz."""
    from espnet_slurp_tpu_torch.tasks.asr_transducer import (
        load_transducer_config)
    cfgs = {name: pasr.load_task_config(str(CONF / name)).model
            for name in ("train_ls100_conformer.yaml", "train_streaming.yaml",
                         "train_moe.yaml", "train_mbr_kb.yaml",
                         "train_asr_pipeline.yaml")}
    cfgs["train_transducer.yaml"] = load_transducer_config(
        str(CONF / "train_transducer.yaml")).model.asr
    for name, cfg in cfgs.items():
        assert p_align.frame_seconds(cfg) == \
            cfg.frontend.hop_length * 4 / 16000.0, name
    import dataclasses
    cfg = pasr.ASRConfig()
    at8k = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, fs=8000))
    assert p_align.frame_seconds(at8k) == 2 * (cfg.frontend.hop_length * 4
                                               / 16000.0)


MICRO = {
    "max_epoch": 1,
    "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
              "num_encoder_blocks": 1, "num_decoder_blocks": 1,
              "decoder_d_ff": 64, "kernel_size": 7, "dropout_rate": 0.0,
              "specaug": None, "use_mvn": "none",
              "frontend": {"n_fft": 128, "hop_length": 64, "n_mels": 16}},
    "optim": {"scheduler": "constant", "lr": 1e-3},
    "data": {"token_type": "char", "batch_type": "sorted"},
}


@pytest.fixture(scope="module")
def exps(tmp_path_factory):
    """(reference exp, port exp with its weights, dev dir): the micro
    model's reference init (its CTC head sharpened x8, so that no two
    competing alignments lie within rounding of each other), which the
    reference's checkpoint manager hands to its CLI, converted for the
    port's."""
    from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
    root = tmp_path_factory.mktemp("align")
    train, dev = make_mini_corpus(root / "corpus", n_train=6, n_dev=3)
    cfg = json.loads(json.dumps(MICRO))
    cfg["exp_dir"] = str(root / "jexp")
    cfg["data"].update(train_dir=str(train), valid_dir=str(dev))
    (root / "jexp").mkdir()
    (root / "jexp" / "config.yaml").write_text(yaml.safe_dump(cfg))
    jcfg = jasr.load_task_config(str(root / "jexp" / "config.yaml"))
    _, _, model_cfg = jasr.ASRTask.prepare_vocab(jcfg)  # writes tokens.txt
    params = jax.tree.map(np.array, jasr.ASRTask.init_params(
        JaxASRModel(model_cfg), 0))
    params["ctc"]["kernel"] *= 8.0
    pexp = root / "pexp"
    (pexp / "init").mkdir(parents=True)
    for name in ("config.yaml", "tokens.txt"):
        shutil.copy(root / "jexp" / name, pexp / name)
    torch.save({"params": flax_to_torch(params)}, pexp / "init" / CKPT_FILE)
    return root / "jexp", pexp, dev, params


def test_align_cli_writes_the_references_segments(exps, tmp_path,
                                                  monkeypatch):
    jexp, pexp, dev, params = exps
    from espnet_slurp_tpu.train.checkpoint import CheckpointManager
    monkeypatch.setattr(CheckpointManager, "load_params",
                        lambda self, name: params)
    assert j_align.main(["--exp_dir", str(jexp), "--data_dir", str(dev),
                         "--output_dir", str(tmp_path / "j")]) == 0
    assert p_align.main(["--exp_dir", str(pexp), "--data_dir", str(dev),
                         "--output_dir", str(tmp_path / "p"), "--ckpt",
                         "init", "--device", "cpu"]) == 0
    want = (tmp_path / "j" / "segments").read_text().splitlines()
    got = (tmp_path / "p" / "segments").read_text().splitlines()
    assert got == want
    # every dev utterance, one line a word of its transcript
    text = dict(line.split(" ", 1) for line in
                (dev / "text").read_text().splitlines())
    assert len(got) == sum(len(v.split()) for v in text.values())
    assert [line.split()[4] for line in got] == \
        [w for v in text.values() for w in v.split()]
