"""The new encoders and decoders through the port's CLIs, in-process: a
micro E-Branchformer (Transformer decoder), a micro VGG-RNN encoder with
the LAS decoder and a micro wav2vec2 encoder wider than its decoder, each
trained one epoch by ``bin/asr_train --device
cpu`` on a 6 + 2 utterance mini corpus and decoded by ``bin/asr_inference
--device cpu`` (beam 2); the decode's text is the one Speech2Text gives
from the experiment directory, and the experiment's config loads in the
reference."""
import json

import pytest
import yaml

from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu_torch.bin import asr_inference as p_infer
from espnet_slurp_tpu_torch.bin import asr_train as p_train
from espnet_slurp_tpu_torch.data.fileio import (SoundScpReader,
                                                read_2column_text)
from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
import torch_parity  # noqa: F401  (each test worker's CPU threads)

MICRO = {
    "max_epoch": 1,
    "model": {"d_model": 32, "n_head": 2, "d_ff": 64,
              "num_encoder_blocks": 1, "num_decoder_blocks": 1,
              "decoder_d_ff": 64, "kernel_size": 7, "dropout_rate": 0.1,
              "specaug": None, "use_mvn": "none",
              "frontend": {"n_fft": 128, "hop_length": 64, "n_mels": 16}},
    "optim": {"scheduler": "constant", "lr": 1e-3},
    "data": {"token_type": "word", "batch_type": "sorted"},
}
CASES = {
    "ebranchformer": {"encoder": "ebranchformer"},
    "vgg_rnn_las": {"encoder": "vgg_rnn", "rnn_encoder_units": 16,
                    "rnn_encoder_layers": 2, "decoder": "rnn",
                    "rnn_decoder_units": 16},
    # the raw-waveform SSL encoder, 48 wide under the 32-wide decoder
    "wav2vec2": {"encoder": "wav2vec2", "wav2vec2": {
        "conv_dim": [16, 16], "conv_kernel": [8, 4], "conv_stride": [4, 2],
        "d_model": 48, "n_head": 2, "d_ff": 64, "num_blocks": 1,
        "pos_conv_kernel": 16, "pos_conv_groups": 2}},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_mini_corpus(tmp_path_factory.mktemp("enc_cli") / "corpus",
                            n_train=6, n_dev=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_and_decode_through_the_clis(case, corpus, tmp_path):
    cfg = json.loads(json.dumps(MICRO))
    cfg["model"].update(CASES[case])
    exp = tmp_path / "exp"
    cfg["exp_dir"] = str(exp)
    cfg["data"].update(train_dir=str(corpus[0]), valid_dir=str(corpus[1]))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    assert p_train.main(["--config", str(tmp_path / "c.yaml"),
                         "--device", "cpu"]) == 0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert [e["epoch"] for e in hist] == [1]
    assert hist[0]["train"]["steps"] >= 1
    assert (exp / "1epoch" / CKPT_FILE).exists()
    saved = jasr.load_task_config(str(exp / "config.yaml"))
    for k, v in CASES[case].items():
        if isinstance(v, dict):
            got = getattr(saved.model, k)
            assert {f: json.loads(json.dumps(getattr(got, f)))
                    for f in v} == v
        else:
            assert getattr(saved.model, k) == v
    dec = tmp_path / "dec"
    assert p_infer.main(["--exp_dir", str(exp), "--data_dir",
                         str(corpus[1]), "--output_dir", str(dec),
                         "--beam_size", "2", "--max_len", "6",
                         "--device", "cpu"]) == 0
    hyps = read_2column_text(dec / "text")
    assert len(hyps) == 2
    assert "WER" in (dec / "score.txt").read_text().upper()
    s2t = Speech2Text.from_exp_dir(str(exp), beam_size=2, max_len=6,
                                   ctc_weight=0.3, device="cpu")
    wavs = SoundScpReader(str(corpus[1] / "wav.scp"))
    keys = sorted(hyps)
    assert s2t.decode_batch([wavs[k] for k in keys]) == [hyps[k]
                                                         for k in keys]
