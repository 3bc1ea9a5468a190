"""MaskCTC (models/maskctc.py, model_arch: maskctc) of the port against
the reference's, on the CPU, fp32.

The reference test's tiny model (one block x 32, vocab 20, n_fft 128 /
hop 64 / 16 mels, no SpecAug, dropout 0), its flax parameters converted by
utils/params.py (the ``asr`` subtree with its CTC head renamed). At the
reference's mask (``jax.random.uniform(PRNGKey(k), (B, U)) < 0.3`` on the
valid targets, passed to the port's forward as ``mask``; keys 2 and 6
mask 3 and 4 of the 8 targets): the loss and
every stat within 1e-5 relative, every gradient within 1e-4 of its max
|ref| (plus 1e-6 absolute: the key bias's is rounding only). ``decode()``'s tokens and lengths equal. Then the task end to end:
one epoch through the port's bin/asr_train with ``model_arch: maskctc``
and bin/asr_inference_maskctc, on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from espnet_slurp_tpu.models.asr_model import ASRConfig as JaxASRConfig
from espnet_slurp_tpu.models.maskctc import MaskCTCModel as JaxMaskCTC
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JaxFrontend
from espnet_slurp_tpu_torch.bin import asr_inference_maskctc as p_infer
from espnet_slurp_tpu_torch.bin import asr_train as p_train
from espnet_slurp_tpu_torch.models.asr_model import ASRConfig
from espnet_slurp_tpu_torch.models.maskctc import MaskCTCModel
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

TINY = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
            num_encoder_blocks=1, num_decoder_blocks=1, decoder_d_ff=64,
            kernel_size=7, dropout_rate=0.0, ctc_weight=0.3, specaug=None)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)


@pytest.fixture(scope="module")
def models():
    jm = JaxMaskCTC(JaxASRConfig(**TINY, flash_attention="off",
                                 frontend=JaxFrontend(**FRONT)))
    rng = np.random.RandomState(0)
    batch = {
        "speech": rng.randn(2, 1600).astype(np.float32) * 0.1,
        "speech_lengths": np.asarray([1600, 800], np.int32),
        "text": rng.randint(1, 18, size=(2, 5)).astype(np.int32),
        "text_lengths": np.asarray([5, 3], np.int32),
    }
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: jm.init(r, **batch, mask_rng=jax.random.PRNGKey(1)))(
            jax.random.PRNGKey(0))["params"])
    pm = MaskCTCModel(ASRConfig(**TINY, frontend=FrontendConfig(**FRONT)),
                      device="cpu")
    pm.load_state_dict(flax_to_torch(params))  # strict: every key bridged
    return jm, params, pm, batch


@pytest.mark.parametrize("key", [2, 6])
def test_loss_stats_and_gradients_at_the_references_mask(models, key):
    jm, params, pm, batch = models
    b, u = batch["text"].shape
    rand = np.asarray(jax.random.uniform(jax.random.PRNGKey(key), (b, u)))
    mask = (rand < 0.3) & (np.arange(u)[None, :]
                           < batch["text_lengths"][:, None])
    assert mask.any()

    def loss_fn(p):
        return jm.apply({"params": p}, **batch,
                        mask_rng=jax.random.PRNGKey(key))

    (jloss, jstats), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    pm.zero_grad()
    loss, stats = pm(**t, mask=torch.from_numpy(mask))
    loss.backward()
    assert sorted(stats) == sorted(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(stats[k].detach()), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)
    # the key projection's bias has no gradient but rounding (~1e-9):
    # each tensor within 1e-4 of its max |ref|, and 1e-6 absolute
    want = flax_to_torch(jax.tree.map(np.asarray, jgrads))
    for name, p in pm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-6, (name, err)


def test_drawn_masks_cover_only_valid_targets(models):
    _, _, pm, _ = models
    lens = torch.tensor([5, 2])
    g = torch.Generator().manual_seed(3)
    masks = [pm.draw_mask(lens, 6, g, 0.5) for _ in range(8)]
    assert all(not m[:, 5].any() and not m[1, 2:].any() for m in masks)
    assert any(m.any() for m in masks)
    assert torch.equal(pm.draw_mask(lens, 6), pm.draw_mask(lens, 6))


@pytest.mark.parametrize("n_iterations", [2, 1])
def test_decode_equals_the_reference(models, n_iterations):
    jm, params, pm, batch = models
    jt, jl = jm.apply(
        {"params": params}, batch["speech"], batch["speech_lengths"], 8,
        n_iterations, method=lambda m, s, sl, ml, it: m.decode(
            s, sl, max_len=ml, n_iterations=it))
    pt, pl = pm.decode(torch.from_numpy(batch["speech"]),
                       torch.from_numpy(batch["speech_lengths"]), max_len=8,
                       n_iterations=n_iterations)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert not (pt.numpy() == TINY["vocab_size"] - 1).any()


def test_task_trains_and_the_cli_decodes(tmp_path):
    """model_arch: maskctc through bin/asr_train (one epoch) and
    bin/asr_inference_maskctc, on the CPU."""
    from espnet_slurp_tpu.data.mini_corpus import make_mini_corpus
    train, dev = make_mini_corpus(tmp_path / "corpus", n_train=8, n_dev=3)
    exp = tmp_path / "exp"
    cfg = {"exp_dir": str(exp), "model_arch": "maskctc", "max_epoch": 1,
           "model": {**{k: v for k, v in TINY.items()
                        if k != "vocab_size"}, "frontend": FRONT},
           "optim": {"lr": 1e-3, "scheduler": "constant"},
           "data": {"train_dir": str(train), "valid_dir": str(dev),
                    "token_type": "word", "batch_type": "sorted",
                    "batch_size": 4, "speech_bucket_multiple": 2048,
                    "text_bucket_multiple": 4},
           "keep_nbest": 1, "nbest_average": 1}
    (tmp_path / "m.yaml").write_text(yaml.safe_dump(cfg))
    assert p_train.main(["--config", str(tmp_path / "m.yaml"),
                         "--device", "cpu"]) == 0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert hist[0]["train"]["steps"] == 2
    for phase in ("train", "valid"):
        assert {"loss", "loss_ctc", "loss_mlm", "acc_mlm"} <= set(
            hist[0][phase])
        assert all(np.isfinite(hist[0][phase][k])
                   for k in ("loss", "loss_ctc", "loss_mlm"))
    out = tmp_path / "dec"
    assert p_infer.main(["--exp_dir", str(exp), "--data_dir", str(dev),
                         "--output_dir", str(out), "--max_len", "8",
                         "--n_iterations", "2", "--device", "cpu"]) == 0
    s2t = pasr.Speech2TextMaskCTC.from_exp_dir(str(exp), max_len=8,
                                               n_iterations=2, device="cpu")
    from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
    wavs = read_2column_text(dev / "wav.scp")
    got = dict((line.split(" ", 1) + [""])[:2]
               for line in (out / "text").read_text().splitlines())
    audio = {uid: load_wav(p)[0] for uid, p in wavs.items()}
    assert got == dict(zip(audio, s2t.decode_batch(list(audio.values()))))
    score = dict(line.split() for line in
                 (out / "score.txt").read_text().splitlines())
    assert sorted(score) == ["CER", "RTF", "WER"]
    with pytest.raises(ValueError, match="Speech2TextMaskCTC"):
        pasr.Speech2Text.from_exp_dir(str(exp), device="cpu")
