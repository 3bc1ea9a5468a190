"""models/hubert.py and tasks/hubert.py against the reference's at micro
widths (the reference test's: 1 block x 32, a 16-mel frontend), fp32 on
the CPU with converted parameters: the loss, its stats and every gradient
at given span starts; the ``km`` padding that the reference's task clamps
to cluster 0 and the port's keeps out of the loss; and ``bin/hubert_train``
on a micro corpus."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import hubert as jh
from espnet_slurp_tpu.ops.frontend import FrontendConfig as JFront
from espnet_slurp_tpu.tasks import hubert as jtask
from espnet_slurp_tpu_torch.bin import hubert_train
from espnet_slurp_tpu_torch.models import hubert as ph
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig as PFront
from espnet_slurp_tpu_torch.tasks import hubert as ptask
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import assert_grads_match, t

MICRO = dict(n_clusters=20, d_model=32, n_head=2, d_ff=64, num_blocks=1,
             kernel_size=7, mask_prob=0.2, mask_span=4)
FRONT = dict(n_fft=128, hop_length=64, n_mels=16)
# T' of 1600 samples: 26 frames -> x4 conv2d subsampling
T_ENC = (((1 + 1600 // 64) - 1) // 2 - 1) // 2


def configs(**kw):
    return (jh.HubertConfig(frontend=JFront(**FRONT), **dict(MICRO, **kw)),
            ph.HubertConfig(frontend=PFront(**FRONT), **dict(MICRO, **kw)))


def speech():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 1600) * 0.1).astype(np.float32)
    x[1, 800:] = 0.0
    return x, np.asarray([1600, 800], np.int32)


def pair(**kw):
    """(flax model, numpy params, port model carrying them)."""
    jcfg, pcfg = configs(**kw)
    jmodel = jh.HubertModel(jcfg)
    x, lens = speech()
    ids = np.zeros((2, T_ENC), np.int32)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: jmodel.init(r, x, lens, ids,
                              mask_rng=jax.random.PRNGKey(1)))(
        jax.random.PRNGKey(0))["params"])
    port = ph.HubertModel(pcfg, device="cpu")
    port.load_state_dict(flax_to_torch(params))
    return jmodel, params, port


def reference_starts(model_cfg, key, b, t_feat):
    return np.asarray(jax.random.uniform(key, (b, t_feat))
                      < model_cfg.mask_prob)


def run_both(jmodel, params, port, ids, key):
    """The reference's (loss, stats, grads) at mask_rng ``key`` and the
    port's (loss, stats) at the same span starts, backward done."""
    x, lens = speech()
    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, x, lens, ids, mask_rng=key),
        has_aux=True))(params)
    starts = reference_starts(jmodel.cfg, key, 2, 1 + 1600 // 64)
    loss, stats = port(t(x), t(lens), t(ids), train=True, starts=t(starts))
    loss.backward()
    return (ref_loss, ref_stats, ref_g), (loss, stats)


def test_loss_stats_and_gradients_match_at_given_starts():
    jmodel, params, port = pair()
    ids = np.random.RandomState(1).randint(0, 20, (2, T_ENC)).astype(
        np.int32)
    (ref_loss, ref_stats, ref_g), (loss, stats) = run_both(
        jmodel, params, port, ids, jax.random.PRNGKey(1))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert set(stats) == set(ref_stats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=1e-4, err_msg=k)
    assert 0.0 < stats["mask_ratio"].item() < 1.0
    assert_grads_match(port.named_parameters(), ref_g, 1e-3)


def test_short_km_streams_pad_out_of_the_loss_unlike_the_reference_task():
    """A ``km`` stream shorter than its utterance's encoder output is
    padded with -1 by the collate. The reference's HubertTask.batch_adapter
    clamps the ids to >= 0, so those frames train toward cluster 0; its
    model's own rule (``cluster_ids >= 0`` in ``valid``) drops them, and
    the port's adapter keeps the -1 so that they drop (ROADMAP.md queue 3:
    the reference's adapter is wrong)."""
    jmodel, params, port = pair(mask_prob=0.9)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 20, (2, T_ENC)).astype(np.int32)
    ids[0, T_ENC - 2:] = -1  # utterance 0's stream ends 2 frames short
    coll = {"speech": speech()[0], "speech_lengths": speech()[1],
            "cluster_ids": ids}
    ref_batch = jtask.HubertTask.batch_adapter(["a", "b"], coll)
    port_batch = ptask.HubertTask.batch_adapter(["a", "b"], coll)
    assert (ref_batch["cluster_ids"] >= 0).all()
    np.testing.assert_array_equal(port_batch["cluster_ids"], ids)
    key = jax.random.PRNGKey(3)
    (ref_loss, _, _), (loss, _) = run_both(
        jmodel, params, port, port_batch["cluster_ids"], key)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    clamped, _ = jax.jit(lambda p: jmodel.apply(
        {"params": p}, *speech(), jnp.asarray(ref_batch["cluster_ids"]),
        mask_rng=key))(params)
    assert abs(float(clamped) - float(ref_loss)) > 1e-3


def test_hubert_train_cli_pretrains_on_a_micro_corpus(tmp_path):
    """wav.scp + km train and valid dirs through bin/hubert_train
    --device cpu: an epoch, its checkpoint and a finite loss; with no
    ``--device`` and no card it raises."""
    from espnet_slurp_tpu_torch.data.fileio import write_wav
    from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
    rng = np.random.RandomState(4)
    for split, n in (("train", 4), ("dev", 2)):
        d = tmp_path / split
        d.mkdir()
        scp, km = [], []
        for i in range(n):
            samples = 1600 + 320 * i
            wav = (rng.randn(samples) * 0.1).astype(np.float32)
            write_wav(str(d / f"u{i}.wav"), wav)
            t_enc = (((1 + samples // 64) - 1) // 2 - 1) // 2
            labels = rng.randint(0, 20, t_enc - (i % 2))
            scp.append(f"{split}{i} {d / f'u{i}.wav'}")
            km.append(f"{split}{i} " + " ".join(map(str, labels)))
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
        (d / "km").write_text("\n".join(km) + "\n")
    exp = tmp_path / "exp"
    sets = [f"exp_dir={exp}", f"train_dir={tmp_path / 'train'}",
            f"valid_dir={tmp_path / 'dev'}", "batch_size=2",
            "run.max_epoch=1", "speech_bucket_multiple=512"]
    sets += [f"model.{k}={v}" for k, v in MICRO.items()]
    sets += [f"model.frontend.{k}={v}" for k, v in FRONT.items()]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hubert_train.main(["--set", *sets])
    assert hubert_train.main(["--set", *sets, "--device", "cpu"]) == 0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    assert [e["epoch"] for e in hist] == [1]
    assert hist[0]["train"]["steps"] == 2
    assert np.isfinite(hist[0]["train"]["loss"])
    assert (exp / "1epoch" / CKPT_FILE).exists()
    cfg = ptask.load_hubert_config(str(exp / "config.yaml"))
    ref = jtask.load_hubert_config(str(exp / "config.yaml"))
    assert cfg.model.d_model == ref.model.d_model == 32
