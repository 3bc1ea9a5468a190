"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Inputs come from np.random.RandomState(seed); weights from the JAX
module's init, converted by espnet_slurp_tpu_torch.utils.params.

Every tests/test_torch_*.py imports this module, which gives each process's
torch its share of the CPU cores at import: the cores over the number of
pytest-xdist workers (tiny ops on threads that outnumber the cores spin
against each other). It imports JAX and the reference only inside the
helpers that need them, so a card-only test file can import it where no
JAX is installed.
"""
import os

import numpy as np
import torch

from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
from espnet_slurp_tpu_torch.utils.params import flax_to_torch

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def tiny_port_cfg(**kw) -> ASRConfig:
    """The port's copy of __graft_entry__._flagship_cfg(tiny=True)."""
    base = dict(
        vocab_size=64, d_model=32, n_head=2, d_ff=64, num_encoder_blocks=2,
        num_decoder_blocks=1, decoder_d_ff=64, kernel_size=7,
        dropout_rate=0.0,
        frontend=FrontendConfig(n_fft=128, hop_length=64, n_mels=16))
    return ASRConfig(**{**base, **kw})


def tiny_jax_model(**kw):
    """(flax ASRModel, numpy params) of the tiny flagship, eager attention."""
    import dataclasses

    import jax

    from __graft_entry__ import _example_batch, _flagship_cfg
    from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), flash_attention="off",
                              **kw)
    model = JaxASRModel(cfg)
    batch = _example_batch(2, 2048, 5, cfg.vocab_size)
    params = model.init(
        jax.random.PRNGKey(0), batch["speech"], batch["speech_lengths"],
        batch["text"], batch["text_lengths"])["params"]
    return model, jax.tree.map(np.asarray, params)


def tiny_port_model(params, **kw) -> ASRModel:
    model = ASRModel(tiny_port_cfg(**kw), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    return model


def waveforms(lengths, seed=0):
    """Ragged float32 waveforms [B, max(lengths)] (zero-padded), lengths."""
    rng = np.random.RandomState(seed)
    n = max(lengths)
    x = np.zeros((len(lengths), n), np.float32)
    for i, m in enumerate(lengths):
        x[i, :m] = rng.randn(m).astype(np.float32) * 0.1
    return x, np.asarray(lengths, np.int32)


def t(x):
    return torch.from_numpy(np.array(x))


def valid_rows(x, lens):
    """[B, T, ...] with the frames past each row's length zeroed."""
    x = np.asarray(x)
    m = np.arange(x.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(m.reshape(m.shape + (1,) * (x.ndim - 2)), x, 0.0)


def assert_grads_match(named_params, ref_tree, tol=1e-4):
    """Every port gradient against the reference's (a flax grad tree), as
    tests/test_torch_encoder_options.py holds them: within tol of each
    tensor's max |grad|, floored at tol of the largest one."""
    import jax
    ref = flax_to_torch(jax.tree.map(np.asarray, ref_tree))
    grads = {n: p.grad for n, p in named_params}
    assert set(grads) == set(ref)
    floor = tol * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        g = grads[name]
        assert g is not None, name
        bound = max(tol * float(r.abs().max()), floor)
        assert float((g - r).abs().max()) <= bound, name


LOSS_TEXT = np.asarray([[5, 9, 9, 17, 3], [40, 2, 7, -1, -1]], np.int32)
LOSS_TEXT_LENGTHS = np.asarray([5, 3], np.int32)


def asr_pair(jax_front=None, port_front=None, **kw):
    """(flax ASRModel, numpy params, port ASRModel carrying them) of the
    tiny flagship with ``kw`` (eager attention on the reference's side,
    no SpecAug); ``jax_front`` / ``port_front`` replace the frontend."""
    import dataclasses

    import jax

    from __graft_entry__ import _flagship_cfg
    from espnet_slurp_tpu.models.asr_model import ASRModel as JaxASRModel
    jkw = dict(kw, **({"frontend": jax_front} if jax_front else {}))
    pkw = dict(kw, **({"frontend": port_front} if port_front else {}))
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), flash_attention="off",
                              specaug=None, **jkw)
    jmodel = JaxASRModel(cfg)
    x, lens = waveforms([4096, 3000], seed=11)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, lens, LOSS_TEXT,
                                  LOSS_TEXT_LENGTHS)["params"]
    params = jax.tree.map(np.asarray, params)
    port = ASRModel(tiny_port_cfg(specaug=None, **pkw), device="cpu")
    port.load_state_dict(flax_to_torch(params))
    return jmodel, params, port


def assert_asr_loss_matches(jmodel, params, port, tol=1e-4, train=True):
    """The training loss, its stats and every gradient of ``port`` against
    the reference's at fp32 on two ragged utterances (with ``train``
    False, the loss of the eval forward: for a model with dropout that
    the config's rate does not set, as the Sinc pre-encoder's)."""
    import jax
    x, lens = waveforms([4096, 3000], seed=11)
    batch = dict(speech=x, speech_lengths=lens, text=LOSS_TEXT,
                 text_lengths=LOSS_TEXT_LENGTHS)
    (ref_loss, ref_stats), ref_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, train=train, **batch),
        has_aux=True))(params)
    loss, stats = port(**{k: t(v) for k, v in batch.items()}, train=train)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=tol)
    assert set(stats) == set(ref_stats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]),
                                   rtol=tol, err_msg=k)
    assert_grads_match(port.named_parameters(), ref_g, tol)
