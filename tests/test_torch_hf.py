"""models/hf_transformer.py against the reference's BERT and GPT-2 and against
``transformers``; the model-directory loaders and the port's safetensors
reader.

The reference's flax parameters reach the port through
utils/params.py:flax_to_torch, a ``transformers`` model's through the
port's HF mappings. Hidden states agree within ATOL on the valid rows
(fp32 on the CPU on both sides). ``transformers`` and ``safetensors`` are
used by the tests only (the package imports neither); their tests skip
where they are absent."""
import dataclasses
import json
import os
import torch_parity  # noqa: F401  (each test worker's CPU threads)

# transformers (tests only) loads TensorFlow where one is installed: not
# needed here, and seconds to import.
os.environ.setdefault("USE_TF", "0")

import jax
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.models import hf_transformer as jhf
from espnet_slurp_tpu_torch.models import hf_transformer as phf
from espnet_slurp_tpu_torch.utils.params import flax_to_torch

ATOL = 2e-5
BERT = dict(vocab_size=50, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=24)
GPT2 = dict(vocab_size=50, n_embd=32, n_layer=2, n_head=2, n_positions=24)


def _inputs(seed=0, t=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 50, (2, t)).astype(np.int32)
    mask = np.ones((2, t), np.int32)
    mask[1, 5:] = 0  # a row shorter than its padding
    types = (np.arange(t)[None] >= 4).astype(np.int32).repeat(2, 0)
    return ids, mask, types


def _valid(x, mask):
    return np.asarray(x)[mask.astype(bool)]


@pytest.fixture(scope="module")
def bert_ref():
    cfg = jhf.BertConfig(**BERT)
    model = jhf.BertModel(cfg)
    ids, mask, types = _inputs()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), ids, mask,
                                 types)["params"]
    port = phf.BertModel(phf.BertConfig(**BERT), device="cpu")
    port.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return model, params, port


@pytest.mark.parametrize("embeds", [False, True],
                         ids=["input_ids", "inputs_embeds"])
def test_bert_matches_the_reference(bert_ref, embeds):
    model, params, port = bert_ref
    ids, mask, types = _inputs(1)
    if embeds:  # the postencoder's path: continuous inputs
        x = np.random.RandomState(2).randn(2, 9, 32).astype(np.float32)
        want = jax.jit(lambda p: model.apply(
            {"params": p}, None, mask, types, inputs_embeds=x))(params)
        got = port(None, torch.from_numpy(mask), torch.from_numpy(types),
                   inputs_embeds=torch.from_numpy(x))
    else:
        want = jax.jit(lambda p: model.apply({"params": p}, ids, mask,
                                             types))(params)
        got = port(torch.from_numpy(ids), torch.from_numpy(mask),
                   torch.from_numpy(types))
    np.testing.assert_allclose(_valid(got.detach(), mask),
                               _valid(want, mask), rtol=0, atol=ATOL)


def test_gpt2_matches_the_reference():
    cfg = jhf.GPT2Config(**GPT2)
    model = jhf.GPT2Model(cfg)
    ids, mask, _ = _inputs(3)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), ids, mask)["params"]
    want = jax.jit(lambda p: model.apply({"params": p}, ids, mask))(params)
    port = phf.GPT2Model(phf.GPT2Config(**GPT2), device="cpu")
    port.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(_valid(got.detach(), mask),
                               _valid(want, mask), rtol=0, atol=ATOL)


def _hf_models():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    bert = transformers.BertModel(transformers.BertConfig(
        **BERT, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)).eval()
    gpt2 = transformers.GPT2Model(transformers.GPT2Config(
        **GPT2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    return bert, gpt2


def test_hf_mappings_match_transformers():
    bert, gpt2 = _hf_models()
    ids, mask, types = (torch.from_numpy(a).long() for a in _inputs(4))
    with torch.no_grad():
        want_b = bert(input_ids=ids, attention_mask=mask,
                      token_type_ids=types).last_hidden_state
        want_g = gpt2(input_ids=ids, attention_mask=mask).last_hidden_state
    pb = phf.BertModel(phf.BertConfig(**BERT), device="cpu")
    pb.load_state_dict(phf.bert_params_from_torch(
        bert.state_dict(), pb.cfg))
    pg = phf.GPT2Model(phf.GPT2Config(**GPT2), device="cpu")
    pg.load_state_dict(phf.gpt2_params_from_torch(gpt2.state_dict(), pg.cfg))
    m = mask.numpy()
    with torch.no_grad():
        np.testing.assert_allclose(_valid(pb(ids, mask, types), m),
                                   _valid(want_b, m), rtol=0, atol=ATOL)
        np.testing.assert_allclose(_valid(pg(ids, mask), m),
                                   _valid(want_g, m), rtol=0, atol=ATOL)
    # the reference's mapping of the same checkpoint equals the port's
    jp = jhf.bert_params_from_torch(
        {k: v.numpy() for k, v in bert.state_dict().items()},
        jhf.BertConfig(**BERT))
    ref = flax_to_torch(jp)
    own = phf.bert_params_from_torch(bert.state_dict(), pb.cfg)
    assert sorted(ref) == sorted(own)
    assert all(torch.equal(ref[k], own[k]) for k in ref)


@pytest.mark.parametrize("safe", [False, True],
                         ids=["pytorch_model.bin", "model.safetensors"])
def test_model_directory_round_trip(tmp_path, safe):
    """save_pretrained -> load_{bert,gpt2}_from_dir: every tensor byte for
    byte, the same hidden states; model.safetensors through the port's own
    reader."""
    bert, gpt2 = _hf_models()
    ids, mask, _ = (torch.from_numpy(a).long() for a in _inputs(5))
    for hf, load, mapping in (
            (bert, phf.load_bert_from_dir, phf.bert_params_from_torch),
            (gpt2, phf.load_gpt2_from_dir, phf.gpt2_params_from_torch)):
        d = tmp_path / type(hf).__name__
        hf.save_pretrained(d, safe_serialization=safe)
        assert (d / ("model.safetensors" if safe
                     else "pytorch_model.bin")).exists()
        model, sd = load(d, device="cpu")
        want = mapping(hf.state_dict(), model.cfg)
        assert sorted(sd) == sorted(want)
        assert all(torch.equal(sd[k], want[k].float()) for k in want)
        with torch.no_grad():
            ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
            m = mask.numpy()
            np.testing.assert_allclose(_valid(model(ids, mask), m),
                                       _valid(ref, m), rtol=0, atol=ATOL)


def test_safetensors_reader_equals_the_library(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "w": torch.randn(3, 5, generator=gen),
        "h": torch.randn(4, generator=gen).half(),
        "b": torch.randn(2, 3, generator=gen).bfloat16(),
        "ids": torch.arange(7, dtype=torch.int64).reshape(7, 1),
        "flag": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = tmp_path / "m.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = phf.read_safetensors(path)
    want = st.load_file(str(path))
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    header_len = int.from_bytes(path.read_bytes()[:8], "little")
    assert "__metadata__" in json.loads(path.read_bytes()[8:8 + header_len])


def test_the_bert_config_of_a_directory(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {**BERT, "type_vocab_size": 3, "layer_norm_eps": 1e-7}))
    cfg = phf.bert_config_from_dir(tmp_path)
    assert cfg == phf.BertConfig(**BERT, type_vocab_size=3,
                                 layer_norm_eps=1e-7)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jhf.BertConfig(
        **BERT, type_vocab_size=3, layer_norm_eps=1e-7))
