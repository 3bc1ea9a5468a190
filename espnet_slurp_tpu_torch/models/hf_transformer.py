"""BERT and GPT-2 with HuggingFace semantics, and the bridge from HF weights.

Port of espnet_slurp_tpu/models/hf_transformer.py: ``BertConfig``,
``GPT2Config``, ``BertModel`` (post-LN blocks, learned position and
token-type embeddings, exact GELU, ``inputs_embeds``), ``GPT2Model``
(pre-LN blocks, the fused ``c_attn`` projection, tanh GELU), the mappings
from a HF ``state_dict`` to this port's (``bert_params_from_torch``,
``gpt2_params_from_torch``) and the loaders of a local HF model directory.

The modules are named as the flax tree names them (``layer_{i}_q``,
``h_{i}_c_attn``, ``embeddings_ln``, ...), so utils/params.py:flax_to_torch
carries a reference tree across. Parameters stay fp32 and every layer
computes in ``dtype`` (models/layers.py). The attention is plain tensor
ops in the reference's order (fp32 scores, a -1e9 bias, the softmax cast to
the compute dtype): the reference runs it outside any Pallas kernel, over
text streams of at most 512 tokens.

A model directory holds ``config.json`` and ``model.safetensors`` or
``pytorch_model.bin``. Neither ``transformers`` nor ``safetensors`` is
needed: the ``.bin`` file is read by ``torch.load(weights_only=True)`` and
the safetensors file by ``read_safetensors`` (a little-endian u64 header
length, a JSON header giving each tensor's dtype, shape and byte offsets,
then the raw bytes). Unlike the reference, which casts imported weights to
the compute dtype, the loaders keep them fp32 (the port's parameters are
fp32 masters in every dtype).
"""
from __future__ import annotations

import dataclasses
import json
import math
import struct
from pathlib import Path
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_epsilon: float = 1e-5


def _attn(q, k, v, bias, n_head):
    """[B, T, D] q, k, v and an additive fp32 bias [B or 1, 1, T or 1, T]
    -> [B, T, D]: scores in fp32, softmax cast to q's dtype."""
    b, t, d = q.shape
    dh = d // n_head
    split = lambda x: x.reshape(b, t, n_head, dh).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = q.float() @ k.float().transpose(-1, -2) / math.sqrt(dh) + bias
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = (w.float() @ v.float()).to(q.dtype)
    return o.transpose(1, 2).reshape(b, t, d)


def _mask_bias(allow: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=allow.device)
    return torch.where(allow, zero, torch.full_like(zero, -1e9))


class BertModel(nn.Module):
    """HF ``BertModel`` (encoder only, no pooler): forward(input_ids,
    attention_mask, token_type_ids, inputs_embeds) -> [B, T, H] hidden
    states in ``dtype``. Built on the CPU unless ``device`` is given (a
    model that holds it moves it; the loaders place it)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        h, eps = c.hidden_size, c.layer_norm_eps
        self.word_embeddings = nn.Embedding(c.vocab_size, h)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, h)
        self.embeddings_ln = LayerNorm(h, eps=eps)
        for i in range(c.num_hidden_layers):
            p = f"layer_{i}"
            for name in ("q", "k", "v", "attn_out"):
                self.add_module(f"{p}_{name}", Linear(h, h))
            self.add_module(f"{p}_attn_ln", LayerNorm(h, eps=eps))
            self.add_module(f"{p}_ffn_in", Linear(h, c.intermediate_size))
            self.add_module(f"{p}_ffn_out", Linear(c.intermediate_size, h))
            self.add_module(f"{p}_ffn_ln", LayerNorm(h, eps=eps))
        if device is not None:
            self.to(resolve_device(device))

    def forward(self, input_ids=None, attention_mask=None,
                token_type_ids=None, inputs_embeds=None):
        """``inputs_embeds`` [B, T, H] (HF semantics) bypasses the word
        embedding."""
        c = self.cfg
        if inputs_embeds is not None:
            b, t = inputs_embeds.shape[:2]
            dev = inputs_embeds.device
            x = inputs_embeds.to(self.dtype)
        else:
            b, t = input_ids.shape
            dev = input_ids.device
            x = self.word_embeddings(input_ids.long()).to(self.dtype)
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, t), dtype=torch.long, device=dev)
        x = x + self.position_embeddings(
            torch.arange(t, device=dev))[None].to(self.dtype)
        x = x + self.token_type_embeddings(token_type_ids.long()).to(
            self.dtype)
        x = self.embeddings_ln(x)
        bias = _mask_bias(attention_mask[:, None, None, :] > 0)
        for i in range(c.num_hidden_layers):
            m = lambda name: getattr(self, f"layer_{i}_{name}")
            a = _attn(m("q")(x), m("k")(x), m("v")(x), bias,
                      c.num_attention_heads)
            x = m("attn_ln")(x + m("attn_out")(a))  # post-LN
            h = m("ffn_out")(F.gelu(m("ffn_in")(x)))
            x = m("ffn_ln")(x + h)
        return x


class GPT2Model(nn.Module):
    """HF ``GPT2Model`` (causal decoder): forward(input_ids, attention_mask)
    -> [B, T, n_embd] hidden states after ``ln_f``, in ``dtype``."""

    def __init__(self, cfg: GPT2Config, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        d, eps = c.n_embd, c.layer_norm_epsilon
        self.wte = nn.Embedding(c.vocab_size, d)
        self.wpe = nn.Embedding(c.n_positions, d)
        for i in range(c.n_layer):
            p = f"h_{i}"
            self.add_module(f"{p}_ln1", LayerNorm(d, eps=eps))
            self.add_module(f"{p}_c_attn", Linear(d, 3 * d))
            self.add_module(f"{p}_c_proj", Linear(d, d))
            self.add_module(f"{p}_ln2", LayerNorm(d, eps=eps))
            self.add_module(f"{p}_c_fc", Linear(d, 4 * d))
            self.add_module(f"{p}_c_mlp_proj", Linear(4 * d, d))
        self.ln_f = LayerNorm(d, eps=eps)
        if device is not None:
            self.to(resolve_device(device))

    def forward(self, input_ids, attention_mask=None):
        c = self.cfg
        b, t = input_ids.shape
        dev = input_ids.device
        x = self.wte(input_ids.long()).to(self.dtype)
        x = x + self.wpe(torch.arange(t, device=dev))[None].to(self.dtype)
        ar = torch.arange(t, device=dev)
        allow = (ar[None, :] <= ar[:, None])[None, None]
        if attention_mask is not None:
            allow = allow & (attention_mask[:, None, None, :] > 0)
        bias = _mask_bias(allow)
        for i in range(c.n_layer):
            m = lambda name: getattr(self, f"h_{i}_{name}")
            q, k, v = m("c_attn")(m("ln1")(x)).chunk(3, dim=-1)  # pre-LN
            x = x + m("c_proj")(_attn(q, k, v, bias, c.n_head))
            h = F.gelu(m("c_fc")(m("ln2")(x)), approximate="tanh")
            x = x + m("c_mlp_proj")(h)
        return self.ln_f(x)


# ---------------------------------------------------------------------------
# HF state_dict -> this port's state_dict
# ---------------------------------------------------------------------------

def _copy(out, sd, dst, src, transpose=False):
    for leaf in ("weight", "bias"):
        v = torch.as_tensor(sd[f"{src}.{leaf}"])
        out[f"{dst}.{leaf}"] = (v.t() if transpose and leaf == "weight"
                                else v).contiguous()


def bert_params_from_torch(state_dict: Mapping[str, torch.Tensor],
                           cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """A HF ``BertModel.state_dict()`` (bare or ``bert.``-prefixed keys)
    -> BertModel's state_dict (torch Linear weights keep their layout)."""
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{name}.weight"] = torch.as_tensor(
            sd[f"embeddings.{name}.weight"])
    _copy(out, sd, "embeddings_ln", "embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        e, p = f"encoder.layer.{i}", f"layer_{i}"
        for dst, src in (("q", "attention.self.query"),
                         ("k", "attention.self.key"),
                         ("v", "attention.self.value"),
                         ("attn_out", "attention.output.dense"),
                         ("attn_ln", "attention.output.LayerNorm"),
                         ("ffn_in", "intermediate.dense"),
                         ("ffn_out", "output.dense"),
                         ("ffn_ln", "output.LayerNorm")):
            _copy(out, sd, f"{p}_{dst}", f"{e}.{src}")
    return out


def gpt2_params_from_torch(state_dict: Mapping[str, torch.Tensor],
                           cfg: GPT2Config) -> Dict[str, torch.Tensor]:
    """A HF ``GPT2Model.state_dict()`` (bare or ``transformer.``-prefixed
    keys) -> GPT2Model's state_dict. HF's ``Conv1D`` weight is [in, out]:
    transposed into the Linear layout."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    out = {"wte.weight": torch.as_tensor(sd["wte.weight"]),
           "wpe.weight": torch.as_tensor(sd["wpe.weight"])}
    _copy(out, sd, "ln_f", "ln_f")
    for i in range(cfg.n_layer):
        e, p = f"h.{i}", f"h_{i}"
        _copy(out, sd, f"{p}_ln1", f"{e}.ln_1")
        _copy(out, sd, f"{p}_ln2", f"{e}.ln_2")
        for dst, src in (("c_attn", "attn.c_attn"), ("c_proj", "attn.c_proj"),
                         ("c_fc", "mlp.c_fc"), ("c_mlp_proj", "mlp.c_proj")):
            _copy(out, sd, f"{p}_{dst}", f"{e}.{src}", transpose=True)
    return out


def bert_config_from_dir(model_dir) -> BertConfig:
    """The BertConfig of a HF model directory's config.json."""
    hf = json.loads((Path(model_dir) / "config.json").read_text())
    return BertConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12))


def load_bert_from_dir(model_dir, dtype: torch.dtype = torch.float32,
                       device=None) -> Tuple[BertModel, Dict]:
    """(BertModel on ``device`` (the card unless given, e.g. "cpu") with
    the checkpoint's weights, its state_dict) from a local HF model
    directory."""
    cfg = bert_config_from_dir(model_dir)
    sd = bert_params_from_torch(_load_state_dict(model_dir), cfg)
    sd = {k: v.float() for k, v in sd.items()}
    model = BertModel(cfg, dtype=dtype, device=resolve_device(device))
    model.load_state_dict(sd)
    return model, sd


def gpt2_config_from_dir(model_dir) -> GPT2Config:
    """The GPT2Config of a HF model directory's config.json."""
    hf = json.loads((Path(model_dir) / "config.json").read_text())
    return GPT2Config(
        vocab_size=hf["vocab_size"], n_embd=hf["n_embd"],
        n_layer=hf["n_layer"], n_head=hf["n_head"],
        n_positions=hf["n_positions"],
        layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5))


def gpt2_state_dict_from_dir(model_dir, cfg: GPT2Config
                             ) -> Dict[str, torch.Tensor]:
    """GPT2Model's fp32 state_dict from a local HF model directory."""
    sd = gpt2_params_from_torch(_load_state_dict(model_dir), cfg)
    return {k: v.float() for k, v in sd.items()}


def load_gpt2_from_dir(model_dir, dtype: torch.dtype = torch.float32,
                       device=None) -> Tuple[GPT2Model, Dict]:
    """(GPT2Model on ``device``, its state_dict), as load_bert_from_dir."""
    cfg = gpt2_config_from_dir(model_dir)
    sd = gpt2_state_dict_from_dir(model_dir, cfg)
    model = GPT2Model(cfg, dtype=dtype, device=resolve_device(device))
    model.load_state_dict(sd)
    return model, sd


_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU: an 8-byte
    little-endian header length N, N bytes of JSON ({name: {dtype, shape,
    data_offsets [begin, end)}}, plus an optional ``__metadata__``), then
    the data, each tensor's bytes little-endian and row-major."""
    raw = bytearray(Path(path).read_bytes())
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        size = torch.tensor([], dtype=dtype).element_size()
        if (end - begin) % size:
            raise ValueError(f"{path}: {name}: {end - begin} bytes is no "
                             f"whole number of {info['dtype']}")
        flat = torch.frombuffer(raw, dtype=dtype, count=(end - begin) // size,
                                offset=base + begin) if end > begin \
            else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"]).clone()
    return out


def _load_state_dict(d) -> Dict[str, torch.Tensor]:
    d = Path(d)
    if (d / "model.safetensors").exists():
        return read_safetensors(d / "model.safetensors")
    return torch.load(d / "pytorch_model.bin", map_location="cpu",
                      weights_only=True)
