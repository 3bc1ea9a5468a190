"""Parameter bridge from a flax tree, and seeded random weights.

``flax_to_torch`` turns the reference's nested param dict (numpy leaves)
into this port's state_dict. The port names its modules as the flax tree
does, so the key is the flax path joined by "." with the leaf renamed:

- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW, and 1-D [k, in/groups,
  out] -> Conv1d [out, in/groups, k] (the depthwise [k, 1, D] -> [D, 1, k]);
- LayerNorm ``scale`` -> ``weight`` (``bias`` stays);
- Embed ``embedding`` -> Embedding ``weight``;
- ``pos_bias_u`` / ``pos_bias_v`` unchanged;
- the MoE's expert tensors ``w1`` [E, D, F], ``b1`` [E, F], ``w2`` [E, F,
  D], ``b2`` [E, D] unchanged (models/moe.py keeps the reference's
  layout; its ``router`` is a Dense like any other);
- TCPGen's raw parameters ``ooKBemb`` [1, D] and the GAT tree encoder's
  ``a_src_l{i}`` / ``a_tgt_l{i}`` [heads, D] and ``bias_l{i}`` unchanged
  (models/tcpgen.py names them as the flax tree does);
- an ``nn.OptimizedLSTMCell`` (``<rnn>/cell/{ii,if,ig,io}/kernel``,
  ``{hi,hf,hg,ho}/{kernel,bias}``; no input-side bias), under an
  ``nn.RNN`` (the ``cell`` level: the LMs, the prediction network, both
  directions of the RNN encoders' ``l{i}_fwd`` / ``l{i}_bwd``) or alone
  (the LAS decoder's ``lstm_{i}``) -> the port's ``LSTMLayer``
  ``<rnn>.weight_ih`` [4P, in], ``weight_hh`` [4P, P] and ``bias_hh``
  [4P], gates stacked in the order i, f, g, o (torch's): the same
  scalars, in 3 tensors instead of 12;
- the raw parameters of the pre-encoder's ``SincConv`` (``f`` [C, 2]) and
  of the decoders' lightweight convs (``weight`` [H, k], ``weight_f``
  [k]) unchanged; their ``linear_weight`` / ``linear_weight_f`` are
  Dense; the VGG front's 3x3 convs (HWIO -> OIHW) and the grouped 1-D
  convs of the E-Branchformer, the Sinc blocks and the post-encoder's
  length adaptors ([k, in/groups, out] -> [out, in/groups, k]) follow the
  conv rule;
- the SSL models' trees (models/wav2vec2.py, models/hubert.py): the
  wav2vec2 encoder's ``feature_extractor/conv_{i}`` (bias-free [k, in,
  out] convs) and ``gn`` (a GroupNorm: ``scale`` -> ``weight``), ``fp_norm``,
  ``fp_proj``, the grouped ``pos_conv`` ([k, D / groups, D], the conv
  rule), ``enc_norm``, ``attn_{i}/linear_*``, ``norm{1,2}_{i}``,
  ``ff{1,2}_{i}``; the pretraining model's ``quantizer/{proj,out}``,
  ``final_proj`` and HuBERT's ``pred`` (Dense), and the raw
  ``ssl_layer_weights`` [L] of an ASR tree, ``mask_emb`` [D] and
  ``quantizer/codebook`` [G, V, vq_dim / G], unchanged.

A language model's tree (models/lm.py: ``embed``, ``attn_{i}/linear_*``,
``norm{1,2}_{i}``, ``ff_{i}/w{1,2}``, ``after_norm``, ``output`` and
``rnn_{i}/cell``) converts by these rules, with no renaming.

A post-encoder's BERT (``postencoder/bert``) is Dense, LayerNorm and Embed
leaves, as the SLU postdecoder's. A leaf with no rule raises here, and a
key that the tree lacks or the model does not have raises in the model's
(strict) ``load_state_dict``.

The one module renamed is the CTC head: flax ``ctc`` is ``ctc_proj`` here,
at the top of an ASR tree and under ``asr`` in an SLU or a MaskCTC tree
(slu/model.py and models/maskctc.py hold their ASR model there). An SLU
tree's BERT postdecoder (models/hf_transformer.py) and text encoder are
Dense, LayerNorm and Embed leaves like any other, and so are the KA2G
trees (slu/generator.py's ``SlotGenerator``, ``GPT2JointText``;
slu/ka2g.py's ``KA2GModel``, whose ``asr`` holds the CTC head too). A
``KA2GModel`` tree has no ``asr/decoder`` subtree (its loss never calls
the decoder, so flax makes none): ``ka2g_state_dict`` keeps the port's
decoder at the model's own values and logs how many tensors it kept.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

log = logging.getLogger("espnet_slurp_tpu_torch")

# The CTC head's flax name -> the port's, at the top of a tree or under
# the module that holds an ASR model (an SLU or a MaskCTC tree's ``asr``).
_CTC_RENAMES = {("ctc",): ("ctc_proj",), ("asr", "ctc"): ("asr", "ctc_proj")}
# Leaves kept as they are: attention biases, the MoE's expert tensors and
# TCPGen's raw parameters.
_RAW_LEAF = re.compile(r"(bias|pos_bias_[uv]|[wb][12]|ooKBemb"
                       r"|(a_src|a_tgt|bias)_l\d+|weight(_f)?|f"
                       r"|ssl_layer_weights|mask_emb|codebook)$")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convert_leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if _RAW_LEAF.match(name):
        return name, value
    raise ValueError(f"no conversion for flax leaf {name!r}")


_LSTM_GATES = "ifgo"
_LSTM_LEAVES = {side + g for side in "ih" for g in _LSTM_GATES}


def _lstm_leaves(cells: Dict[tuple, Dict[str, np.ndarray]]):
    """{rnn path: {"ii/kernel": ..., ...}} -> [(key, value)] of LSTMLayer."""
    for path, leaves in cells.items():
        stack = lambda side, leaf: np.concatenate(
            [leaves[f"{side}{g}/{leaf}"].T if leaf == "kernel"
             else leaves[f"{side}{g}/{leaf}"] for g in _LSTM_GATES], 0)
        prefix = ".".join(path)
        yield prefix + ".weight_ih", stack("i", "kernel")
        yield prefix + ".weight_hh", stack("h", "kernel")
        yield prefix + ".bias_hh", stack("h", "bias")


def _rename(path: tuple) -> tuple:
    for n in (1, 2):
        if path[:n] in _CTC_RENAMES and len(path) > n:
            return _CTC_RENAMES[path[:n]] + path[n:]
    return path


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (np.ndarray leaves) -> this port's state_dict."""
    out, cells = {}, {}
    for path, value in _flatten(params).items():
        path = _rename(path)
        if len(path) >= 3 and path[-3] == "cell":
            cells.setdefault(path[:-3], {})["/".join(path[-2:])] = value
            continue
        if len(path) >= 3 and path[-2] in _LSTM_LEAVES:  # a bare cell
            cells.setdefault(path[:-2], {})["/".join(path[-2:])] = value
            continue
        leaf, converted = _convert_leaf(path[-1], value)
        out[".".join(path[:-1] + (leaf,))] = converted
    out.update(_lstm_leaves(cells))
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}


def ka2g_state_dict(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A reference ``KA2GModel`` tree -> the port's KA2GModel state_dict.
    The tree's missing ``asr/decoder`` subtree keeps ``model``'s own values
    (its initial ones), logged; any other key that the tree lacks or the
    model does not have raises."""
    sd = flax_to_torch(params)
    own = model.state_dict()
    kept = sorted(k for k in own if k not in sd
                  and k.startswith("asr.decoder."))
    missing = sorted(set(own) - set(sd) - set(kept))
    unknown = sorted(set(sd) - set(own))
    if missing or unknown:
        raise ValueError(f"ka2g_state_dict: missing {missing[:5]}, unknown "
                         f"{unknown[:5]}")
    if kept:
        log.info("ka2g_state_dict: the reference tree has no asr/decoder; "
                 "%d decoder tensors keep the model's initial values",
                 len(kept))
    return {**{k: own[k] for k in kept}, **sd}


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter from a seeded CPU ``torch.Generator``: weights
    of rank >= 2 ~ N(0, 1/fan_in), LayerNorm scales 1, biases and other
    vectors ~ N(0, 0.02). Returns the model."""
    gen = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for p in model.parameters():
            if id(p) in norms:
                p.fill_(1.0)
                continue
            if p.ndim >= 2:
                std = float(np.prod(p.shape[1:])) ** -0.5
            else:
                std = 0.02
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model
