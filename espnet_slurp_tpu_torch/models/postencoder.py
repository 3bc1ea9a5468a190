"""HF-transformers post-encoder over the acoustic encoder's states. Port of
espnet_slurp_tpu/models/postencoder.py (``HFTransformersPostencoder``).

Optional length adaptors (a k-3, stride-2, "SAME" conv + ReLU each;
lengths ceil(l / 2)), then ``linear_in`` to the transformer's width, the
port's models/hf_transformer.py:BertModel fed through ``inputs_embeds``
(it has no word embedding; positions and token types are added inside) with
the valid frames as its attention mask, and ``linear_out`` back to the ASR
width. The geometry is the config's (``max_position_embeddings`` 4096), or
with ``hf_dir`` the directory's config.json; ASRTask.train then grafts the
directory's weights into ``bert`` (``load_postencoder_weights``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .hf_transformer import BertConfig, BertModel, bert_config_from_dir
from .layers import Conv1d, Linear


def _same_stride2(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """flax "SAME" k-3 stride-2 conv over time: [B, T, C] -> [B, ceil(T/2),
    C'], the padding split as flax splits it (the smaller half first)."""
    t = x.shape[1]
    total = max((-(-t // 2) - 1) * 2 + conv.kernel_size[0] - t, 0)
    h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return conv(h).transpose(1, 2)


class HFTransformersPostencoder(nn.Module):
    """[B, T, in_dim] encoder states -> ([B, T / 2^n, D], lengths), D =
    ``d_model`` (``in_dim`` defaults to it; the first adaptor, or
    ``linear_in`` without one, takes the encoder's width, as the
    reference's width-inferring flax layers do)."""

    def __init__(self, d_model: int, hidden_size: int = 256,
                 num_layers: int = 2, num_heads: int = 4,
                 intermediate_size: int = 1024,
                 length_adaptor_n_layers: int = 0,
                 hf_dir: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, in_dim: int = 0):
        super().__init__()
        if hf_dir:
            cfg = bert_config_from_dir(hf_dir)
        else:
            cfg = BertConfig(vocab_size=1, hidden_size=hidden_size,
                             num_hidden_layers=num_layers,
                             num_attention_heads=num_heads,
                             intermediate_size=intermediate_size,
                             max_position_embeddings=4096)
        self.n_adaptors = length_adaptor_n_layers
        self.bert = BertModel(cfg, dtype=dtype)
        # fed inputs_embeds only: the reference's tree has no word
        # embedding either
        del self.bert.word_embeddings
        in_dim = in_dim or d_model
        self.linear_in = Linear(d_model if length_adaptor_n_layers
                                else in_dim, cfg.hidden_size)
        self.linear_out = Linear(cfg.hidden_size, d_model)
        for i in range(length_adaptor_n_layers):
            self.add_module(f"adaptor_{i}", Conv1d(
                in_dim if i == 0 else d_model, d_model, 3, 2))

    def forward(self, hs: torch.Tensor, h_lengths: torch.Tensor):
        for i in range(self.n_adaptors):
            hs = torch.relu(_same_stride2(getattr(self, f"adaptor_{i}"), hs))
            h_lengths = -(-h_lengths // 2)
        x = self.linear_in(hs)
        t = x.shape[1]
        mask = (torch.arange(t, device=x.device)[None, :]
                < h_lengths.to(x.device)[:, None]).to(torch.int32)
        x = self.bert(None, attention_mask=mask, inputs_embeds=x)
        return self.linear_out(x), h_lengths
