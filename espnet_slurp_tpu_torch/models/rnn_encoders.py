"""RNN / VGG-RNN encoders. Port of espnet_slurp_tpu/models/rnn_encoders.py
(``VGG2L``, ``RNNPEncoder``, ``RNNEncoder``, ``VGGRNNEncoder``).

The LSTM layers are models/layers.py:LSTMLayer (flax's
OptimizedLSTMCell). The backward direction is flax's ``nn.RNN(reverse=True,
keep_order=True, seq_lengths=...)``: each row is flipped within its own
length (the padded tail is flipped in place behind it), scanned, and
flipped back, so a valid frame's backward state never sees padding, while
the forward direction runs on over the padded tail. VGG2L's max-pools are
flax's "SAME" pools, which are ceil pools, and its output is flattened as
flax's NHWC (frequency, channel), channel fastest. The reference's cells
are built in RNNPEncoder's scope, so its tree names them
``OptimizedLSTMCell_{n}`` in the order built (layer by layer, the forward
before the backward), and so does the port.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LSTMLayer, Linear, dropout


def flip_within_lengths(x: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
    """flax's flip_sequences on [B, T, ...]: row b's first lengths[b] steps
    reversed, the rest reversed in place after them (an involution)."""
    t = x.shape[1]
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None]
           + lengths.to(x.device).long()[:, None]) % t
    return x.gather(1, idx.view(*idx.shape, *([1] * (x.dim() - 2)))
                    .expand_as(x))


class VGG2L(nn.Module):
    """Two VGG blocks (64 / 128 channels, two 3x3 convs + ReLU each, a 2x2
    ceil max-pool): [B, T, F] -> [B, ceil(T/4), 128 * ceil(F/4)]."""

    def __init__(self):
        super().__init__()
        ch_in = 1
        for i, ch in enumerate((64, 128)):
            self.add_module(f"conv{i}_1", Conv2d(ch_in, ch, 3, padding=1))
            self.add_module(f"conv{i}_2", Conv2d(ch, ch, 3, padding=1))
            ch_in = ch

    @staticmethod
    def out_dim(idim: int) -> int:
        return 128 * (-(-(-(-idim // 2)) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]  # [B, 1, T, F]
        for i in range(2):
            h = torch.relu(getattr(self, f"conv{i}_1")(h))
            h = torch.relu(getattr(self, f"conv{i}_2")(h))
            h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        b, c, t4, f4 = h.shape
        return h.permute(0, 2, 3, 1).reshape(b, t4, f4 * c)

    @staticmethod
    def out_length(lengths: torch.Tensor) -> torch.Tensor:
        return -(-(-(-lengths // 2)) // 2)


class RNNPEncoder(nn.Module):
    """Stacked (B)LSTM layers, each followed by a projection to ``d_model``
    and tanh; dropout between layers when ``train``; each layer's output
    subsampled by its factor in ``subsample`` (lengths ceil(l / s))."""

    def __init__(self, idim: int, d_model: int = 320, units: int = 320,
                 num_layers: int = 4, bidirectional: bool = True,
                 subsample: Sequence[int] = (), dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.subsample, self.dropout_rate = tuple(subsample), dropout_rate
        self.dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            d_in = idim if layer == 0 else d_model
            for k in range(self.dirs):
                self.add_module(f"OptimizedLSTMCell_{self.dirs * layer + k}",
                                LSTMLayer(d_in, units))
            self.add_module(f"l{layer}_proj", Linear(
                units * (2 if bidirectional else 1), d_model))

    def forward(self, x, lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        dtype = x.dtype
        for layer in range(self.num_layers):
            cell = lambda k: getattr(
                self, f"OptimizedLSTMCell_{self.dirs * layer + k}")
            h = cell(0)(x)
            if self.bidirectional:
                bwd = cell(1)(flip_within_lengths(x, lengths))
                h = torch.cat([h, flip_within_lengths(bwd, lengths)], -1)
            x = torch.tanh(getattr(self, f"l{layer}_proj")(h.to(dtype)))
            if train and layer < self.num_layers - 1:
                x = dropout(x, self.dropout_rate, generator)
            s = self.subsample[layer] if layer < len(self.subsample) else 1
            if s > 1:
                x = x[:, ::s]
                lengths = -(-lengths // s)
        return x, lengths


class RNNEncoder(nn.Module):
    """``encoder: rnn``: RNNP over the features. forward(feats [B, T, idim],
    lengths, train, generator) -> (hs, h_lengths, [])."""

    def __init__(self, idim: int, d_model: int = 320, units: int = 320,
                 num_layers: int = 4, bidirectional: bool = True,
                 subsample: Sequence[int] = (1, 2, 2, 1),
                 dropout_rate: float = 0.0):
        super().__init__()
        self.rnnp = RNNPEncoder(idim, d_model, units, num_layers,
                                bidirectional, subsample, dropout_rate)

    def forward(self, feats, feat_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        hs, olens = self.rnnp(feats, feat_lengths, train, generator)
        return hs, olens, []


class VGGRNNEncoder(nn.Module):
    """``encoder: vgg_rnn``: VGG2L (x4 in time) + RNNP without
    subsampling."""

    def __init__(self, idim: int, d_model: int = 320, units: int = 320,
                 num_layers: int = 4, bidirectional: bool = True,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.vgg = VGG2L()
        self.rnnp = RNNPEncoder(VGG2L.out_dim(idim), d_model, units,
                                num_layers, bidirectional, (), dropout_rate)

    def forward(self, feats, feat_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.vgg(feats)
        hs, olens = self.rnnp(x, VGG2L.out_length(feat_lengths), train,
                              generator)
        return hs, olens, []
