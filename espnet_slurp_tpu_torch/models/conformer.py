"""Conformer encoder. Port of espnet_slurp_tpu/models/conformer.py.

Macaron FFN halves (kernel K2 where it takes the widths), rel-pos MHSA
(kernel K3), a depthwise conv module with LayerNorm (with ``fused_conv``,
kernel K6), and Conv2d subsampling or a linear input layer. Unlike the
reference's TPU path, T' is not padded to a tile multiple: the kernels
mask the ragged edge (so the MoE's capacity follows the unpadded T', as
on the reference's CPU path). ``fused_conv`` is the port's form of the
reference's ``ESPNET_TPU_FUSED_CONV=1`` (models/conformer.py:184-191): off
by default, and in effect only on the kernel path (``flash != "off"``).
The encoder's options are the reference's: routed MoE second FFNs
(models/moe.py) on every ``moe_every``-th block, stochastic depth, the
interCTC taps through the shared ``after_norm`` and self-conditioning,
``attention_window`` (the longformer's band, on the eager attention) and
``remat``. BatchNorm in the conv module waits for a later slice. Dropout
(``dropout_rate``, when ``train``) acts where the reference's does: on the
FFN hidden (in K2 or after the eager swish) and on the attention
probabilities (in K3 or on the eager softmax); each kernel call draws its
seed from the generator passed down from the model.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.kernels.conv_module import fused_conv_module
from ..ops.kernels.ffn import fused_ffn, fused_ffn_takes
from ..ops.kernels.philox import draw_seed
from ..ops.masks import attention_bias, band_mask, chunk_mask, length_mask
from .attention import RelPosMultiHeadAttention
from .embedding import Conv2dSubsampling, rel_positional_embedding
from .layers import Conv1d, LayerNorm, Linear, dropout
from .moe import MoEFeedForward

LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


class FeedForward(nn.Module):
    """dropout(swish(x W1 + b1)) W2 + b2; with ``use_flash`` through kernel
    K2 where it takes the shape (on the CPU: always, its plain version),
    else eager Linear -> silu -> dropout -> Linear. The route is decided
    from the shape before any launch, as the reference's 128-multiple rule
    (espnet_slurp_tpu/models/conformer.py:40-42) is; K2 masks ragged rows
    itself, so the rule here is the widths its launches take."""

    def __init__(self, d_model: int, d_ff: int, use_flash: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.use_flash, self.dropout_rate = use_flash, dropout_rate
        self.w1 = Linear(d_model, d_ff)
        self.w2 = Linear(d_ff, d_model)

    def _takes_kernel(self, x) -> bool:
        if not self.use_flash:
            return False
        if x.device.type == "cpu":
            return True
        d, f = self.w1.in_features, self.w1.out_features
        return fused_ffn_takes(x.numel() // d, d, f, self.w2.out_features,
                               x.dtype)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        rate = self.dropout_rate if train else 0.0
        if self._takes_kernel(x):
            # The kernel takes the reference's [in, out] weight layout, in
            # the compute dtype; the fp32 parameters get fp32 gradients.
            wt = lambda w: w.t().to(x.dtype).contiguous()
            seed = draw_seed(generator, x.device) if rate > 0.0 else None
            return fused_ffn(
                x.contiguous(), wt(self.w1.weight), self.w1.bias.float(),
                wt(self.w2.weight), self.w2.bias.float(), seed,
                dropout_rate=rate)
        return self.w2(dropout(F.silu(self.w1(x)), rate, generator))


class ConvModule(nn.Module):
    """Pointwise(2D) + GLU -> pad mask -> depthwise(k) -> LayerNorm ->
    swish -> pointwise(D). ``causal`` pads k-1 frames on the left only.
    With ``fused`` the whole chain is kernel K6, masked by ``lengths``
    (or, without them, by ``pad_mask``'s row sums)."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 causal: bool = False, fused: bool = False):
        super().__init__()
        self.kernel_size, self.causal, self.fused = kernel_size, causal, fused
        self.pointwise1 = Linear(d_model, 2 * d_model)
        self.depthwise = Conv1d(d_model, d_model, kernel_size,
                                groups=d_model)
        self.norm = LayerNorm(d_model, eps=LN_EPS)
        self.pointwise2 = Linear(d_model, d_model)

    def forward(self, x, pad_mask=None, lengths=None):
        if self.fused:
            if lengths is None and pad_mask is not None:
                lengths = pad_mask.sum(-1)
            d, dt = x.shape[-1], x.dtype
            return fused_conv_module(
                x.contiguous(), lengths, self.pointwise1.weight.to(dt),
                self.pointwise1.bias.float(),
                self.depthwise.weight.view(d, self.kernel_size),
                self.depthwise.bias, self.norm.weight, self.norm.bias,
                self.pointwise2.weight.to(dt), self.pointwise2.bias.float(),
                kernel_size=self.kernel_size, causal=self.causal,
                eps=self.norm.eps)
        h = F.glu(self.pointwise1(x), dim=-1)
        if pad_mask is not None:
            h = torch.where(pad_mask[..., None], h, torch.zeros_like(h))
        k = self.kernel_size
        # flax "SAME" pads (k-1)//2 on the left and the rest on the right.
        left = k - 1 if self.causal else (k - 1) // 2
        h = F.pad(h.transpose(1, 2), (left, k - 1 - left))
        h = self.depthwise(h).transpose(1, 2)
        return self.pointwise2(F.silu(self.norm(h)))


class ConformerBlock(nn.Module):
    """Macaron FFN half, rel-pos MHSA, conv module, second FFN half (a
    routed MoE with ``moe_experts`` > 0, when forward returns (x, aux)),
    then ``norm_final``. ``coeff`` (stochastic depth's 1 / (1 - rate) when
    training) scales every residual branch."""

    def __init__(self, d_model: int, n_head: int, d_ff: int,
                 kernel_size: int = 31, causal_conv: bool = False,
                 use_flash: bool = False, chunk_size: int = 0,
                 left_chunks: int = -1, fused_conv: bool = False,
                 dropout_rate: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        ln = lambda: LayerNorm(d_model, eps=LN_EPS)
        self.norm_ff1 = ln()
        self.ff1 = FeedForward(d_model, d_ff, use_flash, dropout_rate)
        self.norm_mha = ln()
        self.self_attn = RelPosMultiHeadAttention(n_head, d_model, use_flash,
                                                  dropout_rate)
        self.norm_conv = ln()
        self.conv = ConvModule(d_model, kernel_size, causal_conv,
                               fused=fused_conv and use_flash)
        self.norm_ff2 = ln()
        if moe_experts > 0:
            self.moe = MoEFeedForward(d_model, d_ff, moe_experts,
                                      moe_capacity_factor)
        else:
            self.ff2 = FeedForward(d_model, d_ff, use_flash, dropout_rate)
        self.norm_final = ln()

    def forward(self, x, pos_emb, mask_bias, pad_mask, lengths=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                coeff: float = 1.0):
        x = x + coeff * 0.5 * self.ff1(self.norm_ff1(x), train, generator)
        x = x + coeff * self.self_attn(
            self.norm_mha(x), pos_emb, mask_bias, lengths=lengths,
            chunk_size=self.chunk_size, left_chunks=self.left_chunks,
            train=train, generator=generator)
        x = x + coeff * self.conv(self.norm_conv(x), pad_mask, lengths)
        h = self.norm_ff2(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h, pad_mask)
            return self.norm_final(x + coeff * 0.5 * y), aux
        x = x + coeff * 0.5 * self.ff2(h, train, generator)
        return self.norm_final(x)


def _replay_draws(generator: Optional[torch.Generator]):
    """``torch.utils.checkpoint``'s context_fn for a block that draws from
    ``generator`` (its K2 / K3 seeds, the eager dropout masks): checkpoint
    restores the default RNGs only, so the recompute sets the generator
    back to its state at the block's forward, then returns it to where it
    was, and the recompute draws the forward's masks."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            saved["state"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        if generator is None:
            yield
            return
        now = generator.get_state()
        generator.set_state(saved["state"])
        try:
            yield
        finally:
            generator.set_state(now)

    return forward(), recompute()


class ConformerEncoder(nn.Module):
    """Conv2d subsampling (or ``input_layer="linear"``: Linear +
    LayerNorm, no time reduction) + N Conformer blocks + after_norm.

    forward: (feats [B, T, idim], feat_lengths [B]) -> (hs [B, T', D] with
    padded frames zeroed, h_lengths [B], taps). ``taps`` holds (layer,
    after_norm(x)) after each block of ``interctc_layers`` (with
    ``self_cond_vocab`` > 0: (layer, logits [B, T', V]) of the shared
    ``sc_ctc`` head, whose softmax ``sc_cond`` projects back into the
    stream), not zeroed at padded frames, then ("moe_aux", the summed
    load-balance loss) when ``moe_experts`` > 0, as the reference's list.
    ``flash``: "auto"/"on" route the FFNs and attention through kernels
    K2/K3 (whose plain versions run on the CPU); "off" and
    ``attention_window`` > 0 take the eager paths with an additive mask
    bias. ``fused_conv`` (kernel path only) runs each conv module through
    K6. With ``train`` the FFN hiddens and attention probabilities take
    ``dropout_rate``'s dropout, drawn from ``generator``, and each block
    is kept with probability 1 - ``stochastic_depth_rate`` (one draw on
    the device a block for the whole batch; the block is computed either
    way and selected, as the reference does). ``remat`` recomputes each
    block in the backward (torch.utils.checkpoint) with the forward's
    draws.
    """

    def __init__(self, idim: int, d_model: int = 256, n_head: int = 4,
                 d_ff: int = 2048, num_blocks: int = 12,
                 kernel_size: int = 31, chunk_size: int = 0,
                 left_chunks: int = -1, flash: str = "auto",
                 subsampling_factor: int = 4, fused_conv: bool = False,
                 dropout_rate: float = 0.0, interctc_layers=(),
                 attention_window: int = 0, remat: bool = False,
                 moe_experts: int = 0, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25,
                 input_layer: str = "conv2d",
                 stochastic_depth_rate: float = 0.0,
                 self_cond_vocab: int = 0):
        super().__init__()
        if flash not in ("auto", "on", "off"):
            raise ValueError(f"flash must be auto|on|off, got {flash!r}")
        if input_layer not in ("conv2d", "linear"):
            raise ValueError(f"input_layer must be conv2d|linear, got "
                             f"{input_layer!r}")
        self.d_model, self.num_blocks = d_model, num_blocks
        self.chunk_size, self.left_chunks = chunk_size, left_chunks
        self.attention_window = attention_window
        self.use_flash = flash != "off" and attention_window <= 0
        self.subsampling_factor = subsampling_factor
        self.input_layer = input_layer
        self.interctc_layers = tuple(interctc_layers)
        self.remat, self.moe_experts = remat, moe_experts
        self.stochastic_depth_rate = stochastic_depth_rate
        if input_layer == "linear":
            self.embed = Linear(idim, d_model)
            self.embed_norm = LayerNorm(d_model, eps=LN_EPS)
        else:
            self.embed = Conv2dSubsampling(idim, d_model, subsampling_factor)
        for i in range(num_blocks):
            moe_e = moe_experts if (
                moe_experts > 0 and (i + 1) % max(moe_every, 1) == 0) else 0
            self.add_module(f"block_{i}", ConformerBlock(
                d_model, n_head, d_ff, kernel_size,
                causal_conv=chunk_size > 0, use_flash=self.use_flash,
                chunk_size=chunk_size, left_chunks=left_chunks,
                fused_conv=fused_conv, dropout_rate=dropout_rate,
                moe_experts=moe_e, moe_capacity_factor=moe_capacity_factor))
        self.after_norm = LayerNorm(d_model, eps=LN_EPS)
        self.self_cond = self_cond_vocab > 0 and bool(self.interctc_layers)
        if self.self_cond:
            # One CTC head shared by the conditioning and the model's
            # intermediate CTC loss, as the reference's.
            self.sc_ctc = Linear(d_model, self_cond_vocab)
            self.sc_cond = Linear(self_cond_vocab, d_model)

    def forward(self, feats, feat_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.input_layer == "linear":
            x = self.embed_norm(self.embed(feats))
            olens = feat_lengths
        else:
            x = self.embed(feats)
            olens = Conv2dSubsampling.out_length(feat_lengths,
                                                 self.subsampling_factor)
        t = x.shape[1]
        x = x * math.sqrt(self.d_model)
        pos_emb = rel_positional_embedding(t, self.d_model, x.dtype, x.device)
        pad = length_mask(olens, t)
        bias = None  # the kernel path masks padding and chunks itself
        if not self.use_flash:
            att_mask = pad[:, None, None, :]
            if self.chunk_size > 0:
                att_mask = att_mask & chunk_mask(
                    t, self.chunk_size, self.left_chunks, x.device)[None, None]
            if self.attention_window > 0:
                att_mask = att_mask & band_mask(
                    t, self.attention_window, x.device)[None, None]
            bias = attention_bias(att_mask)
        sd_rate = self.stochastic_depth_rate if train else 0.0
        coeff = 1.0 / (1.0 - sd_rate) if sd_rate > 0.0 else 1.0
        remat = self.remat and torch.is_grad_enabled()
        taps = []
        moe_aux = torch.zeros((), device=x.device)
        for i in range(self.num_blocks):
            block = getattr(self, f"block_{i}")
            args = (x, pos_emb, bias, pad, olens, train, generator, coeff)
            if remat:
                out = torch.utils.checkpoint.checkpoint(
                    block, *args, use_reentrant=False,
                    context_fn=lambda: _replay_draws(generator))
            else:
                out = block(*args)
            y, aux = out if isinstance(out, tuple) else (out, None)
            if sd_rate > 0.0:
                # Whole-batch layer drop: one draw from the generator (on
                # the device when the generator is there: no sync).
                where = x.device if generator is None else generator.device
                keep = (torch.rand((), generator=generator, device=where)
                        >= sd_rate).to(x.device)
                y = torch.where(keep, y, x)
                if aux is not None:
                    aux = torch.where(keep, aux, torch.zeros_like(aux))
            x = y
            if aux is not None:
                moe_aux = moe_aux + aux
            if (i + 1) in self.interctc_layers:
                if self.self_cond:
                    logits = self.sc_ctc(self.after_norm(x))
                    taps.append((i + 1, logits))
                    x = x + self.sc_cond(torch.softmax(
                        logits.float(), dim=-1).to(x.dtype))
                else:
                    taps.append((i + 1, self.after_norm(x)))
        x = self.after_norm(x)
        x = torch.where(pad[..., None], x, torch.zeros_like(x))
        if self.moe_experts > 0:
            taps.append(("moe_aux", moe_aux))
        return x, olens, taps
