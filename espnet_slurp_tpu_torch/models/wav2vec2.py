"""wav2vec 2.0: the raw-waveform SSL encoder and its contrastive pretraining.

Port of espnet_slurp_tpu/models/wav2vec2.py: ``Wav2Vec2Config``,
``conv_out_lengths``, ``ConvFeatureExtractor`` (the 1-D conv stack, the
first conv group-normed over the whole padded length with flax's epsilon
1e-6, exact GELU throughout), ``Wav2Vec2Encoder`` (``extract``,
``contextualize``, ``forward``, ``layer_states``: the projected latents,
the weight-folded grouped positional conv with the even kernel's trailing
frame trimmed and no mask, then post-LN blocks of the eager abs-pos
models/attention.py:MultiHeadAttention and a GELU FFN, the output and the
[B, T, L+1, D] layer stack zeroed past the lengths), ``span_mask``,
``GumbelQuantizer``, ``Wav2Vec2PretrainModel`` and
``wav2vec2_params_from_torch`` (an HF ``Wav2Vec2Model`` state dict, or a
``.pt`` path, -> this encoder's state_dict, without ``transformers``).

No layer here has a kernel, as none in the reference has a Pallas call.
The reference draws the span starts, the Gumbel noise and the distractors
from ``jax.random``; here ``Wav2Vec2PretrainModel.forward`` takes them as
tensors (``starts``, ``gumbel_u``, ``neg_idx``) or draws each one it is
not given from ``generator`` (the train step's), or from a generator
seeded 0 on the model's device when it has none.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import attention_bias, length_mask
from ..utils.device import resolve_device
from .attention import MultiHeadAttention
from .layers import Conv1d, LayerNorm, Linear

# flax's nn.GroupNorm epsilon (the reference's first conv norm; HF's
# nn.GroupNorm uses 1e-5).
GN_EPS = 1e-6
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    d_model: int = 768
    n_head: int = 12
    d_ff: int = 3072
    num_blocks: int = 12
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    dropout_rate: float = 0.1
    # pretraining
    mask_prob: float = 0.065
    mask_span: int = 10
    n_negatives: int = 100
    quantizer_groups: int = 2
    quantizer_entries: int = 320
    vq_dim: int = 256
    final_dim: int = 256
    gumbel_temp: float = 2.0
    logit_temp: float = 0.1
    diversity_weight: float = 0.1
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


def conv_out_lengths(lengths: torch.Tensor, kernels, strides) -> torch.Tensor:
    """Sample lengths -> frame lengths through VALID convs (floor division,
    clamped at 0)."""
    for k, s in zip(kernels, strides):
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths.clamp_min(0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class ConvFeatureExtractor(nn.Module):
    """Raw wav [B, N] -> latents [B, T, conv_dim[-1]]: VALID bias-free
    convs, the first one group-normed (a group a channel), GELU after
    each."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (d, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                          cfg.conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(c_in, d, k, stride=s,
                                                bias=False))
            c_in = d
        self.gn = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0], eps=GN_EPS)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :].to(self.cfg.torch_dtype)
        for i in range(len(self.cfg.conv_dim)):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                # over each channel's whole (padded) length, in fp32
                x = F.group_norm(x.float(), self.gn.num_groups,
                                 self.gn.weight.float(), self.gn.bias.float(),
                                 GN_EPS).to(x.dtype)
            x = gelu(x)
        return x.transpose(1, 2)


class Wav2Vec2Encoder(nn.Module):
    """Feature extractor + projection + conv-pos post-LN Transformer.
    ``forward(speech, speech_lengths, train, generator)`` -> (hs [B, T,
    D], lengths, ()), the ASR encoders' interface; attention probabilities
    drop at ``dropout_rate`` when ``train``. Parameters fp32, computing in
    ``cfg.dtype``."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        c = self.cfg = cfg
        self.num_blocks = c.num_blocks
        self.feature_extractor = ConvFeatureExtractor(c)
        self.fp_norm = LayerNorm(c.conv_dim[-1], eps=LN_EPS)
        self.fp_proj = Linear(c.conv_dim[-1], c.d_model)
        self.pos_conv = Conv1d(c.d_model, c.d_model, c.pos_conv_kernel,
                               padding=c.pos_conv_kernel // 2,
                               groups=c.pos_conv_groups)
        self.enc_norm = LayerNorm(c.d_model, eps=LN_EPS)
        for i in range(c.num_blocks):
            self.add_module(f"attn_{i}", MultiHeadAttention(
                c.n_head, c.d_model, c.dropout_rate))
            self.add_module(f"norm1_{i}", LayerNorm(c.d_model, eps=LN_EPS))
            self.add_module(f"ff1_{i}", Linear(c.d_model, c.d_ff))
            self.add_module(f"ff2_{i}", Linear(c.d_ff, c.d_model))
            self.add_module(f"norm2_{i}", LayerNorm(c.d_model, eps=LN_EPS))

    def extract(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        """-> (raw latents z [B, T, C], projected x [B, T, D], frame
        lengths [B])."""
        c = self.cfg
        z = self.feature_extractor(speech)
        lens = conv_out_lengths(speech_lengths.to(z.device), c.conv_kernel,
                                c.conv_stride)
        return z, self.fp_proj(self.fp_norm(z)), lens

    def contextualize(self, x: torch.Tensor, lengths: torch.Tensor,
                      train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      collect_layers: bool = False):
        """Projected latents -> states [B, T, D] zeroed past ``lengths``;
        with ``collect_layers`` also the block inputs and the output
        stacked as [B, T, num_blocks + 1, D], zeroed likewise."""
        t = x.shape[1]
        pos = self.pos_conv(x.transpose(1, 2))[:, :, :t].transpose(1, 2)
        x = self.enc_norm(x + gelu(pos))
        mask = length_mask(lengths, t)
        bias = attention_bias(mask[:, None, None, :])
        layers = [x]
        for i in range(self.num_blocks):
            h = getattr(self, f"attn_{i}")(x, x, x, bias, train, generator)
            x = getattr(self, f"norm1_{i}")(x + h)
            h = getattr(self, f"ff2_{i}")(gelu(getattr(self, f"ff1_{i}")(x)))
            x = getattr(self, f"norm2_{i}")(x + h)
            layers.append(x)
        out = torch.where(mask[..., None], x, torch.zeros_like(x))
        if not collect_layers:
            return out
        stacked = torch.stack(layers, dim=2)
        return out, torch.where(mask[..., None, None], stacked,
                                torch.zeros_like(stacked))

    def forward(self, speech, speech_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None):
        _, x, lens = self.extract(speech, speech_lengths)
        return self.contextualize(x, lens, train, generator), lens, ()

    def layer_states(self, speech: torch.Tensor,
                     speech_lengths: torch.Tensor):
        """Raw waveform -> ([B, T, num_blocks + 1, D] every layer's
        states, [B] lengths): what bin/ssl_dump.py writes."""
        _, x, lens = self.extract(speech, speech_lengths)
        return self.contextualize(x, lens, collect_layers=True)[1], lens


def span_mask(starts: torch.Tensor, lengths: torch.Tensor,
              mask_span: int) -> torch.Tensor:
    """[B, T] bool span starts -> [B, T] bool mask: frame i is masked when
    a start lies in [i - mask_span // 2, i + (mask_span - 1) // 2]
    (``jnp.convolve(starts, ones(mask_span), "same") > 0``: a start covers
    (mask_span - 1) // 2 frames before it and mask_span // 2 after it, 4
    and 5 for the even span 10), within ``lengths``."""
    lo, hi = mask_span // 2, (mask_span - 1) // 2
    s = F.pad(starts.float()[:, None, :], (lo, hi))
    spans = F.max_pool1d(s, mask_span, stride=1)[:, 0] > 0
    return spans & length_mask(lengths.to(starts.device), starts.shape[1])


def draw_span_starts(b: int, t: int, mask_prob: float,
                     generator: torch.Generator, device) -> torch.Tensor:
    """[B, T] bool: a uniform draw below ``mask_prob``."""
    return torch.rand(b, t, generator=generator,
                      device=generator.device).to(device) < mask_prob


def mask_generator(generator: Optional[torch.Generator], device
                   ) -> torch.Generator:
    """``generator``, or without one a generator seeded 0 on ``device``
    (the reference's PRNGKey(0) when no mask key is given)."""
    return generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)


class GumbelQuantizer(nn.Module):
    """Product-codebook Gumbel-softmax quantizer (G groups x V entries),
    in fp32."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        g, v = cfg.quantizer_groups, cfg.quantizer_entries
        self.proj = Linear(cfg.conv_dim[-1], g * v)
        self.codebook = nn.Parameter(torch.zeros(g, v, cfg.vq_dim // g))
        self.out = Linear(cfg.vq_dim, cfg.final_dim)

    def forward(self, z: torch.Tensor, u: torch.Tensor, hard: bool = True):
        """z [B, T, C], u [B, T, G, V] uniform in [1e-6, 1 - 1e-6] (the
        Gumbel noise's draw) -> (q [B, T, final_dim], mean soft
        probabilities [G, V] over every frame)."""
        c = self.cfg
        g, v = c.quantizer_groups, c.quantizer_entries
        logits = self.proj(z.float()).reshape(*z.shape[:2], g, v)
        gumbel = -torch.log(-torch.log(u.float()))
        y_soft = torch.softmax((logits + gumbel) / c.gumbel_temp, dim=-1)
        if hard:
            y_hard = F.one_hot(y_soft.argmax(-1), v).to(y_soft.dtype)
            y = y_hard + y_soft - y_soft.detach()
        else:
            y = y_soft
        q = torch.einsum("btgv,gvd->btgd", y, self.codebook.float())
        q = q.reshape(*z.shape[:2], c.vq_dim)
        probs = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
        return self.out(q), probs

    def draw_noise(self, z: torch.Tensor, generator: torch.Generator):
        c = self.cfg
        shape = (*z.shape[:2], c.quantizer_groups, c.quantizer_entries)
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u * (1.0 - 2e-6) + 1e-6).to(z.device)


def _cosine_normalise(a: torch.Tensor) -> torch.Tensor:
    # sqrt(sum^2 + eps): a finite gradient at zero (padded frames)
    return a * torch.rsqrt((a ** 2).sum(-1, keepdim=True) + 1e-8)


class Wav2Vec2PretrainModel(nn.Module):
    """Contrastive pretraining (the wav2vec 2.0 objective) on ``device``
    (the card unless ``device="cpu"``): span-masked projected latents
    through the encoder, targets quantized from the unmasked latents, K
    distractors per frame from the utterance's masked frames, plus the
    codebook diversity term."""

    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Wav2Vec2Encoder(cfg)
        self.quantizer = GumbelQuantizer(cfg)
        self.final_proj = Linear(cfg.d_model, cfg.final_dim)
        self.mask_emb = nn.Parameter(torch.zeros(cfg.d_model))
        self.to(device=resolve_device(device))

    def forward(self, speech, speech_lengths, *, train: bool = True,
                generator: Optional[torch.Generator] = None, mvn_stats=None,
                starts: Optional[torch.Tensor] = None,
                gumbel_u: Optional[torch.Tensor] = None,
                neg_idx: Optional[torch.Tensor] = None):
        """-> (loss, stats: loss, contrastive_loss, diversity_loss,
        acc_masked, mask_ratio). ``starts`` [B, T] bool span starts,
        ``gumbel_u`` [B, T, G, V] the quantizer's uniform draw and
        ``neg_idx`` [B, T, K] the distractor frames (before the shift of
        collisions with the positive) replace the draws; ``mvn_stats`` is
        ignored (no frontend)."""
        c = self.cfg
        dev = self.mask_emb.device
        speech, speech_lengths = speech.to(dev), speech_lengths.to(dev)
        gen = mask_generator(generator, dev)
        z, x, lens = self.encoder.extract(speech, speech_lengths)
        b, t, _ = x.shape
        if starts is None:
            starts = draw_span_starts(b, t, c.mask_prob, gen, dev)
        masked = span_mask(starts.to(dev), lens, c.mask_span)
        x = torch.where(masked[..., None], self.mask_emb.to(x.dtype), x)
        hs = self.encoder.contextualize(x, lens, train, generator)
        ct = self.final_proj(hs.float())
        if gumbel_u is None:
            gumbel_u = self.quantizer.draw_noise(z, gen)
        q, probs = self.quantizer(z, gumbel_u.to(dev))
        k = c.n_negatives
        if neg_idx is None:
            # uniform over the utterance's masked frames (over all of its
            # frames when none is masked, as the reference's categorical)
            w = masked.float()
            w = torch.where(w.sum(-1, keepdim=True) > 0, w,
                            torch.ones_like(w))
            neg_idx = torch.multinomial(
                w.to(gen.device), t * k, replacement=True,
                generator=gen).to(dev).reshape(b, t, k)
        neg_idx = neg_idx.to(dev).long()
        frames = torch.arange(t, device=dev)[None, :, None]
        neg_idx = torch.where(neg_idx == frames, (neg_idx + 1) % t, neg_idx)
        rows = neg_idx + torch.arange(b, device=dev)[:, None, None] * t
        negs = q.reshape(b * t, -1)[rows.reshape(-1)].reshape(b, t, k, -1)
        cand = torch.cat([q[:, :, None], negs], dim=2)
        sim = torch.einsum("btf,btkf->btk", _cosine_normalise(ct),
                           _cosine_normalise(cand)) / c.logit_temp
        nll = -torch.log_softmax(sim, dim=-1)[..., 0]
        denom = masked.sum().clamp_min(1)
        zero = torch.zeros_like(nll)
        contrastive = torch.where(masked, nll, zero).sum() / denom
        g, v = c.quantizer_groups, c.quantizer_entries
        entropy = -(probs * torch.log(probs + 1e-8)).sum(-1)
        diversity = (g * v - torch.exp(entropy).sum()) / (g * v)
        loss = contrastive + c.diversity_weight * diversity
        acc = ((sim.argmax(-1) == 0) & masked).sum() / denom
        stats: Dict[str, torch.Tensor] = {
            "loss": loss, "contrastive_loss": contrastive,
            "diversity_loss": diversity, "acc_masked": acc,
            "mask_ratio": masked.float().mean()}
        return loss, stats


# ---------------------------------------------------------------------------
# HF transformers weight import (Wav2Vec2Model, feat_extract_norm="group")
# ---------------------------------------------------------------------------

_POS = "encoder.pos_conv_embed.conv."


def _fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g v / ||v||, the norm over axes (0, 1) of v [out, in/groups, k]
    (HF's weight_norm over dim 2), as the reference folds it."""
    norm = (v ** 2).sum(dim=(0, 1), keepdim=True).sqrt() + 1e-12
    if g.ndim != 3:
        g = g.reshape(1, 1, -1)
    return g / norm * v


def wav2vec2_params_from_torch(
        state_dict: Union[Mapping[str, torch.Tensor], str, Path],
        cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2Model`` state dict (tensors, or a ``.pt`` file of
    one) -> this Wav2Vec2Encoder's state_dict (fp32). The weight-normed
    positional conv is folded into a plain weight, from either key layout:
    ``weight_g`` / ``weight_v`` or torch >= 2.1's
    ``parametrizations.weight.original0`` / ``original1``."""
    if isinstance(state_dict, (str, Path)):
        state_dict = torch.load(state_dict, map_location="cpu",
                                weights_only=True)
    sd = {k: torch.as_tensor(v).detach().float().cpu()
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_dim)):
        out[f"feature_extractor.conv_{i}.weight"] = sd[
            f"feature_extractor.conv_layers.{i}.conv.weight"]
    ln0 = "feature_extractor.conv_layers.0.layer_norm."
    out["feature_extractor.gn.weight"] = sd[ln0 + "weight"]
    out["feature_extractor.gn.bias"] = sd[ln0 + "bias"]

    def copy(dst: str, src: str):
        out[dst + ".weight"] = sd[src + ".weight"]
        out[dst + ".bias"] = sd[src + ".bias"]

    copy("fp_norm", "feature_projection.layer_norm")
    copy("fp_proj", "feature_projection.projection")
    if _POS + "weight_g" in sd:
        g, v = sd[_POS + "weight_g"], sd[_POS + "weight_v"]
    else:
        g = sd[_POS + "parametrizations.weight.original0"]
        v = sd[_POS + "parametrizations.weight.original1"]
    out["pos_conv.weight"] = _fold_weight_norm(g, v)
    out["pos_conv.bias"] = sd[_POS + "bias"]
    copy("enc_norm", "encoder.layer_norm")
    for i in range(cfg.num_blocks):
        base = f"encoder.layers.{i}"
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("out", "out_proj")):
            copy(f"attn_{i}.linear_{ours}", f"{base}.attention.{theirs}")
        copy(f"norm1_{i}", f"{base}.layer_norm")
        copy(f"ff1_{i}", f"{base}.feed_forward.intermediate_dense")
        copy(f"ff2_{i}", f"{base}.feed_forward.output_dense")
        copy(f"norm2_{i}", f"{base}.final_layer_norm")
    return out
