"""HuBERT-style masked-prediction SSL pretraining.

Port of espnet_slurp_tpu/models/hubert.py (``HubertConfig``,
``HubertModel``): frontend features -> utterance MVN -> span masking with a
learned mask embedding (models/wav2vec2.py:span_mask over the feature
frames) -> the Conformer encoder (models/conformer.py; ``flash`` "auto":
its FFNs through kernel K2 and its attention through K3 on the card, their
plain versions on the CPU) -> a cluster classifier, whose cross entropy
against the frame-level k-means ids is taken at masked frames only. The
ids come at the encoder's x4-subsampled rate: an encoder frame is masked
when any of its 4 input frames is, and an id stream shorter than the
encoder output is padded with -1, whose frames fall out of the loss.

The reference draws the span starts from ``jax.random.uniform(mask_rng,
(B, T))``; here ``forward`` takes them (``starts``) or draws them from
``generator`` (the train step's), or from a generator seeded 0 on the
model's device when it has none (the reference's PRNGKey(0)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.frontend import FrontendConfig, default_frontend, feature_dim
from ..ops.masks import length_mask
from ..ops.normalize import utterance_mvn
from ..utils.device import resolve_device
from .conformer import ConformerEncoder
from .layers import Linear
from .wav2vec2 import draw_span_starts, mask_generator, span_mask


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    n_clusters: int = 100
    d_model: int = 256
    n_head: int = 4
    d_ff: int = 1024
    num_blocks: int = 6
    kernel_size: int = 15
    mask_prob: float = 0.08       # per-frame span-start probability
    mask_span: int = 10
    frontend: FrontendConfig = FrontendConfig()
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


class HubertModel(nn.Module):
    """The HuBERT pretraining model on ``device`` (the card unless
    ``device="cpu"``), fp32 parameters computing in ``cfg.dtype``."""

    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        f = feature_dim(c.frontend)
        self.mask_emb = nn.Parameter(torch.zeros(f))
        self.encoder = ConformerEncoder(f, c.d_model, c.n_head, c.d_ff,
                                        c.num_blocks, c.kernel_size)
        self.pred = Linear(c.d_model, c.n_clusters)
        self.to(device=resolve_device(device))

    def forward(self, speech, speech_lengths, cluster_ids, *,
                train: bool = True,
                generator: Optional[torch.Generator] = None, mvn_stats=None,
                starts: Optional[torch.Tensor] = None):
        """speech [B, N], cluster_ids [B, T'] at the encoder's rate (-1
        where there is none) -> (loss, stats: loss, acc_masked,
        mask_ratio). ``starts`` [B, T] bool replaces the span starts'
        draw over the T feature frames; ``mvn_stats`` is ignored (the
        model normalises each utterance)."""
        c = self.cfg
        dev = self.mask_emb.device
        speech, speech_lengths = speech.to(dev), speech_lengths.to(dev)
        feats, flens = default_frontend(speech, speech_lengths, c.frontend)
        feats = utterance_mvn(feats, flens).to(c.torch_dtype)
        b, t, _ = feats.shape
        if starts is None:
            starts = draw_span_starts(b, t, c.mask_prob,
                                      mask_generator(generator, dev), dev)
        masked = span_mask(starts.to(dev), flens, c.mask_span)
        x = torch.where(masked[..., None], self.mask_emb.to(feats.dtype),
                        feats)
        hs, h_lengths, _ = self.encoder(x, flens, train, generator)
        logits = self.pred(hs).float()
        t_enc = hs.shape[1]
        # an encoder frame is masked when any of its x4 input frames is
        m4 = F.pad(masked[:, :t_enc * 4],
                   (0, max(t_enc * 4 - masked.shape[1], 0)))
        masked_enc = m4.reshape(b, t_enc, 4).any(-1)
        ids = cluster_ids.to(dev).long()
        if ids.shape[1] < t_enc:
            ids = F.pad(ids, (0, t_enc - ids.shape[1]), value=-1)
        ids = ids[:, :t_enc]
        tgt = ids.clamp(0, c.n_clusters - 1)
        valid = masked_enc & length_mask(h_lengths, t_enc) & (ids >= 0)
        nll = -torch.log_softmax(logits, -1).gather(-1, tgt[..., None])[..., 0]
        denom = valid.sum().clamp_min(1)
        loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
        acc = ((logits.argmax(-1) == tgt) & valid).sum() / denom
        stats: Dict[str, torch.Tensor] = {
            "loss": loss, "acc_masked": acc,
            "mask_ratio": masked.float().mean()}
        return loss, stats
