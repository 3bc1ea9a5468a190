"""MaskCTC: non-autoregressive mask-predict ASR. Port of
espnet_slurp_tpu/models/maskctc.py.

An ASR model (the ``asr`` child: encoder, CTC head, decoder) whose decoder
is trained as a conditional masked LM: the CTC branch's loss from its
logits (ops/ctc.py:ctc_loss_mean_logits, lattice K1 both ways) plus the
decoder's NLL, run bidirectionally (``causal=False``), on the masked
positions of the targets. Inference is CTC greedy, then mask-predict
refinement of the low-confidence tokens.

The reference draws the target mask from ``jax.random.uniform(mask_rng,
(B, U))``; here ``forward`` takes the mask as an argument (``mask``) or
draws it from ``generator`` (the train step's) when training, and from a
generator seeded 0 on the model's device otherwise. The mask id is
vocab_size - 1, shared with sos / eos (the reference's <mask> appended
last).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.ctc import ctc_loss_mean_logits
from ..ops.masks import length_mask
from ..utils.device import resolve_device
from .asr_model import ASRConfig, ASRModel


class MaskCTCModel(nn.Module):
    """ASR encoder + CTC + conditional MLM decoder, on ``device`` (the
    card unless ``device="cpu"``)."""

    def __init__(self, cfg: ASRConfig, device=None):
        super().__init__()
        if cfg.moe_experts > 0:
            # The Switch load-balance loss is wired into ASRModel's loss
            # only; dropping it would collapse the router onto one expert.
            raise NotImplementedError(
                "moe_experts > 0 is only supported by the plain ASR model")
        self.cfg = cfg
        self.asr = ASRModel(cfg, device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.asr.device

    @property
    def mask_id(self) -> int:
        return self.cfg.vocab_size - 1

    def draw_mask(self, text_lengths: torch.Tensor, u: int,
                  generator: Optional[torch.Generator] = None,
                  mask_ratio: float = 0.3) -> torch.Tensor:
        """[B, U] bool: valid positions whose uniform draw falls below
        ``mask_ratio``, drawn from ``generator`` (by default one seeded 0
        on the model's device)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        b = text_lengths.shape[0]
        rand = torch.rand((b, u), generator=generator,
                          device=generator.device).to(self.device)
        return (rand < mask_ratio) & length_mask(
            text_lengths.to(self.device), u)

    def forward(self, speech, speech_lengths, text, text_lengths, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                mvn_stats=None, mask: Optional[torch.Tensor] = None,
                mask_ratio: float = 0.3):
        """-> (loss, stats with loss_ctc, loss_mlm, acc_mlm, loss): loss =
        ctc_weight * CTC + (1 - ctc_weight) * the masked NLL. ``mask``
        ([B, U] bool) picks the masked targets (on valid positions only);
        without it they are drawn (``draw_mask``) from ``generator`` when
        ``train``. ``generator`` also draws SpecAug and dropout, as
        ASRModel's."""
        c = self.cfg
        hs, h_lengths = self.asr.encode(speech, speech_lengths, mvn_stats,
                                        train=train, generator=generator)
        text_lengths = text_lengths.to(hs.device)
        labels = text.clamp_min(0).long()
        stats: Dict[str, torch.Tensor] = {}
        loss_ctc = ctc_loss_mean_logits(self.asr.ctc_proj(hs), h_lengths,
                                        labels, text_lengths, c.blank_id)
        stats["loss_ctc"] = loss_ctc
        b, u = labels.shape
        valid = length_mask(text_lengths, u)
        if mask is None:
            mask = self.draw_mask(text_lengths, u,
                                  generator if train else None, mask_ratio)
        masked = mask.to(hs.device).bool() & valid
        ys_in = torch.where(masked, self.mask_id, labels)
        logits = self.asr.decoder(ys_in, text_lengths, hs, h_lengths,
                                  causal=False)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels[..., None])[..., 0]
        denom = masked.sum().clamp_min(1)
        loss_mlm = torch.where(masked, nll, torch.zeros_like(nll)).sum() \
            / denom
        stats["loss_mlm"] = loss_mlm
        stats["acc_mlm"] = ((logits.argmax(-1) == labels) & masked).sum() \
            / denom
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_mlm
        stats["loss"] = loss
        return loss, stats

    @torch.inference_mode()
    def decode(self, speech, speech_lengths, max_len: int = 128,
               n_iterations: int = 4, threshold: float = 0.99,
               mvn_stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mask-predict inference -> (tokens [B, max_len] blank-padded,
        lengths [B]): CTC greedy (collapsed on the host), the tokens below
        ``threshold`` confidence masked, then ``n_iterations`` passes that
        each reveal about 1 / n_iterations of the first pass's masks (per
        row, the most confident predictions first), and a last pass that
        fills whatever is still masked."""
        c = self.cfg
        hs, h_lengths = self.asr.encode(speech, speech_lengths, mvn_stats)
        lp = self.asr.ctc_logprobs(hs)  # [B, T, V]
        conf, ids = lp.exp().max(dim=-1)
        ids_np, conf_np = ids.cpu().numpy(), conf.cpu().numpy()
        hl = h_lengths.cpu().numpy()
        b = ids_np.shape[0]
        tokens = np.zeros((b, max_len), np.int64)
        confs = np.zeros((b, max_len), np.float32)
        lengths = np.zeros((b,), np.int64)
        for i in range(b):
            prev, out, cf = -1, [], []
            for t in range(hl[i]):
                v = int(ids_np[i, t])
                if v != c.blank_id and v != prev:
                    out.append(v)
                    cf.append(conf_np[i, t])
                prev = v
            out = out[:max_len]
            tokens[i, :len(out)] = out
            confs[i, :len(out)] = cf[:len(out)]
            lengths[i] = len(out)
        dev = hs.device
        tokens = torch.from_numpy(tokens).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        valid = length_mask(lengths_t, max_len)
        to_mask = (torch.from_numpy(confs).to(dev) < threshold) & valid
        ys = torch.where(to_mask, self.mask_id, tokens)
        # Per-row fill budget: each pass reveals ceil(n_mask / K) of the
        # first pass's masks, highest predicted confidence first.
        n_masked0 = to_mask.sum(dim=1)
        for _ in range(n_iterations):
            logits = self.asr.decoder(ys, lengths_t, hs, h_lengths,
                                      causal=False)
            pconf, pred = torch.softmax(logits.float(), dim=-1).max(dim=-1)
            still = (ys == self.mask_id) & valid
            k = torch.minimum((-(-n_masked0 // n_iterations)).clamp_min(1),
                              still.sum(dim=1))
            # the k-th largest confidence over the masked positions (the
            # sentinel -1 is never selected)
            scores = torch.where(still, pconf, torch.full_like(pconf, -1.0))
            kth = scores.sort(dim=1, descending=True).values.gather(
                1, (k - 1).clamp_min(0)[:, None])
            fill = still & (scores >= kth) & (k > 0)[:, None]
            ys = torch.where(fill, pred, ys)
        logits = self.asr.decoder(ys, lengths_t, hs, h_lengths, causal=False)
        ys = torch.where((ys == self.mask_id) & valid, logits.argmax(-1), ys)
        return torch.where(valid, ys, c.blank_id), lengths_t
