"""KA2G end-to-end model: speech encoder + CTC transcript loss + slot-value
generator with ontology-forest TCPGen.

Port of espnet_slurp_tpu/slu/ka2g.py: ``KA2GConfig`` and ``KA2GModel``
(``encode``, ``forward``, ``generate``). Parity target of the reference:
the fork's espnet/nets/pytorch_backend/e2e_asr.py:364-582 composite loss,
ctc_weight x CTC(transcript) + slot_factor x SLU, with the SLU term the
slot classification and ontology-constrained value generation of
slu/generator.py. One encoder pass feeds both the CTC term and the slot
generator.

Kernels: the encoder's Conformer blocks run K3 (rel-pos attention; the
recipe's 144-wide, 4-head encoder has Dh 36, which the K3 wrapper runs
zero-padded at Dh 64) and K2 where its widths allow (the recipe's D2 144
is not a K2 width: eager FFNs); the CTC term goes through the ASR model's
``_ctc_loss_mean``, K4 then K1. The generator is plain tensor ops.

The ASR model is built whole (its attention decoder included), but the
KA2G loss never calls the decoder, so the reference's tree has no
``asr/decoder`` parameters: utils/params.py:ka2g_state_dict leaves the
port's decoder at its initial values and says so.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..models.asr_model import ASRConfig, ASRModel
from ..ops.masks import length_mask
from ..utils.device import resolve_device
from .generator import SlotGenConfig, SlotGenerator


@dataclasses.dataclass(frozen=True)
class KA2GConfig:
    asr: ASRConfig = ASRConfig()
    gen: SlotGenConfig = SlotGenConfig()
    # composite loss: ctc_weight * CTC(transcript) + slot_factor * SLU
    slot_factor: float = 1.0


class KA2GModel(nn.Module):
    """Built on ``device`` (the card unless ``device="cpu"``) with fp32
    parameters; the encoder computes in ``cfg.asr.dtype``, the generator in
    ``cfg.gen.dtype``."""

    def __init__(self, cfg: KA2GConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.asr = ASRModel(cfg.asr, device=dev)
        self.slotgen = SlotGenerator(cfg.gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.asr.device

    def encode(self, speech, speech_lengths, *, train: bool = False,
               generator: Optional[torch.Generator] = None, mvn_stats=None):
        """-> (hs [B, T', D], h_lengths [B], mask [B, T'])."""
        hs, h_lengths = self.asr.encode(speech, speech_lengths, mvn_stats,
                                        train=train, generator=generator)
        return hs, h_lengths, length_mask(h_lengths, hs.shape[1])

    def forward(self, speech, speech_lengths, text, text_lengths,
                slot_present, values, value_lengths, *, trie_token=None,
                trie_children_tok=None, trie_children_node=None,
                trie_n_children=None, node=None, p_gen_mask=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None, mvn_stats=None):
        """(loss, stats). text: transcript tokens (the CTC target); the slot
        streams as SlotGenerator.forward's; trie_*: the ontology forest,
        node / p_gen_mask: the host's walk_forest of the values [B,
        n_slots * L]. ``generator`` draws SpecAug's masks and the encoder's
        dropout when ``train``."""
        c = self.cfg
        hs, h_lengths, mask = self.encode(speech, speech_lengths,
                                          train=train, generator=generator,
                                          mvn_stats=mvn_stats)
        loss_ctc = self.asr._ctc_loss_mean(hs, h_lengths, text, text_lengths)
        trie = None
        if trie_token is not None:
            trie = {"trie_token": trie_token,
                    "trie_children_tok": trie_children_tok,
                    "trie_children_node": trie_children_node,
                    "trie_n_children": trie_n_children}
        loss_slu, stats = self.slotgen(hs, mask, slot_present, values,
                                       value_lengths, trie=trie, node=node,
                                       p_gen_mask=p_gen_mask)
        loss = c.asr.ctc_weight * loss_ctc + c.slot_factor * loss_slu
        stats = dict(stats)
        stats["loss_ctc"] = loss_ctc
        stats["loss"] = loss
        # acc drives the n-best selection as in the ASR configs
        stats["acc"] = stats["slot_acc"]
        return loss, stats

    @torch.no_grad()
    def generate(self, speech, speech_lengths, *, trie=None, roots=None,
                 boundary_mask=None, dead=None, mvn_stats=None):
        """Greedy slot classification + value generation: (slot_logits [B,
        n_slots], values [B, n_slots, max_value_len])."""
        hs, _, mask = self.encode(speech, speech_lengths,
                                  mvn_stats=mvn_stats)
        return self.slotgen.generate(hs, mask, trie=trie, roots=roots,
                                     boundary_mask=boundary_mask, dead=dead)
