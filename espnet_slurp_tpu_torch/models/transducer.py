"""Transducer (RNN-T) model family. Port of
espnet_slurp_tpu/models/transducer.py.

``TransducerConfig``, the prediction network (``lstm`` or ``stateless``),
the joint network, ``TransducerModel`` (Conformer encoder -> prediction
network -> joint -> RNN-T loss through kernel K5, plus the auxiliary CTC
through kernel K1) and the time-synchronous greedy decode. The model's
``forward`` takes the keywords of ``ASRModel.forward``, so
``train/state.py:make_train_step`` drives it unchanged. Parameters are fp32
and every layer computes in ``cfg.asr.dtype``, as the flax modules do; the
LSTM's cell state stays fp32 (flax's ``nn.RNN`` carry). With
``use_tcpgen`` and a biasing batch the loss is the KB-aware transducer's
(reference :168-186): TCPGen, queried by the prediction network, mixes its
pointer into the joint's distribution inside the RNN-T loss, blank's mass
kept, and the mixed log-probs go through K5 as any others.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ctc import ctc_loss_mean_logits
from ..ops.transducer import rnnt_loss_from_logprobs, rnnt_loss_mean
from ..utils import device as device_mod
from ..utils.device import resolve_device
from .asr_model import ASRConfig, build_encoder, encode_speech
from .layers import Linear, LSTMLayer
from .tcpgen import TCPGen

Carry = List[Tuple[torch.Tensor, torch.Tensor]]  # per layer (c, h), fp32


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    asr: ASRConfig = ASRConfig(ctc_weight=0.0)
    prediction: str = "lstm"  # lstm | stateless
    pred_layers: int = 1
    pred_dim: int = 256
    joint_dim: int = 256
    aux_ctc_weight: float = 0.0  # auxiliary CTC on the encoder output
    use_tcpgen: bool = False  # KB-aware transducer (TCPGen in the loss)
    tcpgen_gcn_layers: int = 2


def transducer_flagship_config() -> TransducerConfig:
    """conf/train_transducer.yaml: a 12 x 256 Conformer (4 heads, d_ff 1024,
    kernel 31), a 1 x 256 LSTM prediction network, joint 256, BPE vocab 600,
    auxiliary CTC 0.3, the yaml's dropout 0.1 (:15), bf16 compute."""
    return TransducerConfig(
        asr=ASRConfig(vocab_size=600, d_model=256, n_head=4, d_ff=1024,
                      num_encoder_blocks=12, kernel_size=31,
                      dropout_rate=0.1, ctc_weight=0.0, dtype="bfloat16"),
        prediction="lstm", pred_layers=1, pred_dim=256, joint_dim=256,
        aux_ctc_weight=0.3)


class PredictionNetwork(nn.Module):
    """Label-history encoder: embedding, then ``num_layers`` LSTM layers
    (``lstm``) or nothing (``stateless``)."""

    def __init__(self, vocab_size: int, pred_dim: int, num_layers: int = 1,
                 kind: str = "lstm", dtype: torch.dtype = torch.float32):
        super().__init__()
        if kind not in ("lstm", "stateless"):
            raise ValueError(f"prediction must be lstm|stateless, got {kind!r}")
        self.pred_dim, self.dtype = pred_dim, dtype
        self.embed = nn.Embedding(vocab_size, pred_dim)
        self.num_layers = num_layers if kind == "lstm" else 0
        for i in range(self.num_layers):
            self.add_module(f"rnn_{i}", LSTMLayer(pred_dim, pred_dim))

    def _rnns(self) -> List[LSTMLayer]:
        return [getattr(self, f"rnn_{i}") for i in range(self.num_layers)]

    def forward(self, labels_in: torch.Tensor) -> torch.Tensor:
        """[B, U+1] (blank-prefixed labels) -> [B, U+1, P]."""
        x = self.embed(labels_in).to(self.dtype)
        for rnn in self._rnns():
            x = rnn(x.to(self.dtype))
        return x

    def init_carry(self, batch: int, device) -> Carry:
        z = lambda: torch.zeros(batch, self.pred_dim, device=device)
        return [(z(), z()) for _ in range(self.num_layers)]

    def step(self, y: torch.Tensor, carry: Carry):
        """[B] -> ([B, P], carry), for decoding."""
        x = self.embed(y).to(self.dtype)
        new = []
        for rnn, cr in zip(self._rnns(), carry):
            cr = rnn.cell(rnn.project(x.to(self.dtype)), cr)
            new.append(cr)
            x = cr[1]
        return x, new


class JointNetwork(nn.Module):
    """joint = W_out tanh(W_enc h + W_pred g), in ``dtype``."""

    def __init__(self, vocab_size: int, enc_dim: int, pred_dim: int,
                 joint_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lin_enc = Linear(enc_dim, joint_dim)
        self.lin_pred = Linear(pred_dim, joint_dim)
        self.lin_out = Linear(joint_dim, vocab_size)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """enc [..., D], pred [..., P] broadcastable -> [..., V]."""
        return self.lin_out(torch.tanh(self.lin_enc(enc.to(self.dtype))
                                       + self.lin_pred(pred.to(self.dtype))))

    def full(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """enc [B, T, D], pred [B, U+1, P] -> [B, T, U+1, V]."""
        h = (self.lin_enc(enc.to(self.dtype))[:, :, None, :]
             + self.lin_pred(pred.to(self.dtype))[:, None])
        return self.lin_out(torch.tanh(h))


class TransducerModel(nn.Module):
    """Conformer encoder + prediction network + joint, RNN-T loss; built on
    ``device`` (the card unless ``device="cpu"``) with fp32 parameters."""

    def __init__(self, cfg: TransducerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        a = cfg.asr
        dt = a.torch_dtype
        self.encoder = build_encoder(a)
        self.prediction = PredictionNetwork(a.vocab_size, cfg.pred_dim,
                                            cfg.pred_layers, cfg.prediction,
                                            dtype=dt)
        self.joint = JointNetwork(a.vocab_size, a.d_model, cfg.pred_dim,
                                  cfg.joint_dim, dtype=dt)
        if cfg.aux_ctc_weight > 0:
            self.ctc_proj = Linear(a.d_model, a.vocab_size)
        if cfg.use_tcpgen:
            self.tcpgen = TCPGen(cfg.pred_dim, a.vocab_size,
                                 cfg.tcpgen_gcn_layers, dtype=dt)
        self.to(device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.joint.lin_out.weight.device

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               mvn_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               *, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """Raw waveform [B, N] -> (hs [B, T', D], h_lengths [B]), as
        ASRModel.encode."""
        hs, h_lengths, _ = encode_speech(self.cfg.asr, self.encoder, speech,
                                         speech_lengths, mvn_stats, train,
                                         generator)
        return hs, h_lengths

    def forward(self, speech, speech_lengths, text, text_lengths, *,
                trie_token=None, trie_children_tok=None,
                trie_children_node=None, trie_n_children=None, node=None,
                p_gen_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mvn_stats=None):
        """Training forward -> (loss, stats) with loss_transducer, loss_ctc
        (when aux_ctc_weight > 0) and loss = RNN-T + aux_ctc_weight * CTC.
        ``generator`` draws SpecAug's masks and the encoder's dropout when
        ``train``. The trie_* / node / p_gen_mask keywords (a biasing
        batch, node and mask [B, U+1]) make a ``use_tcpgen`` model's loss
        the KB-aware one: p_final = [p_blank, ptr p_gen (1 - p_blank) +
        p_model (1 - p_gen + p_gen p_ookb)] (the fork's
        transducer/loss.py:26-90)."""
        a = self.cfg.asr
        hs, h_lengths = self.encode(speech, speech_lengths, mvn_stats,
                                    train=train, generator=generator)
        labels = text.clamp_min(0).long()
        text_lengths = text_lengths.to(hs.device)
        g = self.prediction(F.pad(labels, (1, 0), value=a.blank_id))
        logits = self.joint.full(hs, g)  # [B, T', U+1, V]
        if self.cfg.use_tcpgen and trie_token is not None:
            trie = {"trie_token": trie_token,
                    "trie_children_tok": trie_children_tok,
                    "trie_children_node": trie_children_node,
                    "trie_n_children": trie_n_children}
            lp = self._kb_logprobs(logits, g, trie, node, p_gen_mask)
            loss = rnnt_loss_from_logprobs(lp, labels, h_lengths,
                                           text_lengths, a.blank_id).sum() \
                / labels.shape[0]
        else:
            loss = rnnt_loss_mean(logits, labels, h_lengths, text_lengths,
                                  a.blank_id)
        stats = {"loss_transducer": loss}
        if self.cfg.aux_ctc_weight > 0:
            loss_ctc = ctc_loss_mean_logits(self.ctc_proj(hs), h_lengths,
                                            labels, text_lengths, a.blank_id)
            stats["loss_ctc"] = loss_ctc
            loss = loss + self.cfg.aux_ctc_weight * loss_ctc
        stats["loss"] = loss
        return loss, stats

    def _kb_logprobs(self, logits, g, trie, node, p_gen_mask):
        """log p_final [B, T', U+1, V] fp32 of the KB-aware loss: TCPGen
        over the trie queried by the prediction network's output g [B,
        U+1, P]."""
        a = self.cfg.asr
        v, blank = a.vocab_size, a.blank_id
        embs = self.prediction.embed(trie["trie_token"].long())
        tree_encs = self.tcpgen.encode_tree(embs.to(a.torch_dtype), trie)
        ptr, kb = self.tcpgen(g, node, trie, tree_encs)  # [B, U+1, V+1]
        pg = self.tcpgen.gen_prob(g, kb, p_gen_mask)[:, None, :, None]
        p_model = torch.softmax(logits.float(), dim=-1)
        p_blank = p_model[..., blank:blank + 1]
        p_final = (ptr[:, None, :, :v] * pg * (1.0 - p_blank)
                   + p_model * (1.0 - pg + pg * ptr[:, None, :, v:v + 1]))
        # blank keeps the model's mass (in place: no fifth [B, T', U+1, V])
        p_final[..., blank] = p_model[..., blank]
        return torch.log(p_final + 1e-9)


@torch.no_grad()
def transducer_greedy_decode(model: TransducerModel, hs: torch.Tensor,
                             h_lengths: torch.Tensor,
                             max_symbols_per_frame: int = 4,
                             max_len: int = 128):
    """Time-synchronous greedy decode -> (tokens [B, max_len], lengths [B]).

    Per frame, every row emits up to ``max_symbols_per_frame`` non-blank
    labels; the frame advances only when no row emits (the reference's
    while-loop, :202-268). One host sync per iteration (the advance test),
    counted in utils/device.py:host_syncs."""
    blank = model.cfg.asr.blank_id
    b, t_max, _ = hs.shape
    dev = hs.device
    pred = model.prediction
    hl = h_lengths.to(dev)
    rows = torch.arange(b, device=dev)
    g, carry = pred.step(torch.full((b,), blank, dtype=torch.long,
                                    device=dev), pred.init_carry(b, dev))
    tokens = torch.full((b, max_len), blank, dtype=torch.long, device=dev)
    n_emit = torch.zeros(b, dtype=torch.long, device=dev)
    sym = torch.zeros(b, dtype=torch.long, device=dev)
    t = 0
    while t < t_max:
        y = model.joint(hs[:, t], g).argmax(-1)
        emit = ((y != blank) & (t < hl) & (sym < max_symbols_per_frame)
                & (n_emit < max_len))
        g_new, carry_new = pred.step(torch.where(emit, y, blank), carry)
        g = torch.where(emit[:, None], g_new, g)
        carry = [tuple(torch.where(emit[:, None], n, o) for n, o in zip(cn, co))
                 for cn, co in zip(carry_new, carry)]
        slot = n_emit.clamp(max=max_len - 1)
        tokens[rows, slot] = torch.where(emit, y, tokens[rows, slot])
        n_emit += emit.long()
        sym += emit.long()
        if not device_mod.host_bool(emit.any()):
            t += 1
            sym.zero_()
    return tokens, n_emit
