"""Hybrid CTC/attention ASR model.

Port of espnet_slurp_tpu/models/asr_model.py: ``ASRConfig`` (with the
reference's fields and defaults) and the field set of ``Wav2Vec2Config``,
``add_sos_eos``, ``label_smoothing_loss`` and ``ASRModel`` with ``encode``
(frontend -> SpecAug when training -> MVN -> Conformer), ``ctc_logprobs``,
``decoder_logits`` and ``forward`` (the training loss: CTC through the
fused head K4 and the lattice K1, plus label-smoothed CE on the decoder).
``ASRConfig`` has every field of the reference's; ``unported_options``
names the values that select a path not ported yet.
Parameters are fp32 and every layer computes in ``cfg.dtype``, as the flax
modules do (models/layers.py). The TCPGen, interCTC and MoE branches of the
reference's loss raise where the model is built.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.frontend import FrontendConfig, default_frontend
from ..ops.kernels.ctc_head import ctc_loss_pallas_head
from ..ops.masks import length_mask
from ..ops.normalize import global_mvn, utterance_mvn
from ..ops.specaug import SpecAugConfig, specaug
from ..utils.config import PORT_ONLY
from ..utils.device import resolve_device
from .conformer import ConformerEncoder
from .layers import Linear
from .transformer import TransformerDecoder

IGNORE_ID = -1


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The fields of the reference's models/wav2vec2.py:Wav2Vec2Config, so
    that a config naming them loads. The wav2vec2 encoder is not ported yet
    (ROADMAP.md queue 1 item 15): ``encoder: wav2vec2`` raises."""
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


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Every field of the reference's ASRConfig, under its name, type and
    default, plus the port-only ``fused_conv``. Values that select a path
    not ported yet raise in ``build_encoder`` (``unported_options``)."""
    vocab_size: int = 5000
    # conformer | ebranchformer | transformer | longformer |
    # contextual_block_conformer | rnn | vgg_rnn | wav2vec2: the port
    # builds the conformer.
    encoder: str = "conformer"
    # Precomputed-feature input (feature dumps): not ported yet.
    input_feats: bool = False
    input_feats_dim: int = 0
    ssl_num_layers: int = 0
    # Geometry of the longformer and contextual-block encoders.
    attention_window: int = 64
    block_size: int = 40
    hop_size: int = 16
    look_ahead: int = 16
    # transformer | rnn | lightweight_conv | lightweight_conv2d |
    # dynamic_conv | dynamic_conv2d: the port builds the transformer.
    decoder: str = "transformer"
    decoder_conv_wshare: int = 4
    decoder_conv_kernel: int = 11
    decoder_conv_usebias: bool = False
    rnn_decoder_units: int = 320
    rnn_decoder_layers: int = 1
    rnn_encoder_units: int = 320
    rnn_encoder_layers: int = 4
    rnn_encoder_subsample: Tuple[int, ...] = (1, 2, 2, 1)
    d_model: int = 256
    n_head: int = 4
    d_ff: int = 2048
    num_encoder_blocks: int = 12
    num_decoder_blocks: int = 6
    decoder_d_ff: int = 2048
    kernel_size: int = 31
    dropout_rate: float = 0.1
    ctc_weight: float = 0.3
    interctc_weight: float = 0.0
    interctc_layers: Tuple[int, ...] = ()
    self_conditioning: bool = False
    # "conv2d" (x subsampling_factor) | "linear": the port builds conv2d.
    input_layer: str = "conv2d"
    subsampling_factor: int = 4
    stochastic_depth_rate: float = 0.0
    lsm_weight: float = 0.1
    blank_id: int = 0
    sos: int = -1  # -1 => vocab_size - 1
    eos: int = -1
    use_mvn: str = "utterance"  # "global" | "utterance" | "none"
    chunk_size: int = 0  # > 0: streaming chunk attention (frames after x4)
    left_chunks: int = -1
    remat_encoder: bool = False
    flash_attention: str = "auto"  # "auto"/"on": kernels K2/K3; "off": eager
    # Conv modules through kernel K6 (kernel path only): the port's form of
    # the reference's ESPNET_TPU_FUSED_CONV=1, off by default as there.
    fused_conv: bool = dataclasses.field(default=False, metadata=PORT_ONLY)
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    num_ref: int = 1
    pit_branch_blocks: int = 2
    wav2vec2: Optional[Wav2Vec2Config] = None
    preencoder: str = ""
    preencoder_dim: int = 256
    preencoder_scale: str = "mel"
    use_beamformer: bool = False
    use_wpe: bool = False
    ref_channel: int = 0
    bf_hidden: int = 128
    bf_layers: int = 2
    wpe_taps: int = 5
    wpe_delay: int = 3
    wpe_iters: int = 3
    postencoder: str = ""
    postencoder_hf_dir: Optional[str] = None
    postencoder_layers: int = 2
    postencoder_hidden: int = 256
    postencoder_heads: int = 4
    postencoder_ff: int = 1024
    postencoder_length_adaptor: int = 0
    use_tcpgen: bool = False
    tcpgen_gcn_layers: int = 2
    tcpgen_tree_encoder: str = "gcn"
    tcpgen_smoothprob: float = 1.0
    tcpgen_ptr_loss_weight: float = 0.0
    tcpgen_gate_loss_weight: float = 0.0
    frontend: FrontendConfig = FrontendConfig()
    specaug: Optional[SpecAugConfig] = SpecAugConfig()
    dtype: str = "float32"  # compute dtype: float32 | bfloat16

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1 if self.sos < 0 else self.sos

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1 if self.eos < 0 else self.eos


def flagship_config() -> ASRConfig:
    """The flagship LS-100 Conformer (__graft_entry__.py:25-27): vocab 5000,
    12 x 256 encoder, 4 heads, d_ff 1024, kernel 31, 6-block decoder with
    d_ff 2048, dropout 0, bf16."""
    return ASRConfig(vocab_size=5000, d_model=256, n_head=4, d_ff=1024,
                     num_encoder_blocks=12, num_decoder_blocks=6,
                     decoder_d_ff=2048, kernel_size=31, dropout_rate=0.0,
                     dtype="bfloat16")


def unported_options(cfg: ASRConfig) -> List[str]:
    """The values of ``cfg`` that select a path not ported yet, each naming
    its ROADMAP.md queue 1 item; empty when the port builds ``cfg``."""
    todo = []
    if cfg.encoder != "conformer":
        todo.append(f"encoder {cfg.encoder!r} (the encoder choice: queue 1 "
                    "items 9 and 15)")
    if cfg.decoder != "transformer":
        todo.append(f"decoder {cfg.decoder!r} (rnn / lightconv decoders: "
                    "queue 1 items 9 and 15)")
    if cfg.preencoder or cfg.postencoder:
        todo.append("preencoder / postencoder (queue 1 items 9 and 15)")
    if cfg.wav2vec2 is not None:
        todo.append("wav2vec2 (the SSL encoder: queue 1 items 9 and 15)")
    if cfg.input_layer != "conv2d" or cfg.subsampling_factor not in (
            2, 4, 6, 8):
        todo.append(f"input_layer {cfg.input_layer!r} x "
                    f"{cfg.subsampling_factor} (queue 1 items 9 and 15)")
    if cfg.input_feats or cfg.ssl_num_layers > 0:
        todo.append("input_feats (feature dumps: queue 1 items 9 and 15)")
    if cfg.interctc_layers or cfg.interctc_weight > 0 \
            or cfg.self_conditioning:
        todo.append("interctc_layers / self_conditioning (interCTC: queue 1 "
                    "item 9)")
    if cfg.moe_experts > 0:
        todo.append("moe_experts > 0 (MoE: queue 1 item 9)")
    if cfg.stochastic_depth_rate > 0:
        todo.append("stochastic_depth_rate > 0 (queue 1 item 9)")
    if cfg.remat_encoder:
        todo.append("remat_encoder (queue 1 item 9)")
    if cfg.use_tcpgen:
        todo.append("use_tcpgen (TCPGen: queue 1 item 10)")
    if cfg.use_wpe or cfg.use_beamformer:
        todo.append("use_wpe / use_beamformer (the multichannel frontends: "
                    "queue 1 items 15 and 16)")
    if cfg.num_ref > 1:
        todo.append("num_ref > 1 (PIT: queue 1 items 15 and 16)")
    if cfg.frontend.type != "default":
        todo.append(f"frontend.type {cfg.frontend.type!r} (queue 1 item 9)")
    if cfg.frontend.delta_order > 0:
        todo.append("frontend.delta_order > 0 (delta features: queue 1 "
                    "item 9)")
    return todo


def build_encoder(cfg: ASRConfig) -> ConformerEncoder:
    """The Conformer encoder of ``cfg`` (fp32 parameters); raises for a
    value of ``cfg`` that selects a path not ported yet."""
    todo = unported_options(cfg)
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    return ConformerEncoder(
        cfg.frontend.n_mels, cfg.d_model, cfg.n_head, cfg.d_ff,
        cfg.num_encoder_blocks, cfg.kernel_size, chunk_size=cfg.chunk_size,
        left_chunks=cfg.left_chunks, flash=cfg.flash_attention,
        subsampling_factor=cfg.subsampling_factor, fused_conv=cfg.fused_conv,
        dropout_rate=cfg.dropout_rate)


def encode_speech(cfg: ASRConfig, encoder: ConformerEncoder,
                  speech: torch.Tensor, speech_lengths: torch.Tensor,
                  mvn_stats=None, train: bool = False,
                  generator: Optional[torch.Generator] = None):
    """Frontend -> SpecAug (when ``train`` with ``cfg.specaug`` and a
    ``generator``) -> MVN -> ``encoder`` (with ``train``, dropout at
    ``cfg.dropout_rate`` drawn from ``generator``), in ``cfg.dtype``: the
    encode of every model built on the ASR stack."""
    feats, feat_lengths = default_frontend(speech, speech_lengths,
                                           cfg.frontend)
    if train and cfg.specaug is not None and generator is not None:
        feats = specaug(feats, feat_lengths, cfg.specaug, generator)
    if cfg.use_mvn == "global" and mvn_stats is not None:
        feats = global_mvn(feats, feat_lengths, *mvn_stats)
    elif cfg.use_mvn == "utterance":
        feats = utterance_mvn(feats, feat_lengths)
    return encoder(feats.to(cfg.torch_dtype), feat_lengths, train, generator)


def add_sos_eos(ys: torch.Tensor, ys_lengths: torch.Tensor, sos: int,
                eos: int, ignore_id: int = IGNORE_ID):
    """[B, U] -> (ys_in [B, U+1] with sos prepended and eos as padding,
    ys_out [B, U+1] with eos appended at each row's end and ignore_id as
    padding)."""
    b, u = ys.shape
    valid = length_mask(ys_lengths, u)
    ys_clean = torch.where(valid, ys, torch.zeros_like(ys))
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=ys.dtype,
                                  device=ys.device),
                       torch.where(valid, ys_clean, torch.full_like(ys, eos))],
                      1)
    pos = torch.arange(u + 1, device=ys.device)[None, :]
    ys_out = torch.cat([ys_clean, torch.zeros_like(ys[:, :1])], 1)
    n = ys_lengths.to(ys.device)[:, None]
    ys_out = torch.where(pos < n, ys_out,
                         torch.where(pos == n, torch.full_like(ys_out, eos),
                                     torch.full_like(ys_out, ignore_id)))
    return ys_in, ys_out


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float, ignore_id: int = IGNORE_ID):
    """Label-smoothed CE, mean over valid tokens (the reference's
    token-mean form): (loss, accuracy)."""
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = (1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)
    denom = valid.sum().clamp_min(1)
    loss = torch.where(valid, loss, torch.zeros_like(loss)).sum() / denom
    acc = ((logits.argmax(-1) == tgt) & valid).sum() / denom
    return loss, acc


class ASRModel(nn.Module):
    """Encoder + CTC head + attention decoder, built on ``device`` (the card
    unless ``device="cpu"``) with fp32 parameters, computing in
    ``cfg.dtype``. The frontend runs in fp32."""

    def __init__(self, cfg: ASRConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.encoder = build_encoder(c)
        self.ctc_proj = Linear(c.d_model, c.vocab_size)
        self.decoder = TransformerDecoder(c.vocab_size, c.d_model, c.n_head,
                                          c.decoder_d_ff, c.num_decoder_blocks,
                                          dtype=c.torch_dtype)
        self.to(device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.ctc_proj.weight.device

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               mvn_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               *, train: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw waveform [B, N] -> (hs [B, T', D], h_lengths [B]). With
        ``train``, ``cfg.specaug`` and a ``generator`` the features are
        augmented, and with ``train`` the encoder drops at
        ``cfg.dropout_rate`` (every draw from the generator)."""
        return encode_speech(self.cfg, self.encoder, speech, speech_lengths,
                             mvn_stats, train, generator)

    def ctc_logprobs(self, hs: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ctc_proj(hs).float(), dim=-1)

    def decoder_logits(self, ys_in, ys_in_lengths, hs, h_lengths):
        return self.decoder(ys_in, ys_in_lengths, hs, h_lengths)

    def _ctc_loss_mean(self, hs, h_lengths, text, text_lengths):
        """Batch-mean CTC loss from encoder states through the fused head
        (K4) and the lattice (K1): on the card their kernels, on the CPU
        their plain versions. No [B, T, V] logits are kept."""
        c = self.cfg
        per = ctc_loss_pallas_head(
            hs, self.ctc_proj.weight.to(hs.dtype),
            self.ctc_proj.bias.float(), h_lengths, text.clamp_min(0),
            text_lengths, c.blank_id)
        return per.sum() / per.shape[0]

    def forward(self, speech, speech_lengths, text, text_lengths, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                mvn_stats=None):
        """Training forward -> (loss, stats) with loss_ctc, loss_att, acc,
        loss: ctc_weight * CTC + (1 - ctc_weight) * label-smoothed CE.
        ``generator`` draws SpecAug's masks and the encoder's dropout (its
        kernels' seeds) when ``train``. The decoder takes no dropout, as the
        reference's (ROADMAP.md queue 3)."""
        c = self.cfg
        if c.interctc_weight > 0.0:
            raise NotImplementedError("ASRModel: interCTC is not ported yet")
        hs, h_lengths = self.encode(speech, speech_lengths, mvn_stats,
                                    train=train, generator=generator)
        stats = {}
        loss = torch.zeros((), device=hs.device)
        if c.ctc_weight > 0.0:
            loss_ctc = self._ctc_loss_mean(hs, h_lengths, text, text_lengths)
            stats["loss_ctc"] = loss_ctc
            loss = loss + c.ctc_weight * loss_ctc
        if c.ctc_weight < 1.0:
            text_lengths = text_lengths.to(text.device)
            ys_in, ys_out = add_sos_eos(text.clamp_min(0).long(),
                                        text_lengths, c.sos_id, c.eos_id)
            logits = self.decoder(ys_in, text_lengths + 1, hs, h_lengths)
            loss_att, acc = label_smoothing_loss(logits, ys_out,
                                                 c.lsm_weight)
            stats["loss_att"] = loss_att
            stats["acc"] = acc
            loss = loss + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats
