"""Hybrid CTC/attention ASR model.

Port of espnet_slurp_tpu/models/asr_model.py: ``ASRConfig`` (with the
reference's fields and defaults; ``Wav2Vec2Config`` is models/wav2vec2.py's,
imported here as the reference imports it), ``build_encoder`` (the encoder
choice), ``build_decoder``, the pre- and post-encoder builders,
``add_sos_eos``,
``label_smoothing_loss`` and ``ASRModel`` with ``encode`` (frontend, or a
feature dump with ``input_feats``, an SSL dump's layers weighted with
``ssl_num_layers`` -> SpecAug when training -> MVN -> the pre-encoder, if
any -> encoder -> the post-encoder, if any; wav2vec2 takes the waveform
straight),
``ctc_logprobs``, ``decoder_logits`` and ``forward`` (the
training loss: CTC through the fused head K4 and the lattice K1, the
interCTC taps through K4 and K1 (with self-conditioning through K1 from
the taps' logits), the MoE load-balance loss, and label-smoothed CE on
the decoder, or with ``use_tcpgen`` and a biasing batch the TCPGen
branch: the decoder's hidden queries the pointer over the batch's trie,
the mixed distribution takes the CE, and the pointer and gate losses join
it). ``unported_options`` names the values that select a path not ported
yet. The encoders are the reference's: conformer, E-Branchformer
(models/branchformer.py), transformer, longformer, the contextual-block
Conformer (models/contextual_block.py), RNN and VGG-RNN
(models/rnn_encoders.py), wav2vec2 (models/wav2vec2.py), or one
registered in utils/registry.py; the CTC head, the decoders' memory and
the post-encoder's input are as wide as the encoder's states
(``memory_dim``: the wav2vec2 config's d_model may differ from d_model);
the
decoders the Transformer decoder, with its self-attention or a lightweight
/ dynamic conv (models/lightconv.py), and the LAS decoder
(models/rnn_decoder.py); the pre-encoders sinc and linear
(models/preencoder.py) and the BERT post-encoder (models/postencoder.py).
Parameters are fp32 and every layer computes in ``cfg.dtype``, as the
flax modules do (models/layers.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.ctc import ctc_loss_mean_logits
from ..ops.frontend import FrontendConfig, default_frontend, feature_dim
from ..ops.kernels.ctc_head import ctc_loss_pallas_head
from ..ops.masks import length_mask
from ..ops.normalize import global_mvn, utterance_mvn
from ..ops.specaug import SpecAugConfig, specaug
from ..utils.config import PORT_ONLY
from ..utils.device import resolve_device
from ..utils.registry import encoders
from .branchformer import EBranchformerEncoder
from .conformer import ConformerEncoder
from .contextual_block import ContextualBlockConformerEncoder
from .layers import Linear
from .postencoder import HFTransformersPostencoder
from .preencoder import LightweightSincConvs, LinearPreencoder
from .rnn_decoder import RNNDecoder
from .rnn_encoders import RNNEncoder, VGGRNNEncoder
from .tcpgen import TCPGen, tcpgen_final_logprobs
from .transformer import TransformerDecoder, TransformerEncoder
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

IGNORE_ID = -1


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Every field of the reference's ASRConfig, under its name, type and
    default, plus the port-only ``fused_conv``. Values that select a path
    not ported yet raise in ``build_encoder`` (``unported_options``)."""
    vocab_size: int = 5000
    # conformer | ebranchformer | transformer | longformer |
    # contextual_block_conformer | rnn | vgg_rnn | wav2vec2 (the raw-
    # waveform SSL encoder of models/wav2vec2.py, past no frontend, SpecAug,
    # MVN or pre-encoder), or one registered in utils/registry.py.
    encoder: str = "conformer"
    # Precomputed-feature input (a stage-3 feature dump): ``speech`` is a
    # [B, T, input_feats_dim or n_mels] matrix past the frontend.
    input_feats: bool = False
    input_feats_dim: int = 0
    # > 0 (with input_feats): ``speech`` is a [B, T, ssl_num_layers, D]
    # dump of every SSL layer (bin/ssl_dump.py), collapsed by a learned
    # softmax layer weighting before SpecAug and MVN (the s3prl
    # Featurizer).
    ssl_num_layers: int = 0
    # Geometry of the longformer and contextual-block encoders.
    attention_window: int = 64
    block_size: int = 40
    hop_size: int = 16
    look_ahead: int = 16
    # transformer | rnn | lightweight_conv | lightweight_conv2d |
    # dynamic_conv | dynamic_conv2d
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
    # "conv2d" (x subsampling_factor in 2, 4, 6, 8) | "linear" (no time
    # reduction).
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


# The decoder choice -> the Transformer decoder's self-attention type, as
# the reference's ASRModel maps it ("rnn" is the LAS decoder instead).
DECODER_SELFATTN = {"transformer": "selfattn",
                    "lightweight_conv": "lightconv",
                    "lightweight_conv2d": "lightconv2d",
                    "dynamic_conv": "dynamicconv",
                    "dynamic_conv2d": "dynamicconv2d"}

# ASRConfig's encoder options that the reference's encoder of each name
# takes no notice of: a value away from the default raises
# (``refuse_ignored_encoder_options``) rather than being dropped.
_IGNORED = ("input_layer", "subsampling_factor", "moe_experts",
            "stochastic_depth_rate", "remat_encoder", "self_conditioning",
            "fused_conv")
IGNORED_ENCODER_OPTIONS = {
    "ebranchformer": _IGNORED,
    "contextual_block_conformer": _IGNORED + ("interctc_layers",
                                              "chunk_size"),
    "rnn": _IGNORED + ("interctc_layers", "chunk_size"),
    "vgg_rnn": _IGNORED + ("interctc_layers", "chunk_size"),
    # the raw-waveform path of the reference's encode skips the feature
    # dump, its layer weighting and the pre-encoder as well
    "wav2vec2": _IGNORED + ("interctc_layers", "chunk_size", "input_feats",
                            "ssl_num_layers", "preencoder"),
}


def refuse_ignored_encoder_options(cfg: ASRConfig) -> None:
    """Raises naming the fields of ``cfg`` away from their defaults that its
    encoder, as the reference builds it, ignores (ROADMAP.md queue 3)."""
    d = ASRConfig()
    ignored = [f for f in IGNORED_ENCODER_OPTIONS.get(cfg.encoder, ())
               if getattr(cfg, f) != getattr(d, f)]
    if cfg.wav2vec2 is not None and cfg.encoder != "wav2vec2":
        ignored.append("wav2vec2")
    if ignored:
        raise NotImplementedError(
            f"encoder {cfg.encoder!r} takes no " + ", ".join(ignored)
            + ": the reference's builds it without them and ignores them "
            "(ROADMAP.md queue 3, the encoders' ignored options)")


def unported_options(cfg: ASRConfig) -> List[str]:
    """The values of ``cfg`` that select a path not ported yet, each naming
    its ROADMAP.md queue 1 item; empty when the port builds ``cfg``."""
    todo = []
    if cfg.use_wpe or cfg.use_beamformer:
        todo.append("use_wpe / use_beamformer (the multichannel frontends: "
                    "queue 1 items 15 and 16)")
    if cfg.num_ref > 1:
        todo.append("num_ref > 1 (PIT: queue 1 items 15 and 16)")
    return todo


def input_dim(cfg: ASRConfig) -> int:
    """The width of the features past the frontend: the dump's with
    ``input_feats``, else the frontend's (ops/frontend.py:feature_dim)."""
    if cfg.input_feats:
        return cfg.input_feats_dim or cfg.frontend.n_mels
    return feature_dim(cfg.frontend)


def encoder_input_dim(cfg: ASRConfig) -> int:
    """The width the encoder takes: the pre-encoder's output, if any, else
    the features'."""
    if cfg.preencoder == "linear":
        return cfg.preencoder_dim
    if cfg.preencoder == "sinc":
        return (LightweightSincConvs.out_width(input_dim(cfg))
                * cfg.preencoder_dim)
    return input_dim(cfg)


def encoder_output_dim(cfg: ASRConfig) -> int:
    """The width of the encoder's states: the wav2vec2 config's d_model
    for ``encoder: wav2vec2``, else d_model."""
    if cfg.encoder == "wav2vec2":
        return (cfg.wav2vec2 or Wav2Vec2Config()).d_model
    return cfg.d_model


def memory_dim(cfg: ASRConfig) -> int:
    """The width of the states that the CTC head and the decoder read:
    d_model past a post-encoder, else the encoder's."""
    return cfg.d_model if cfg.postencoder else encoder_output_dim(cfg)


def build_preencoder(cfg: ASRConfig) -> Optional[nn.Module]:
    """The pre-encoder of ``cfg``: "sinc" (over sliding-window frames),
    "linear", or None for ""."""
    if cfg.preencoder == "sinc":
        return LightweightSincConvs(cfg.preencoder_dim,
                                    fs=float(cfg.frontend.fs),
                                    scale=cfg.preencoder_scale)
    if cfg.preencoder == "linear":
        return LinearPreencoder(input_dim(cfg), cfg.preencoder_dim)
    if cfg.preencoder:
        raise ValueError(f"preencoder must be sinc|linear, got "
                         f"{cfg.preencoder!r}")
    return None


def build_postencoder(cfg: ASRConfig) -> Optional[nn.Module]:
    """The post-encoder of ``cfg``: "hf_bert", or None for ""."""
    if cfg.postencoder == "hf_bert":
        return HFTransformersPostencoder(
            cfg.d_model, cfg.postencoder_hidden, cfg.postencoder_layers,
            cfg.postencoder_heads, cfg.postencoder_ff,
            cfg.postencoder_length_adaptor, cfg.postencoder_hf_dir,
            dtype=cfg.torch_dtype, in_dim=encoder_output_dim(cfg))
    if cfg.postencoder:
        raise ValueError(f"postencoder must be hf_bert, got "
                         f"{cfg.postencoder!r}")
    return None


def build_encoder(cfg: ASRConfig) -> nn.Module:
    """The encoder of ``cfg`` (fp32 parameters), chosen by ``cfg.encoder``
    as the reference's build_encoder chooses it; raises for a value of
    ``cfg`` that selects a path not ported yet. Its forward returns (hs,
    h_lengths, taps)."""
    todo = unported_options(cfg)
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    refuse_ignored_encoder_options(cfg)
    c, idim = cfg, encoder_input_dim(cfg)
    if c.encoder == "conformer":
        return ConformerEncoder(
            idim, c.d_model, c.n_head, c.d_ff, c.num_encoder_blocks,
            c.kernel_size, chunk_size=c.chunk_size,
            left_chunks=c.left_chunks, flash=c.flash_attention,
            subsampling_factor=c.subsampling_factor, fused_conv=c.fused_conv,
            dropout_rate=c.dropout_rate, interctc_layers=c.interctc_layers,
            remat=c.remat_encoder, moe_experts=c.moe_experts,
            moe_every=c.moe_every,
            moe_capacity_factor=c.moe_capacity_factor,
            input_layer=c.input_layer,
            stochastic_depth_rate=c.stochastic_depth_rate,
            self_cond_vocab=c.vocab_size if c.self_conditioning else 0)
    if c.encoder == "ebranchformer":
        return EBranchformerEncoder(
            idim, c.d_model, c.n_head, c.d_ff, c.num_encoder_blocks,
            cgmlp_hidden=2 * c.d_ff, kernel_size=c.kernel_size,
            dropout_rate=c.dropout_rate, interctc_layers=c.interctc_layers,
            chunk_size=c.chunk_size, left_chunks=c.left_chunks,
            flash=c.flash_attention)
    if c.encoder == "transformer":
        return TransformerEncoder(idim, c.d_model, c.n_head, c.d_ff,
                                  c.num_encoder_blocks, c.dropout_rate)
    if c.encoder == "contextual_block_conformer":
        return ContextualBlockConformerEncoder(
            idim, c.d_model, c.n_head, c.d_ff, c.num_encoder_blocks,
            c.kernel_size, c.dropout_rate, block_size=c.block_size,
            hop_size=c.hop_size, look_ahead=c.look_ahead,
            flash=c.flash_attention)
    if c.encoder == "rnn":
        return RNNEncoder(idim, c.d_model, c.rnn_encoder_units,
                          c.rnn_encoder_layers,
                          subsample=c.rnn_encoder_subsample,
                          dropout_rate=c.dropout_rate)
    if c.encoder == "vgg_rnn":
        return VGGRNNEncoder(idim, c.d_model, c.rnn_encoder_units,
                             c.rnn_encoder_layers,
                             dropout_rate=c.dropout_rate)
    if c.encoder == "longformer":
        # The sliding-window conformer: the band is an additive mask over
        # the eager attention, as the reference's (flash "off").
        return ConformerEncoder(
            idim, c.d_model, c.n_head, c.d_ff, c.num_encoder_blocks,
            c.kernel_size, flash="off", dropout_rate=c.dropout_rate,
            interctc_layers=c.interctc_layers,
            attention_window=c.attention_window, remat=c.remat_encoder)
    if c.encoder == "wav2vec2":
        return Wav2Vec2Encoder(c.wav2vec2 or Wav2Vec2Config())
    if c.encoder in encoders:
        return encoders.get(c.encoder)(c, idim)
    raise ValueError(
        f"unknown encoder {c.encoder!r}; builtins: conformer, ebranchformer, "
        f"transformer, longformer, contextual_block_conformer, rnn, vgg_rnn, "
        f"wav2vec2; registered: {encoders.choices()}")


def build_decoder(cfg: ASRConfig) -> nn.Module:
    """The decoder of ``cfg.decoder``: the LAS decoder for "rnn", else the
    Transformer decoder with DECODER_SELFATTN's self-attention type; each
    attends to memory_dim(cfg)-wide states."""
    c = cfg
    if c.decoder == "rnn":
        return RNNDecoder(c.vocab_size, memory_dim(c), c.rnn_decoder_units,
                          c.rnn_decoder_layers, dtype=c.torch_dtype)
    if c.decoder not in DECODER_SELFATTN:
        raise ValueError(f"unknown decoder {c.decoder!r}; choices: rnn, "
                         + ", ".join(DECODER_SELFATTN))
    return TransformerDecoder(
        c.vocab_size, c.d_model, c.n_head, c.decoder_d_ff,
        c.num_decoder_blocks, dtype=c.torch_dtype,
        selfattn_type=DECODER_SELFATTN[c.decoder],
        conv_wshare=c.decoder_conv_wshare, conv_kernel=c.decoder_conv_kernel,
        conv_usebias=c.decoder_conv_usebias, memory_dim=memory_dim(c))


def encode_speech(cfg: ASRConfig, encoder: nn.Module,
                  speech: torch.Tensor, speech_lengths: torch.Tensor,
                  mvn_stats=None, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  preencoder: Optional[nn.Module] = None,
                  postencoder: Optional[nn.Module] = None,
                  ssl_layer_weights: Optional[torch.Tensor] = None):
    """Frontend (or, with ``cfg.input_feats``, the [B, T, D] feature dump
    as given, or a [B, T, L, D] SSL dump collapsed by the softmax of
    ``ssl_layer_weights``) -> SpecAug (when ``train`` with ``cfg.specaug``
    and a ``generator``) -> MVN -> ``preencoder`` (if given; its output
    cast to ``cfg.dtype``) -> ``encoder`` (with ``train``, dropout at
    ``cfg.dropout_rate`` drawn from ``generator``) -> ``postencoder`` (if
    given), in ``cfg.dtype``: the encode of every model built on the ASR
    stack. ``encoder: wav2vec2`` takes the raw waveform straight (no
    frontend, SpecAug, MVN or pre-encoder) and its states, in the wav2vec2
    config's dtype, are cast to ``cfg.dtype`` before the post-encoder, as
    the reference's layers cast their inputs. Returns the encoder's (hs,
    h_lengths, taps), hs and h_lengths past the post-encoder."""
    if cfg.encoder == "wav2vec2":
        hs, h_lengths, taps = encoder(speech, speech_lengths, train,
                                      generator)
        hs = hs.to(cfg.torch_dtype)
        if postencoder is not None:
            hs, h_lengths = postencoder(hs, h_lengths)
        return hs, h_lengths, taps
    if cfg.input_feats:
        feats, feat_lengths = speech.float(), speech_lengths
        if ssl_layer_weights is not None:
            w = torch.softmax(ssl_layer_weights.float(), dim=0)
            feats = torch.einsum("btld,l->btd", feats, w)
    else:
        feats, feat_lengths = default_frontend(speech, speech_lengths,
                                               cfg.frontend)
    if train and cfg.specaug is not None and generator is not None:
        feats = specaug(feats, feat_lengths, cfg.specaug, generator)
    if cfg.use_mvn == "global" and mvn_stats is not None:
        feats = global_mvn(feats, feat_lengths, *mvn_stats)
    elif cfg.use_mvn == "utterance":
        feats = utterance_mvn(feats, feat_lengths)
    feats = feats.to(cfg.torch_dtype)
    if preencoder is not None:
        feats = preencoder(feats, train, generator).to(cfg.torch_dtype)
    hs, h_lengths, taps = encoder(feats, feat_lengths, train, generator)
    if postencoder is not None:
        hs, h_lengths = postencoder(hs, h_lengths)
    return hs, h_lengths, taps


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
                         smoothing: float, ignore_id: int = IGNORE_ID,
                         logits_are_logprobs: bool = False):
    """Label-smoothed CE, mean over valid tokens (the reference's
    token-mean form): (loss, accuracy). With ``logits_are_logprobs`` the
    input is taken as log-probabilities (TCPGen's mixed distribution)."""
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = (logits.float() if logits_are_logprobs
            else torch.log_softmax(logits.float(), dim=-1))
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
        pre, post = build_preencoder(c), build_postencoder(c)
        if pre is not None:
            self.preencoder = pre
        if post is not None:
            self.postencoder = post
        if c.ssl_num_layers > 0:
            if not c.input_feats:
                raise ValueError("ssl_num_layers > 0 weights the layers of "
                                 "an SSL feature dump: set input_feats")
            self.ssl_layer_weights = nn.Parameter(
                torch.zeros(c.ssl_num_layers))
        self.ctc_proj = Linear(memory_dim(c), c.vocab_size)
        self.decoder = build_decoder(c)
        if c.use_tcpgen:
            self.tcpgen = TCPGen(c.d_model, c.vocab_size,
                                 c.tcpgen_gcn_layers,
                                 tree_encoder=c.tcpgen_tree_encoder,
                                 dtype=c.torch_dtype)
        self.to(device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.ctc_proj.weight.device

    def _encode(self, speech, speech_lengths, mvn_stats, train, generator):
        return encode_speech(self.cfg, self.encoder, speech, speech_lengths,
                             mvn_stats, train, generator,
                             getattr(self, "preencoder", None),
                             getattr(self, "postencoder", None),
                             getattr(self, "ssl_layer_weights", None))

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               mvn_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               *, train: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw waveform [B, N] (or, with ``cfg.input_feats``, features [B,
        T, D]) -> (hs [B, T', D], h_lengths [B]); self-conditioning, if
        any, runs inside the encoder. With ``train``, ``cfg.specaug`` and
        a ``generator`` the features are augmented, and with ``train`` the
        encoder drops at ``cfg.dropout_rate`` (every draw from the
        generator)."""
        hs, h_lengths, _ = self._encode(speech, speech_lengths, mvn_stats,
                                        train, generator)
        return hs, h_lengths

    def ctc_logprobs(self, hs: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ctc_proj(hs).float(), dim=-1)

    def decoder_logits(self, ys_in, ys_in_lengths, hs, h_lengths):
        return self.decoder(ys_in, ys_in_lengths, hs, h_lengths)

    def tcpgen_tree_encs(self, trie) -> torch.Tensor:
        """Every node of ``trie`` encoded by TCPGen's tree encoder from the
        decoder's embedding of its incoming token."""
        token_embs = self.decoder.embed(trie["trie_token"].long())
        return self.tcpgen.encode_tree(token_embs.to(self.cfg.torch_dtype),
                                       trie)

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
                trie_token=None, trie_children_tok=None,
                trie_children_node=None, trie_n_children=None, node=None,
                p_gen_mask=None, ptr_label_mask=None, smoothprob_scale=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                mvn_stats=None):
        """Training forward -> (loss, stats) with loss_ctc, loss_att, acc,
        loss, and loss_moe_aux (MoE) and loss_interctc (interCTC) where
        they apply: moe_aux_weight * aux + ctc_weight * ((1 -
        interctc_weight) * CTC + interctc_weight * mean tap CTC) + (1 -
        ctc_weight) * label-smoothed CE, as the reference assembles it.
        Each tap's CTC is K4 then K1 from its after_norm states, or, with
        self-conditioning, K1 from its logits (ops/ctc.py:
        ctc_loss_mean_logits). ``generator`` draws SpecAug's masks and the
        encoder's dropout (its kernels' seeds) and stochastic depth when
        ``train``. The decoder takes no dropout, as the reference's
        (ROADMAP.md queue 3).

        The trie_* / node / p_gen_mask keywords are a TCPGen biasing batch
        (slu/kb.py:TCPGenBatchAugmenter): a flat trie shared by the batch
        and the teacher-forced walk [B, U+1]. With ``use_tcpgen`` they
        switch the CE onto TCPGen's mixed distribution and add the stats
        p_gen (and p_gen_bias with ``ptr_label_mask``); with
        ``ptr_label_mask`` the class-balanced pointer loss (loss_ptr,
        weight tcpgen_ptr_loss_weight) and gate loss (loss_gate, weight
        tcpgen_gate_loss_weight, scaled by ``smoothprob_scale``) join the
        loss. ``smoothprob_scale`` scales p_gen (the pointer ramp)."""
        c = self.cfg
        hs, h_lengths, taps = self._encode(speech, speech_lengths, mvn_stats,
                                           train, generator)
        stats = {}
        loss = torch.zeros((), device=hs.device)
        moe_aux = dict(taps).get("moe_aux")
        taps = [(k, x) for k, x in taps if k != "moe_aux"]
        if moe_aux is not None and c.moe_aux_weight > 0.0:
            stats["loss_moe_aux"] = moe_aux
            loss = loss + c.moe_aux_weight * moe_aux
        if c.ctc_weight > 0.0:
            loss_ctc = self._ctc_loss_mean(hs, h_lengths, text, text_lengths)
            stats["loss_ctc"] = loss_ctc
            if c.interctc_weight > 0.0 and taps:
                inter = sum(
                    ctc_loss_mean_logits(xs, h_lengths, text.clamp_min(0),
                                         text_lengths, c.blank_id)
                    if c.self_conditioning else
                    self._ctc_loss_mean(xs, h_lengths, text, text_lengths)
                    for _, xs in taps) / len(taps)
                stats["loss_interctc"] = inter
                loss_ctc = ((1.0 - c.interctc_weight) * loss_ctc
                            + c.interctc_weight * inter)
            loss = loss + c.ctc_weight * loss_ctc
        if c.ctc_weight < 1.0:
            text_lengths = text_lengths.to(text.device)
            ys_in, ys_out = add_sos_eos(text.clamp_min(0).long(),
                                        text_lengths, c.sos_id, c.eos_id)
            if c.use_tcpgen and trie_token is not None:
                trie = {"trie_token": trie_token,
                        "trie_children_tok": trie_children_tok,
                        "trie_children_node": trie_children_node,
                        "trie_n_children": trie_n_children}
                loss_att, acc, extra = self._tcpgen_loss(
                    ys_in, ys_out, text_lengths, hs, h_lengths, trie, node,
                    p_gen_mask, ptr_label_mask, smoothprob_scale, stats)
                loss = loss + extra
            else:
                logits = self.decoder(ys_in, text_lengths + 1, hs, h_lengths)
                loss_att, acc = label_smoothing_loss(logits, ys_out,
                                                     c.lsm_weight)
            stats["loss_att"] = loss_att
            stats["acc"] = acc
            loss = loss + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats

    def _tcpgen_loss(self, ys_in, ys_out, text_lengths, hs, h_lengths, trie,
                     node, p_gen_mask, ptr_label_mask, smoothprob_scale,
                     stats):
        """The biased decoder loss (reference asr_model.py:566-614): the
        label-smoothed CE on TCPGen's mixed log-probs, the p_gen stats into
        ``stats``, and the weighted pointer and gate losses. Returns
        (loss_att, acc, the pointer and gate terms to add)."""
        c = self.cfg
        logits, hidden = self.decoder(ys_in, text_lengths + 1, hs, h_lengths,
                                      return_hidden=True)
        ptr_dist, kb_emb = self.tcpgen(hidden, node, trie,
                                       self.tcpgen_tree_encs(trie))
        sp = c.tcpgen_smoothprob
        if smoothprob_scale is not None:
            sp = sp * smoothprob_scale
        p_gen = self.tcpgen.gen_prob(hidden, kb_emb, p_gen_mask, sp)
        loss_att, acc = label_smoothing_loss(
            tcpgen_final_logprobs(logits, ptr_dist, p_gen), ys_out,
            c.lsm_weight, logits_are_logprobs=True)
        stats["p_gen"] = p_gen.mean()
        extra = torch.zeros((), device=hs.device)
        if ptr_label_mask is None:
            return loss_att, acc, extra
        m1 = (ptr_label_mask == 1).float()
        m2 = (ptr_label_mask == 2).float()
        n1, n2 = m1.sum(), m2.sum()
        # gate openness where pointing is right: the mean over all steps
        # hides a contextual gate (biased steps are a few % of a batch)
        stats["p_gen_bias"] = (p_gen * m1).sum() / n1.clamp_min(1.0)
        if c.tcpgen_ptr_loss_weight > 0.0:
            # label 1: -log ptr(target child); label 2: -log ptr(OOKB),
            # the classes balanced so the attention does not collapse onto
            # the sink
            tgt = ys_out.clamp(0, c.vocab_size - 1).long()
            p_child = ptr_dist[..., :c.vocab_size].gather(
                -1, tgt[..., None])[..., 0]
            w = m1 + m2 * (n1 / n2.clamp_min(1.0))
            p_tgt = torch.where(ptr_label_mask == 1, p_child,
                                ptr_dist[..., c.vocab_size])
            loss_ptr = ((-torch.log(p_tgt + 1e-9) * w).sum()
                        / w.sum().clamp_min(1.0))
            stats["loss_ptr"] = loss_ptr
            extra = extra + c.tcpgen_ptr_loss_weight * loss_ptr
        if c.tcpgen_gate_loss_weight > 0.0:
            # class-balanced oracle-gate BCE: open where pointing, shut at
            # OOKB steps; scaled as the ramp scales p_gen
            w = m1 + m2 * (n1 / n2.clamp_min(1.0))
            bce = -(m1 * torch.log(p_gen + 1e-6)
                    + m2 * torch.log(1.0 - p_gen + 1e-6))
            loss_gate = (bce * w).sum() / w.sum().clamp_min(1.0)
            stats["loss_gate"] = loss_gate
            scale = 1.0 if smoothprob_scale is None else smoothprob_scale
            extra = extra + c.tcpgen_gate_loss_weight * scale * loss_gate
        return loss_att, acc, extra
