"""ASR task: config-driven wiring of data + model + trainer + inference.

Port of espnet_slurp_tpu/tasks/asr.py: ``DataConfig``, ``ASRTaskConfig`` and
``load_task_config`` (field for field, with the reference's defaults);
``ASRTask`` (vocabulary, datasets, the bucketed batch iterator, the model,
global MVN stats, the reference's parameter init, and ``train``, which runs
the Trainer); and ``Speech2Text``, built from a config, a state_dict and a
token list, or from an experiment directory (``Speech2Text.from_exp_dir``).

The YAML layout is the reference's:

    model:   {ASRConfig fields}
    optim:   {OptimConfig fields}
    data:    {DataConfig fields}
    max_epoch, keep_nbest, ...: the Trainer's options

``data.feats_type: fbank`` trains on a stage-3 feature dump (feats.scp of
.npy [T, D] matrices, the npy loader) with the model's ``input_feats``;
Speech2Text then turns waveforms into the same features on the model's
device before it decodes, as the reference's does. ``data.feats_type:
ssl`` trains on a bin/ssl_dump.py dump ([T, D], or [T, L, D] with the
model's ``ssl_num_layers`` L, padded along T only) and Speech2Text decodes
the dumped matrices themselves. ``mbr.weight > 0`` adds
the MBR / KB-MBR term to the step (train/mbr.py), and ``Speech2Text``
decodes with TCPGen biasing over ``biasing_words`` (a ``use_tcpgen``
model, beam search), with shallow fusion of a tasks/lm.py LM and an ARPA
n-gram and with internal-LM subtraction. ``data.resident_corpus`` keeps the
train and valid waveforms in card memory (data/resident.py) and gathers
each batch's speech there. ``model_arch: maskctc`` trains
models/maskctc.py:MaskCTCModel (its target masks drawn from the train
step's generator; no MBR term, as the reference's) and
``Speech2TextMaskCTC`` decodes it. Every encoder, decoder, pre- and
post-encoder of models/asr_model.py trains and decodes here (with
``postencoder_hf_dir`` the BERT's weights are grafted in at the start of
training). Config values that select paths
not ported yet raise, naming their queue item in ROADMAP.md:
``pipeline_stages > 1``,
``num_att_plot > 0``, ``data.multichannel``,
``data.feats_type: fbank_pitch``, and the model values of
models/asr_model.py:unported_options.

Speech2Text pads as the reference does, because the STFT reflect-pads the
padded [B, N] buffer and the padded length therefore changes the last frames
of shorter utterances: the batch is padded to a power of two (padding rows
get length 1) and the samples to ``bucket_length(max_len, 4096)``.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.cleaner import TextCleaner
from ..data.collate import asr_batch, common_collate
from ..data.dataset import CommonPreprocessor, SpeechDataset
from ..data.fileio import read_2column_text
from ..data.prefetch import prefetch_to_device
from ..data.sampler import build_batches, bucket_length, epoch_shuffle
from ..data.tokenizer import (BpeTokenizer, TokenIDConverter,
                              build_token_list, build_tokenizer)
from ..decode.beam import BeamSearchConfig, batch_beam_search
from ..decode.greedy import attention_greedy_decode
from ..decode.lattice import LatticeConfig, lattice_rescore_decode
from ..decode.ngram import ArpaLM, make_ngram_fusion
from ..decode.timesync import TimeSyncConfig, ctc_timesync_beam_search
from ..models.asr_model import (ASRConfig, ASRModel,
                                refuse_ignored_encoder_options,
                                unported_options)
from ..models.lightconv import LightweightConvolution
from ..models.maskctc import MaskCTCModel
from ..models.moe import MoEFeedForward
from ..models.preencoder import SincConv
from ..models.tcpgen import GATTreeEncoder, TCPGen
from ..models.layers import LSTMLayer
from ..ops.frontend import default_frontend
from ..ops.normalize import mvn_tensors
from ..slu.kb import boundary_token_ids, build_trie
from ..train.checkpoint import CKPT_FILE, CheckpointManager
from ..train.mbr import MBRConfig, make_mbr_aux_loss
from ..train.optim import OptimConfig, build_optimizer
from ..train.state import TrainState, make_eval_step, make_train_step
from ..train.trainer import Trainer, TrainerOptions
from ..utils.config import from_dict, load_yaml, merge_dicts, save_yaml
from ..utils.device import resolve_device
from .lm import LMTask, make_lm_fusion

log = logging.getLogger("espnet_slurp_tpu_torch")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    token_type: str = "char"  # char | word | bpe | phn
    # Text cleaner applied before tokenization AND before token-list/BPE
    # building: "" | tacotron | jaconv | lowercase | uppercase | whitespace
    # (espnet2/text/cleaner.py --cleaner flag analogue).
    text_cleaner: str = ""
    bpemodel: Optional[str] = None
    bpe_vocab_size: int = 300
    # "prefix" (HF Metaspace '▁ca t') | "suffix" ('ca t▁' — the fork's
    # TCPGen dictionary convention).
    bpe_marker: str = "prefix"
    # Multichannel audio (the reference's WPE/MVDR frontend path): not
    # ported yet, raises when set.
    multichannel: bool = False
    # "raw" decodes wav.scp on the fly; "fbank" reads a stage-3 feature
    # dump (feats.scp of .npy [T, D] matrices; pair with model.input_feats);
    # "ssl" a bin/ssl_dump.py dump (feats.scp of [T, D] or [T, L, D]
    # matrices; pair with input_feats, and ssl_num_layers L for the
    # latter). "fbank_pitch" (pitch) is not ported yet and raises.
    feats_type: str = "raw"
    batch_type: str = "numel"
    batch_size: int = 16
    batch_bins: int = 2_000_000
    speech_bucket_multiple: int = 4096
    text_bucket_multiple: int = 8
    # Round numel/length batch sizes down to this multiple (tail carries
    # into the next batch) so B is bucketed like the padded lengths
    # (data/sampler.py).
    batch_size_multiple: int = 1
    num_iters_per_epoch: Optional[int] = None
    seed: int = 0
    # Keep the waveforms on the device (data/resident.py): batches gather
    # their speech there; raw single-channel audio only.
    resident_corpus: bool = False
    resident_workers: int = 16


@dataclasses.dataclass(frozen=True)
class ASRTaskConfig:
    exp_dir: str = "exp/asr"
    # "asr" (hybrid CTC/attention) | "maskctc" (mask-predict)
    model_arch: str = "asr"
    model: ASRConfig = ASRConfig()
    optim: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()
    mbr: MBRConfig = MBRConfig()
    # Pipeline parallelism (the reference's parallel/pipelined_asr.py): not
    # ported yet, > 1 raises.
    pipeline_stages: int = 0
    pipeline_microbatches: int = 4
    max_epoch: int = 40
    # Attention heat-maps per epoch (train/attention_plot.py): not ported
    # yet, > 0 raises.
    num_att_plot: int = 0
    patience: Optional[int] = None
    keep_nbest: int = 10
    nbest_average: int = 5
    log_interval: int = 50
    resume: bool = True
    # Warm-start: a params-only checkpoint directory of this package's
    # format (e.g. a prior run's 'valid.loss.ave_5best') loaded into the
    # fresh model when no resume checkpoint exists — reference --init_param.
    # Optimizer state starts fresh (fine-tune semantics).
    init_params_from: str = ""


def load_task_config(path: str | None = None, overrides: Dict | None = None
                     ) -> ASRTaskConfig:
    d = load_yaml(path) if path else {}
    if overrides:
        d = merge_dicts(d, overrides)
    return from_dict(ASRTaskConfig, d)


def refuse_unported(cfg: ASRTaskConfig) -> None:
    """Raises for a config value that selects a path not ported yet, and
    for an encoder option that the chosen encoder ignores
    (models/asr_model.py:refuse_ignored_encoder_options)."""
    todo = []
    if cfg.pipeline_stages > 1:
        todo.append("pipeline_stages > 1 (pipeline parallelism: queue 1 "
                    "item 17)")
    if cfg.num_att_plot > 0:
        todo.append("num_att_plot > 0 (train/attention_plot.py: queue 1 "
                    "item 17)")
    if cfg.data.multichannel:
        todo.append("data.multichannel (the WPE / beamformer frontends: "
                    "queue 1 item 15)")
    if cfg.data.feats_type not in ("raw", "fbank", "ssl"):
        todo.append(f"data.feats_type {cfg.data.feats_type!r} (pitch "
                    "feature dumps: queue 1 item 15)")
    todo += unported_options(cfg.model)
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    refuse_ignored_encoder_options(cfg.model)


# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that the truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class ASRTask:
    """Builds every component from an ASRTaskConfig and runs training."""

    # ---------- vocabulary ----------

    @staticmethod
    def prepare_vocab(cfg: ASRTaskConfig):
        """Build tokenizer + token list from the training text. Returns
        (tokenizer, converter, resolved ASRConfig with true vocab_size)."""
        data = cfg.data
        # Lazy train-text read: an exp dir carries tokens.txt (+ bpe.json)
        # and inference must not touch data.train_dir then.
        _texts_cache = {}

        def texts():
            if "t" not in _texts_cache:
                t = read_2column_text(Path(data.train_dir) / "text")
                if data.text_cleaner:
                    clean = TextCleaner(data.text_cleaner)
                    t = {k: clean(v) for k, v in t.items()}
                _texts_cache["t"] = t
            return _texts_cache["t"]

        if data.token_type == "bpe":
            bpe_path = data.bpemodel or str(Path(cfg.exp_dir) / "bpe.json")
            if not Path(bpe_path).exists():
                BpeTokenizer.train(texts().values(), data.bpe_vocab_size,
                                   bpe_path)
            tokenizer = build_tokenizer("bpe", bpemodel=bpe_path,
                                        bpe_marker=data.bpe_marker)
        else:
            tokenizer = build_tokenizer(data.token_type)
        token_list_path = Path(cfg.exp_dir) / "tokens.txt"
        if token_list_path.exists():
            converter = TokenIDConverter(token_list_path)
        else:
            tl = build_token_list(texts().values(), tokenizer)
            token_list_path.parent.mkdir(parents=True, exist_ok=True)
            token_list_path.write_text(
                "\n".join(tl) + "\n", encoding="utf-8")
            converter = TokenIDConverter(tl)
        model_cfg = dataclasses.replace(cfg.model,
                                        vocab_size=converter.vocab_size)
        return tokenizer, converter, model_cfg

    # ---------- data ----------

    @staticmethod
    def build_dataset(data_dir: str, tokenizer, converter,
                      text_cleaner: str = "",
                      feats_type: str = "raw") -> SpeechDataset:
        """The speech stream is wav.scp, or with ``feats_type`` fbank or
        ssl the dump's feats.scp (npy [T, D] or [T, L, D] matrices)."""
        speech = (("feats.scp", "npy") if feats_type != "raw"
                  else ("wav.scp", "sound"))
        streams = [(str(Path(data_dir) / speech[0]), "speech", speech[1]),
                   (str(Path(data_dir) / "text"), "text", "text")]
        cleaner = TextCleaner(text_cleaner) if text_cleaner else None
        pre = CommonPreprocessor(tokenizer, converter, text_names=("text",),
                                 cleaner=cleaner)
        ds = SpeechDataset(streams, preprocess=pre)
        ds.data_dir = data_dir
        return ds

    @staticmethod
    def collect_shapes(dataset: SpeechDataset):
        """(speech_shapes, text_shapes) WITHOUT decoding any audio.

        Priority (abs_task.py:1477-1553 shape-file semantics): a
        ``utt2num_samples`` file next to the data, else wav HEADER reads
        (loader.shape), else a full decode as last resort. Text lengths
        come from tokenizing the text stream only.
        """
        speech_shapes, text_shapes = {}, {}
        samples = None
        data_dir = getattr(dataset, "data_dir", None)
        if data_dir and (Path(data_dir) / "utt2num_samples").exists():
            samples = {k: (int(v),) for k, v in read_2column_text(
                Path(data_dir) / "utt2num_samples").items()}
        sound = dataset.loaders.get("speech")
        for uid in dataset.keys:
            if samples is not None and uid in samples:
                speech_shapes[uid] = samples[uid]
            elif hasattr(sound, "shape"):
                speech_shapes[uid] = (sound.shape(uid),)
            else:
                _, d = dataset[uid]
                speech_shapes[uid] = (len(d["speech"]),)
            txt = dataset.loaders["text"][uid]
            if dataset.preprocess is not None:
                txt = dataset.preprocess(uid, {"text": txt})["text"]
            text_shapes[uid] = (len(txt),)
        return speech_shapes, text_shapes

    @classmethod
    def build_iter_factory(cls, cfg: ASRTaskConfig, dataset: SpeechDataset,
                           shuffle: bool = True, speech_materializer=None):
        """Epoch-seeded bucketed batch iterator factory (SURVEY.md §2.2):
        epoch -> iterator of numpy batches (``data/collate.py:asr_batch``),
        the reference's batches for the same corpus and seed. With
        ``speech_materializer(uids, t_pad) -> (speech, lengths)``
        (data/resident.py:ResidentCorpus.materializer) only the token
        streams are read on the host and the speech is gathered on the
        device, padded to the same bucketed length."""
        data = cfg.data
        speech_shapes, text_shapes = cls.collect_shapes(dataset)
        # utt2category file next to the data keeps categories unmixed
        # within batches (samplers/build_batch_sampler.py utt2category).
        u2c = None
        data_dir = getattr(dataset, "data_dir", None)
        if data_dir and (Path(data_dir) / "utt2category").exists():
            u2c = read_2column_text(Path(data_dir) / "utt2category")
        batches = build_batches(
            [speech_shapes, text_shapes], batch_type=data.batch_type,
            batch_size=data.batch_size, batch_bins=data.batch_bins,
            utt2category=u2c, batch_size_multiple=data.batch_size_multiple)
        buckets = {"speech": data.speech_bucket_multiple,
                   "text": data.text_bucket_multiple}

        def factory(epoch: int):
            bs = epoch_shuffle(batches, data.seed, epoch) if shuffle \
                else batches
            if data.num_iters_per_epoch:
                k = data.num_iters_per_epoch
                bs = bs[(epoch - 1) * k % max(len(bs), 1):][:k] or bs[:k]
            for batch_utts in bs:
                if speech_materializer is None:
                    items = [dataset[u] for u in batch_utts]
                else:
                    items = [dataset.item_without(u, skip=("speech",))
                             for u in batch_utts]
                uids, coll = common_collate(items, bucket_multiples=buckets)
                if speech_materializer is not None:
                    t_pad = bucket_length(
                        max(speech_shapes[u][0] for u in batch_utts),
                        data.speech_bucket_multiple)
                    coll["speech"], coll["speech_lengths"] = \
                        speech_materializer(batch_utts, t_pad)
                yield asr_batch(uids, coll)

        return factory

    # ---------- model/training ----------

    @staticmethod
    def build_model(model_cfg: ASRConfig, arch: str = "asr",
                    device=None) -> nn.Module:
        """ASRModel, or with ``arch`` "maskctc" MaskCTCModel."""
        if arch == "maskctc":
            return MaskCTCModel(model_cfg, device=device)
        if arch != "asr":
            raise ValueError(f"model_arch {arch!r}: asr or maskctc")
        return ASRModel(model_cfg, device=device)

    @staticmethod
    def load_mvn_stats(cfg: ASRTaskConfig, device=None):
        """(mean, inv_std) tensors on ``device`` from the collect-stats
        output, if GlobalMVN; else None."""
        if cfg.model.use_mvn != "global":
            return None
        stats_path = Path(cfg.exp_dir) / "stats" / "feats_stats.npz"
        if not stats_path.exists():
            log.warning("use_mvn=global but %s missing; run collect-stats "
                        "first", stats_path)
            return None
        from ..ops.normalize import global_mvn_params
        mean, inv_std = global_mvn_params(str(stats_path))
        dev = resolve_device(device)
        return (torch.from_numpy(mean).to(dev),
                torch.from_numpy(inv_std).to(dev))

    @staticmethod
    def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
        """Draws every parameter from the reference's flax initializers,
        with a CPU ``torch.Generator`` seeded by ``seed`` (so the card and
        the CPU start from the same values): Linear and Conv weights
        lecun_normal (fan_in = in_features, or in_channels / groups x the
        kernel's taps), their biases 0; LayerNorm and GroupNorm scale 1,
        bias 0; Embedding
        N(0, 1 / features) (flax's Embed default); an LSTM layer as flax's
        OptimizedLSTMCell (input kernels lecun_normal, each gate's
        recurrent kernel orthogonal, bias 0); the MoE's expert kernels [E,
        in, out] lecun_normal with flax's fan_in of E x in, their biases
        0; the attention's pos_bias_u / pos_bias_v 0; TCPGen's ooKBemb
        N(0, 0.02^2) and its GAT tree encoder's a_src / a_tgt N(0, 0.1^2),
        bias 0; a SincConv's band edges ``f`` its scale's bank over fs; a
        lightweight conv's kernels ``weight`` / ``weight_f`` U[0, 1)
        (flax's uniform(1.0)), its ``bias`` 0; the SSL models'
        ``mask_emb`` and ``codebook`` N(0, 0.02^2), an ASR model's
        ``ssl_layer_weights`` 0. Any other parameter raises. Returns the
        model."""
        gen = torch.Generator().manual_seed(seed)
        done = set()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                    w = torch.empty(m.weight.shape)
                    std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=gen)
                    m.weight.copy_(w)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, nn.Embedding):
                    m.weight.copy_(torch.randn(
                        m.weight.shape, generator=gen)
                        * m.weight.shape[1] ** -0.5)
                elif isinstance(m, LSTMLayer):
                    w = torch.empty(m.weight_ih.shape)
                    std = m.weight_ih.shape[1] ** -0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=gen)
                    m.weight_ih.copy_(w)
                    for gate in m.weight_hh.view(4, m.hidden, m.hidden):
                        w = torch.empty(gate.shape)
                        nn.init.orthogonal_(w, generator=gen)
                        gate.copy_(w)
                    m.bias_hh.zero_()
                elif isinstance(m, MoEFeedForward):
                    for w in (m.w1, m.w2):
                        std = (w.shape[0] * w.shape[1]) ** -0.5 / _TRUNC_STD
                        x = torch.empty(w.shape)
                        nn.init.trunc_normal_(x, 0.0, std, -2 * std,
                                              2 * std, generator=gen)
                        w.copy_(x)
                    m.b1.zero_()
                    m.b2.zero_()
                elif isinstance(m, TCPGen):
                    m.ooKBemb.copy_(torch.randn(m.ooKBemb.shape,
                                                generator=gen) * 0.02)
                elif isinstance(m, SincConv):
                    m.f.copy_(m.initial_bands())
                elif isinstance(m, LightweightConvolution):
                    for name in ("weight", "weight_f"):
                        if hasattr(m, name):
                            p = getattr(m, name)
                            p.copy_(torch.rand(p.shape, generator=gen))
                    if m.use_bias:
                        m.bias.zero_()
                elif isinstance(m, GATTreeEncoder):
                    for name, p in m.named_parameters(recurse=False):
                        if name.startswith("bias_l"):
                            p.zero_()
                        else:  # a_src_l*, a_tgt_l*
                            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
                else:
                    continue
                done.update(id(p) for p in m.parameters(recurse=False))
            for name, p in model.named_parameters():
                if id(p) in done:
                    continue
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("mask_emb", "codebook"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
                elif leaf in ("pos_bias_u", "pos_bias_v", "ssl_layer_weights"):
                    p.zero_()
                else:
                    raise ValueError(f"init_params: no initializer for {name}")
        return model

    @staticmethod
    def load_postencoder_weights(model: nn.Module,
                                 model_cfg: ASRConfig) -> None:
        """Grafts the local HF BERT checkpoint ``postencoder_hf_dir`` into
        the post-encoder's ``bert``, byte for byte (the reference's
        load_postencoder_weights, the SLU postdecoder's graft path), but
        the word embedding, which the post-encoder does not hold (it feeds
        inputs_embeds); nothing without a directory."""
        if model_cfg.postencoder != "hf_bert" \
                or not model_cfg.postencoder_hf_dir:
            return
        from ..models.hf_transformer import load_bert_from_dir
        _, sd = load_bert_from_dir(model_cfg.postencoder_hf_dir,
                                   device="cpu")
        model.postencoder.bert.load_state_dict(
            {k: v for k, v in sd.items()
             if not k.startswith("word_embeddings.")})

    @staticmethod
    def load_init_params(model: nn.Module, path: str) -> None:
        """Warm start from a params-only checkpoint directory: every tensor
        whose key and shape the checkpoint has is loaded (cast to the
        model's dtype), the others keep their fresh values — the
        reference's leaf-wise merge, key-wise."""
        loaded = torch.load(Path(path) / CKPT_FILE, map_location="cpu",
                            weights_only=True)["params"]
        own = model.state_dict()
        hits = {k: loaded[k].to(v.dtype) for k, v in own.items()
                if k in loaded and loaded[k].shape == v.shape}
        model.load_state_dict({**own, **hits})
        log.info("init_params_from %s: %d/%d tensors loaded", path,
                 len(hits), len(own))

    @staticmethod
    def _kb_token_mask(cfg: ASRTaskConfig, vocab_size: int):
        """[vocab_size] bool tensor of KB-member subword ids for KB-MBR (the
        fork's KBwplist membership, by token), or None without
        ``mbr.rare_weight`` and ``mbr.kb_tokens``. Ids past the vocabulary
        are dropped, as the reference's scatter drops them."""
        if cfg.mbr.rare_weight <= 0 or not cfg.mbr.kb_tokens:
            return None
        ids = torch.tensor([i for i in cfg.mbr.kb_tokens
                            if 0 <= i < vocab_size], dtype=torch.long)
        mask = torch.zeros(vocab_size, dtype=torch.bool)
        mask[ids] = True
        return mask

    @classmethod
    def train(cls, cfg: ASRTaskConfig, device=None) -> TrainState:
        """Trains on ``device`` (the card unless given, e.g. "cpu"):
        config.yaml and tokens.txt into exp_dir, then the Trainer with
        its checkpoints and n-best average. Returns the final TrainState;
        the model's parameters are those of the last epoch. With
        ``mbr.weight > 0`` each step adds the MBR term (train/mbr.py). A
        ``use_tcpgen`` model trains its pointer only on batches that carry
        a trie, as the reference's: wrap ``build_iter_factory`` with
        slu/kb.py:TCPGenBatchAugmenter.wrap (the reference's
        recipe/ablation_run.py does)."""
        if cfg.data.resident_corpus and (cfg.data.multichannel
                                         or cfg.data.feats_type != "raw"):
            raise ValueError("resident_corpus supports single-process "
                             "raw-audio runs")
        refuse_unported(cfg)
        dev = resolve_device(device)
        exp = Path(cfg.exp_dir)
        exp.mkdir(parents=True, exist_ok=True)
        tokenizer, converter, model_cfg = cls.prepare_vocab(cfg)
        resolved = dataclasses.replace(cfg, model=model_cfg)
        save_yaml(resolved, exp / "config.yaml")

        model = cls.build_model(model_cfg, cfg.model_arch, dev)
        cls.init_params(model, cfg.data.seed)
        if cfg.model_arch == "asr":
            cls.load_postencoder_weights(model, model_cfg)
        if cfg.init_params_from and not (exp / "latest.json").exists():
            cls.load_init_params(model, cfg.init_params_from)
        tx = build_optimizer(cfg.optim)
        state = TrainState.create(model, tx, seed=cfg.data.seed,
                                  ema=cfg.optim.ema_decay > 0,
                                  guard=cfg.optim.spike_factor > 0)

        train_ds, valid_ds = (
            cls.build_dataset(d, tokenizer, converter,
                              text_cleaner=cfg.data.text_cleaner,
                              feats_type=cfg.data.feats_type)
            for d in (cfg.data.train_dir, cfg.data.valid_dir))
        # Only a resident corpus passes the materializer, so a subclass
        # that overrides build_iter_factory with the reference's
        # (cfg, dataset, shuffle) signature keeps working.
        resident = {}
        if cfg.data.resident_corpus:
            from ..data.resident import ResidentCorpus
            resident["speech_materializer"] = ResidentCorpus.from_datadirs(
                [cfg.data.train_dir, cfg.data.valid_dir],
                workers=cfg.data.resident_workers, device=dev).materializer()
        train_if = cls.build_iter_factory(cfg, train_ds, shuffle=True,
                                          **resident)
        valid_if = cls.build_iter_factory(cfg, valid_ds, shuffle=False,
                                          **resident)
        mvn_stats = cls.load_mvn_stats(cfg, dev)
        ckpt = CheckpointManager(exp, cfg.keep_nbest)
        aux = None
        if cfg.mbr.weight > 0 and cfg.model_arch == "asr":
            aux = make_mbr_aux_loss(
                model, cfg.mbr, mvn_stats=mvn_stats,
                kb_token_mask=cls._kb_token_mask(cfg, model_cfg.vocab_size))
        trainer = Trainer(
            model,
            make_train_step(model, tx, mvn_stats=mvn_stats,
                            grad_noise_eta=cfg.optim.grad_noise_eta,
                            ema_decay=cfg.optim.ema_decay,
                            spike_factor=cfg.optim.spike_factor,
                            aux_loss_fn=aux),
            make_eval_step(model, mvn_stats=mvn_stats), ckpt,
            TrainerOptions(max_epoch=cfg.max_epoch, patience=cfg.patience,
                           keep_nbest=cfg.keep_nbest,
                           nbest_average=cfg.nbest_average,
                           log_interval=cfg.log_interval,
                           resume=cfg.resume))
        # Batches are read, collated and sent to the device (pinned host
        # memory, non_blocking) two steps ahead on a producer thread.
        return trainer.run(
            state, lambda epoch: prefetch_to_device(train_if(epoch), dev),
            valid_if)


def pad_speech_batch(speeches: Sequence[np.ndarray], multiple: int = 4096):
    """(buf [bb, n, ...] float32, lens [bb] int32) padded as the reference
    pads: bb the next power of two (padding rows get length 1), n =
    bucket_length(longest, multiple); feature matrices [T, D] keep their
    trailing width."""
    b = len(speeches)
    bb = 1
    while bb < b:
        bb *= 2
    n = bucket_length(max(len(s) for s in speeches), multiple)
    buf = np.zeros((bb, n) + np.shape(speeches[0])[1:], np.float32)
    lens = np.ones((bb,), np.int32)
    for i, s in enumerate(speeches):
        buf[i, :len(s)] = s
        lens[i] = len(s)
    return buf, lens


class Speech2Text:
    """Batched ASR decoding with the attention decoder (greedy when
    ``beam_size <= 1``) or joint CTC/attention beam search.

    ``feats_type`` "ssl" (from_exp_dir passes the experiment's): the
    model's inputs are SSL dump matrices, decoded as given.
    ``mvn_stats``: (mean, inv_std) of a ``use_mvn: global`` model, as
    arrays or tensors; ``tokenizer``, when given, replaces the one built
    from ``token_type`` / ``bpemodel``. ``biasing_words`` (a ``use_tcpgen``
    model) builds the decode-time biasing trie from raw words (the fork's
    asr_recog.py --meetingKB) and the beam search mixes TCPGen's pointer
    in, p_gen scaled by ``tcpgen_smoothprob`` or pinned to
    ``tcpgen_force_p_gen``; greedy decoding ignores it, as the
    reference's.

    ``ctc_timesync`` decodes by the frame-synchronous CTC prefix beam
    (decode/timesync.py) and ``lattice`` by the CTC n-best lattice with
    rescoring (decode/lattice.py: the decoder at ``lattice_att_weight``,
    the LM and the n-gram at their current weights, read at every decode:
    the reference reads them once, queue 3). The time-synchronous decode
    fuses no LM, as the reference's, so a positive LM, n-gram or ILM weight
    raises with it rather than being dropped; either decode refuses
    ``biasing_words`` and ILM, which neither reference path reads, and the
    two refuse each other.

    Shallow fusion (the beam search only, reference tasks/asr.py:654-845):
    ``lm_exp_dir`` (a tasks/lm.py experiment, fused at ``lm_weight`` when
    it is > 0; its token list must be the ASR model's) and ``ngram_file``
    (an ARPA file or its ``.npz`` cache, decode/ngram.py, fused at
    ``ngram_weight`` when > 0; its ``<s>`` / ``</s>`` map to sos / eos).
    Each scorer is scaled by its own weight, read at every decode, and the
    beam adds their sum at weight 1. ``ilm_weight`` > 0 subtracts the
    internal LM (not under biasing). ``set_fusion_weights`` changes the
    weights between decodes; ``ilm_weight`` only with ``sweep_fusion`` or
    a positive ``ilm_weight`` at construction, as the reference's.
    """

    def __init__(self, cfg: ASRConfig, state_dict: Mapping[str, torch.Tensor],
                 token_list: Sequence[str], token_type: str = "char",
                 bpemodel: Optional[str] = None, max_len: int = 128,
                 beam_size: int = 1, ctc_weight: float = 0.0,
                 speech_bucket_multiple: int = 4096, device=None,
                 mvn_stats=None, tokenizer=None, biasing_words=None,
                 tcpgen_smoothprob: float = 1.0,
                 tcpgen_force_p_gen: Optional[float] = None,
                 lm_exp_dir: Optional[str] = None, lm_weight: float = 0.0,
                 ngram_file: Optional[str] = None,
                 ngram_weight: float = 0.0, ilm_weight: float = 0.0,
                 sweep_fusion: bool = False, ctc_timesync: bool = False,
                 lattice: bool = False, lattice_att_weight: float = 0.3,
                 feats_type: str = "raw"):
        self.model = ASRModel(cfg, device=device)
        self.feats_type = feats_type
        self.model.load_state_dict(state_dict)
        self.tokenizer = tokenizer or build_tokenizer(token_type, bpemodel)
        self.converter = TokenIDConverter(list(token_list))
        self.max_len = max_len
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.speech_bucket_multiple = speech_bucket_multiple
        self.mvn_stats = mvn_tensors(mvn_stats, self.model.device)
        self.task_cfg: Optional[ASRTaskConfig] = None
        self.biasing = None
        if biasing_words:
            self.biasing = self._biasing(biasing_words, tcpgen_smoothprob,
                                         tcpgen_force_p_gen)
        self.lm_weight, self.ngram_weight = lm_weight, ngram_weight
        self.ilm_weight = ilm_weight
        self._ilm_settable = sweep_fusion or ilm_weight > 0.0
        self.ctc_timesync, self.lattice = ctc_timesync, lattice
        self.lattice_att_weight = lattice_att_weight
        # (name of the weight attribute, lm_step, lm_init) per scorer; the
        # LM itself and the n-gram's (step, init) for the lattice
        self._scorers = []
        self._lm = self._ngram = None
        if lm_exp_dir and lm_weight > 0:
            lm, _, lm_conv = LMTask.load(lm_exp_dir, device=self.model.device)
            if lm_conv.token_list != self.converter.token_list:
                raise ValueError(
                    f"the LM of {lm_exp_dir} has a vocabulary of "
                    f"{lm_conv.vocab_size} tokens, the ASR model one of "
                    f"{len(self.converter.token_list)}: shallow fusion "
                    "needs the ASR model's token list")
            self._lm = lm
            self._scorers.append(("lm_weight",) + make_lm_fusion(lm,
                                                                 max_len))
        if ngram_file and ngram_weight > 0:
            tok2id = {tok: i for i, tok in
                      enumerate(self.converter.token_list)}
            tok2id.setdefault("<s>", cfg.sos_id)
            tok2id.setdefault("</s>", cfg.eos_id)
            self._ngram = make_ngram_fusion(
                ArpaLM(ngram_file, tok2id, cfg.vocab_size), cfg.sos_id,
                self.model.device)
            self._scorers.append(("ngram_weight",) + self._ngram)
        self._check_decode()

    def _check_decode(self) -> None:
        """Raises ValueError for options that the time-synchronous or the
        lattice decode would drop."""
        if not (self.ctc_timesync or self.lattice):
            return
        if self.ctc_timesync and self.lattice:
            raise ValueError("ctc_timesync and lattice are two decodes: "
                             "choose one")
        what = "ctc_timesync" if self.ctc_timesync else "lattice"
        dropped = [name for name, on in (
            ("biasing_words", self.biasing is not None),
            ("ilm_weight > 0", self.ilm_weight > 0),
            ("lm_weight > 0", self.ctc_timesync and self.lm_weight > 0),
            ("ngram_weight > 0", self.ctc_timesync and self.ngram_weight > 0)
        ) if on]
        if dropped:
            raise ValueError(f"{what} decodes without " + ", ".join(dropped)
                             + " (the reference drops them)")

    def set_fusion_weights(self, lm_weight=None, ngram_weight=None,
                           ilm_weight=None) -> None:
        """New fusion weights for the next decodes. ``ilm_weight`` needs
        ``sweep_fusion=True`` (or a positive ``ilm_weight``) at
        construction, as the reference's."""
        if lm_weight is not None:
            self.lm_weight = float(lm_weight)
        if ngram_weight is not None:
            self.ngram_weight = float(ngram_weight)
        if ilm_weight is not None:
            if not self._ilm_settable:
                raise ValueError("construct Speech2Text(sweep_fusion=True) "
                                 "to sweep ilm_weight")
            self.ilm_weight = float(ilm_weight)

    def _fusion(self):
        """(lm_step, lm_init) of the scorers, each row scaled by its
        current weight, or (None, None) without a scorer."""
        if not self._scorers:
            return None, None
        weights = [getattr(self, name) for name, _, _ in self._scorers]

        def lm_init(n):
            return [init(n) for _, _, init in self._scorers]

        def lm_step(y_prev, states):
            rows, new_states = [], []
            for w, (_, step, _), st in zip(weights, self._scorers, states):
                row, st = step(y_prev, st)
                rows.append(w * row)
                new_states.append(st)
            return sum(rows), new_states

        return lm_step, lm_init

    def _biasing(self, words: Sequence[str], smoothprob: float = 1.0,
                 force_p_gen: Optional[float] = None) -> Dict:
        """The beam search's ``biasing`` for ``words``: their pieces' trie
        (slu/kb.py:build_trie), the word-boundary tokens of the token list
        and their convention (slu/kb.py:boundary_token_ids)."""
        pieces = [self.converter.tokens2ids(self.tokenizer.text2tokens(w))
                  for w in words]
        t = build_trie(pieces)
        bset, prefix = boundary_token_ids(self.converter.token_list)
        boundary = torch.zeros(self.model.cfg.vocab_size + 1,
                               dtype=torch.bool)
        boundary[sorted(bset)] = True
        dev = self.model.device
        trie = {f"trie_{k}": torch.from_numpy(getattr(t, k)).to(dev)
                for k in ("token", "children_tok", "children_node",
                          "n_children")}
        return {"trie": trie, "boundary_mask": boundary.to(dev),
                "prefix_boundary": prefix, "dead": t.dead,
                "smoothprob": smoothprob, "force_p_gen": force_p_gen}

    @classmethod
    def from_exp_dir(cls, exp_dir: str, ckpt_name: Optional[str] = None,
                     max_len: int = 128, beam_size: int = 1,
                     ctc_weight: float = 0.0, device=None,
                     biasing_words=None, tcpgen_smoothprob: float = 1.0,
                     tcpgen_force_p_gen: Optional[float] = None,
                     lm_exp_dir: Optional[str] = None,
                     lm_weight: float = 0.0,
                     ngram_file: Optional[str] = None,
                     ngram_weight: float = 0.0, ilm_weight: float = 0.0,
                     sweep_fusion: bool = False, ctc_timesync: bool = False,
                     lattice: bool = False,
                     lattice_att_weight: float = 0.3) -> "Speech2Text":
        """An experiment directory of ``ASRTask.train`` (the reference's
        constructor): its config.yaml and tokens.txt, the checkpoint
        ``ckpt_name`` (default: the n-best average ``valid.*best`` if there
        is one, else the latest epoch) and the global MVN stats; the
        biasing, fusion and decode arguments as the constructor's. A
        MaskCTC experiment decodes with Speech2TextMaskCTC."""
        exp = Path(exp_dir)
        cfg = load_task_config(exp / "config.yaml")
        refuse_unported(cfg)
        if cfg.model_arch != "asr":
            raise ValueError(f"{exp_dir} is a model_arch {cfg.model_arch!r} "
                             "experiment: decode it with Speech2TextMaskCTC")
        tokenizer, converter, model_cfg = ASRTask.prepare_vocab(cfg)
        mgr = CheckpointManager(exp, cfg.keep_nbest)
        s2t = cls(model_cfg, mgr.load_params(ckpt_name), converter.token_list,
                  max_len=max_len, beam_size=beam_size,
                  ctc_weight=ctc_weight,
                  speech_bucket_multiple=cfg.data.speech_bucket_multiple,
                  device=device, mvn_stats=ASRTask.load_mvn_stats(
                      cfg, resolve_device(device)), tokenizer=tokenizer,
                  biasing_words=biasing_words,
                  tcpgen_smoothprob=tcpgen_smoothprob,
                  tcpgen_force_p_gen=tcpgen_force_p_gen,
                  lm_exp_dir=lm_exp_dir, lm_weight=lm_weight,
                  ngram_file=ngram_file, ngram_weight=ngram_weight,
                  ilm_weight=ilm_weight, sweep_fusion=sweep_fusion,
                  ctc_timesync=ctc_timesync, lattice=lattice,
                  lattice_att_weight=lattice_att_weight,
                  feats_type=cfg.data.feats_type)
        s2t.task_cfg = cfg
        return s2t

    def __call__(self, speech: np.ndarray) -> str:
        """Single utterance: [N] float waveform -> text."""
        return self.decode_batch([speech])[0]

    def pad_batch(self, speeches: Sequence[np.ndarray]):
        """(buf [bb, n] float32, lens [bb] int32): ``pad_speech_batch``."""
        return pad_speech_batch(speeches, self.speech_bucket_multiple)

    def wav_to_feats(self, wav: np.ndarray) -> np.ndarray:
        """[N] waveform -> [T, D] features as stage 3 dumps them (the
        model's frontend on its device), for an ``input_feats`` model."""
        dev = self.model.device
        x = torch.as_tensor(np.asarray(wav, np.float32), device=dev)[None]
        feats, flens = default_frontend(
            x, torch.tensor([len(wav)], device=dev), self.model.cfg.frontend)
        return feats[0, :int(flens[0])].cpu().numpy()

    @torch.inference_mode()
    def decode_batch(self, speeches: Sequence[np.ndarray]) -> List[str]:
        """List of [N_i] waveforms -> list of texts, in one batched search.
        A model on a feature dump (``input_feats``) decodes the waveforms'
        features (``wav_to_feats``), one on an SSL dump (``feats_type``
        "ssl") the dumped [T, D] / [T, L, D] matrices as given."""
        if self.model.cfg.input_feats:
            if self.feats_type == "ssl":
                if not all(np.ndim(s) >= 2 for s in speeches):
                    raise ValueError("a feats_type ssl model decodes the "
                                     "dumped feature matrices (bin/"
                                     "ssl_dump.py), not waveforms")
            else:
                speeches = [self.wav_to_feats(s) for s in speeches]
        buf, lens = self.pad_batch(speeches)
        dev = self.model.device
        hs, h_lengths = self.model.encode(torch.from_numpy(buf).to(dev),
                                          torch.from_numpy(lens).to(dev),
                                          self.mvn_stats)
        self._check_decode()  # the weights may have changed since
        if self.ctc_timesync:
            tokens, lengths = ctc_timesync_beam_search(
                self.model, hs, h_lengths,
                TimeSyncConfig(beam_size=self.beam_size,
                               max_len=self.max_len))
        elif self.lattice:
            tokens, lengths, _ = lattice_rescore_decode(
                self.model, hs, h_lengths,
                LatticeConfig(beam_size=self.beam_size, max_len=self.max_len,
                              att_weight=self.lattice_att_weight,
                              lm_weight=self.lm_weight,
                              ngram_weight=self.ngram_weight),
                lm_model=self._lm, ngram_step_init=self._ngram)
        elif self.beam_size <= 1:
            tokens, lengths = attention_greedy_decode(
                self.model, hs, h_lengths, self.max_len)
        else:
            lm_step, lm_init = self._fusion()
            tokens, lengths = batch_beam_search(
                self.model, hs, h_lengths,
                BeamSearchConfig(beam_size=self.beam_size,
                                 max_len=self.max_len,
                                 ctc_weight=self.ctc_weight,
                                 lm_weight=1.0 if lm_step else 0.0,
                                 ilm_weight=self.ilm_weight),
                lm_step=lm_step, lm_init=lm_init, biasing=self.biasing)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [self.tokenizer.tokens2text(
                    self.converter.ids2tokens(tokens[i, :lengths[i]]))
                for i in range(len(speeches))]


class Speech2TextMaskCTC:
    """Non-autoregressive mask-predict decoding of a ``model_arch: maskctc``
    experiment (models/maskctc.py:MaskCTCModel.decode: CTC greedy, then
    ``n_iterations`` refinement passes of the tokens below ``threshold``),
    batched and padded as Speech2Text pads."""

    def __init__(self, cfg: ASRConfig, state_dict: Mapping[str, torch.Tensor],
                 token_list: Sequence[str], token_type: str = "char",
                 bpemodel: Optional[str] = None, max_len: int = 128,
                 n_iterations: int = 4, threshold: float = 0.99,
                 speech_bucket_multiple: int = 4096, device=None,
                 mvn_stats=None, tokenizer=None):
        self.model = MaskCTCModel(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.tokenizer = tokenizer or build_tokenizer(token_type, bpemodel)
        self.converter = TokenIDConverter(list(token_list))
        self.max_len, self.n_iterations = max_len, n_iterations
        self.threshold = threshold
        self.speech_bucket_multiple = speech_bucket_multiple
        self.mvn_stats = mvn_tensors(mvn_stats, self.model.device)
        self.task_cfg: Optional[ASRTaskConfig] = None

    @classmethod
    def from_exp_dir(cls, exp_dir: str, ckpt_name: Optional[str] = None,
                     max_len: int = 128, n_iterations: int = 4,
                     threshold: float = 0.99,
                     device=None) -> "Speech2TextMaskCTC":
        """An experiment directory of ``ASRTask.train`` with ``model_arch:
        maskctc``: its config, tokens, the checkpoint ``ckpt_name``
        (default: the n-best average if there is one, else the latest
        epoch) and the global MVN stats."""
        exp = Path(exp_dir)
        cfg = load_task_config(exp / "config.yaml")
        refuse_unported(cfg)
        if cfg.model_arch != "maskctc":
            raise ValueError(f"{exp_dir} is a model_arch {cfg.model_arch!r} "
                             "experiment: decode it with Speech2Text")
        tokenizer, converter, model_cfg = ASRTask.prepare_vocab(cfg)
        mgr = CheckpointManager(exp, cfg.keep_nbest)
        s2t = cls(model_cfg, mgr.load_params(ckpt_name), converter.token_list,
                  max_len=max_len, n_iterations=n_iterations,
                  threshold=threshold,
                  speech_bucket_multiple=cfg.data.speech_bucket_multiple,
                  device=device, mvn_stats=ASRTask.load_mvn_stats(
                      cfg, resolve_device(device)), tokenizer=tokenizer)
        s2t.task_cfg = cfg
        return s2t

    def __call__(self, speech: np.ndarray) -> str:
        return self.decode_batch([speech])[0]

    @torch.inference_mode()
    def decode_batch(self, speeches: Sequence[np.ndarray]) -> List[str]:
        """List of [N_i] waveforms -> list of texts (blanks dropped)."""
        buf, lens = pad_speech_batch(speeches, self.speech_bucket_multiple)
        dev = self.model.device
        tokens, lengths = self.model.decode(
            torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev),
            max_len=self.max_len, n_iterations=self.n_iterations,
            threshold=self.threshold, mvn_stats=self.mvn_stats)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        out = []
        for i in range(len(speeches)):
            ids = tokens[i, :lengths[i]]
            ids = ids[ids != self.model.cfg.blank_id]
            out.append(self.tokenizer.tokens2text(
                self.converter.ids2tokens(ids)))
        return out
