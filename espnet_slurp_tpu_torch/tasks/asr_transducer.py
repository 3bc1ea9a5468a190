"""Transducer ASR task. Port of espnet_slurp_tpu/tasks/asr_transducer.py.

``TransducerTaskConfig`` / ``load_transducer_config`` (the reference's
fields and YAML layout: ``model`` is a TransducerConfig with the ASR stack
under ``model.asr``), ``ASRTransducerTask.train`` (the ASR task's
vocabulary and data pipeline, TransducerModel, the Trainer with its
checkpoints) and ``Speech2TextTransducer``: greedy or one of the beam
searches of decode/transducer_beam.py, built from a config and a
state_dict, or from an experiment directory (``from_exp_dir``). It pads as
the port's Speech2Text does (tasks/asr.py:pad_speech_batch).

Config values that select paths not ported yet raise, naming their
ROADMAP.md queue 1 item: those of tasks/asr.py:refuse_unported.
``model.use_tcpgen`` raises too (ROADMAP.md queue 3): the reference's task
attaches no tries and creates no TCPGen parameters, so under that flag it
trains a plain transducer. The reference's transducer builds its
encoder from seven ASRConfig fields (models/transducer.py:112-115) and
reads its features through the frontend, so the encoder options it
ignores (MoE, interCTC, self-conditioning, stochastic depth, remat,
``input_layer``, the encoder choice, the pre- and post-encoder, the
attention decoder's choice) and feature dumps raise here too
(ROADMAP.md queue 3): a transducer with an MoE encoder would train
without its aux loss, which the reference does not do either. The
frontend's ``type`` and deltas, which its frontend reads, are taken.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.prefetch import prefetch_to_device
from ..data.tokenizer import TokenIDConverter, build_tokenizer
from ..decode.transducer_beam import SEARCHES, run_search
from ..models.asr_model import ASRConfig
from ..models.transducer import TransducerConfig, TransducerModel
from ..train.checkpoint import CheckpointManager
from ..train.optim import OptimConfig, build_optimizer
from ..train.state import TrainState, make_eval_step, make_train_step
from ..train.trainer import Trainer, TrainerOptions
from ..utils.config import from_dict, load_yaml, merge_dicts, save_yaml
from ..utils.device import resolve_device
from .asr import (ASRTask, ASRTaskConfig, DataConfig, pad_speech_batch,
                  refuse_unported)


@dataclasses.dataclass(frozen=True)
class TransducerTaskConfig:
    exp_dir: str = "exp/transducer"
    model: TransducerConfig = TransducerConfig()
    optim: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()
    max_epoch: int = 40
    patience: Optional[int] = None
    keep_nbest: int = 10
    nbest_average: int = 5
    log_interval: int = 50
    resume: bool = True


def load_transducer_config(path=None, overrides=None) -> TransducerTaskConfig:
    d = load_yaml(path) if path else {}
    if overrides:
        d = merge_dicts(d, overrides)
    return from_dict(TransducerTaskConfig, d)


def _as_asr_cfg(cfg: TransducerTaskConfig) -> ASRTaskConfig:
    """The ASR task config that shares cfg's vocabulary and data."""
    return ASRTaskConfig(exp_dir=cfg.exp_dir, model=cfg.model.asr,
                         optim=cfg.optim, data=cfg.data,
                         max_epoch=cfg.max_epoch, keep_nbest=cfg.keep_nbest)


def _encoder_options_the_reference_ignores(cfg: TransducerTaskConfig
                                           ) -> List[str]:
    a, d = cfg.model.asr, ASRConfig()
    fields = ("encoder", "moe_experts", "interctc_layers", "interctc_weight",
              "self_conditioning", "stochastic_depth_rate", "remat_encoder",
              "input_layer", "input_feats", "ssl_num_layers", "preencoder",
              "postencoder", "decoder", "wav2vec2")
    out = [f"model.asr.{f}" for f in fields
           if getattr(a, f) != getattr(d, f)]
    if cfg.data.feats_type != "raw":
        out.append("data.feats_type")
    return out


def refuse_unported_transducer(cfg: TransducerTaskConfig) -> None:
    """Raises for a config value that selects a path not ported yet, or an
    encoder option that the reference's transducer ignores."""
    if cfg.model.use_tcpgen:
        # models/transducer.py builds the KB-aware loss; the reference's
        # task would train a plain transducer under this flag.
        raise NotImplementedError(
            "model.use_tcpgen: the reference's ASRTransducerTask attaches "
            "no tries and creates no TCPGen parameters, so it trains a "
            "plain transducer under this flag; the port's task refuses it "
            "(ROADMAP.md queue 3, the transducer's TCPGen). Train the "
            "KB-aware loss through models/transducer.py:TransducerModel "
            "with a biasing batch (slu/kb.py:TCPGenBatchAugmenter)")
    ignored = _encoder_options_the_reference_ignores(cfg)
    if ignored:
        raise NotImplementedError(
            "the transducer takes no " + ", ".join(ignored) + ": the "
            "reference's transducer builds its encoder from seven fields "
            "and its frontend, and ignores these (ROADMAP.md queue 3, the "
            "transducer's refusals)")
    refuse_unported(_as_asr_cfg(cfg))


class ASRTransducerTask:
    """Trains a TransducerModel from a TransducerTaskConfig."""

    init_params = staticmethod(ASRTask.init_params)

    @classmethod
    def train(cls, cfg: TransducerTaskConfig, device=None) -> TrainState:
        """Trains on ``device`` (the card unless given, e.g. "cpu"):
        config.yaml and tokens.txt into exp_dir, then the Trainer (resuming
        from latest.json when there is one). Returns the final TrainState;
        the model's parameters are those of the last epoch."""
        refuse_unported_transducer(cfg)
        dev = resolve_device(device)
        exp = Path(cfg.exp_dir)
        exp.mkdir(parents=True, exist_ok=True)
        asr_like = _as_asr_cfg(cfg)
        tokenizer, converter, asr_model_cfg = ASRTask.prepare_vocab(asr_like)
        model_cfg = dataclasses.replace(cfg.model, asr=asr_model_cfg)
        save_yaml(dataclasses.replace(cfg, model=model_cfg),
                  exp / "config.yaml")
        model = TransducerModel(model_cfg, device=dev)
        cls.init_params(model, cfg.data.seed)
        train_ds, valid_ds = (ASRTask.build_dataset(d, tokenizer, converter)
                              for d in (cfg.data.train_dir,
                                        cfg.data.valid_dir))
        train_if = ASRTask.build_iter_factory(asr_like, train_ds,
                                              shuffle=True)
        valid_if = ASRTask.build_iter_factory(asr_like, valid_ds,
                                              shuffle=False)
        tx = build_optimizer(cfg.optim)
        state = TrainState.create(model, tx, seed=cfg.data.seed,
                                  ema=cfg.optim.ema_decay > 0)
        trainer = Trainer(
            model,
            make_train_step(model, tx, grad_noise_eta=cfg.optim.grad_noise_eta,
                            ema_decay=cfg.optim.ema_decay),
            make_eval_step(model), CheckpointManager(exp, cfg.keep_nbest),
            TrainerOptions(max_epoch=cfg.max_epoch, patience=cfg.patience,
                           keep_nbest=cfg.keep_nbest,
                           nbest_average=cfg.nbest_average,
                           log_interval=cfg.log_interval, resume=cfg.resume))
        return trainer.run(
            state, lambda epoch: prefetch_to_device(train_if(epoch), dev),
            valid_if)


class Speech2TextTransducer:
    """Batched transducer decoding: ``search`` is one of greedy | alsa |
    default | maes | tsd | nsc (decode/transducer_beam.py); greedy whenever
    ``beam_size <= 1``. ``tokenizer``, when given, replaces the one built
    from ``token_type`` / ``bpemodel``."""

    def __init__(self, cfg: TransducerConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 token_list: Sequence[str], token_type: str = "char",
                 bpemodel: Optional[str] = None, max_len: int = 128,
                 beam_size: int = 1, speech_bucket_multiple: int = 4096,
                 device=None, search: str = "alsa", tokenizer=None):
        if search not in SEARCHES:
            raise ValueError(f"search {search!r}: one of {SEARCHES}")
        self.model = TransducerModel(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.tokenizer = tokenizer or build_tokenizer(token_type, bpemodel)
        self.converter = TokenIDConverter(list(token_list))
        self.max_len = max_len
        self.beam_size = beam_size
        self.search = search
        self.speech_bucket_multiple = speech_bucket_multiple
        self.task_cfg: Optional[TransducerTaskConfig] = None

    @classmethod
    def from_exp_dir(cls, exp_dir: str, ckpt_name: Optional[str] = None,
                     beam_size: int = 1, max_len: int = 128,
                     search: str = "alsa",
                     device=None) -> "Speech2TextTransducer":
        """An experiment directory of ``ASRTransducerTask.train``: its
        config.yaml and tokens.txt and the checkpoint ``ckpt_name``
        (default: the n-best average ``valid.*best`` if there is one, else
        the latest epoch)."""
        exp = Path(exp_dir)
        cfg = load_transducer_config(exp / "config.yaml")
        refuse_unported_transducer(cfg)
        asr_like = dataclasses.replace(_as_asr_cfg(cfg), exp_dir=str(exp))
        tokenizer, converter, asr_model_cfg = ASRTask.prepare_vocab(asr_like)
        mgr = CheckpointManager(exp, cfg.keep_nbest)
        s2t = cls(dataclasses.replace(cfg.model, asr=asr_model_cfg),
                  mgr.load_params(ckpt_name), converter.token_list,
                  max_len=max_len, beam_size=beam_size,
                  speech_bucket_multiple=cfg.data.speech_bucket_multiple,
                  device=device, search=search, tokenizer=tokenizer)
        s2t.task_cfg = cfg
        return s2t

    def __call__(self, speech: np.ndarray) -> str:
        """Single utterance: [N] float waveform -> text."""
        return self.decode_batch([speech])[0]

    def pad_batch(self, speeches: Sequence[np.ndarray]):
        return pad_speech_batch(speeches, self.speech_bucket_multiple)

    @torch.inference_mode()
    def encode_batch(self, speeches: Sequence[np.ndarray]):
        """(hs [bb, T', D], h_lengths [bb]) of the padded batch."""
        buf, lens = self.pad_batch(speeches)
        dev = self.model.device
        return self.model.encode(torch.from_numpy(buf).to(dev),
                                 torch.from_numpy(lens).to(dev))

    @torch.inference_mode()
    def decode_batch(self, speeches: Sequence[np.ndarray]) -> List[str]:
        """List of [N_i] waveforms -> list of texts, in one batched
        decode."""
        hs, h_lengths = self.encode_batch(speeches)
        tokens, lengths = run_search(self.model, hs, h_lengths, self.search,
                                     self.beam_size, self.max_len)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [self.tokenizer.tokens2text(
                    self.converter.ids2tokens(tokens[i, :lengths[i]]))
                for i in range(len(speeches))]
