"""SLU task: SLURP-style intent+entity prediction, optional two-pass.

Port of espnet_slurp_tpu/tasks/slu.py: ``SLUTaskConfig`` and
``load_slu_config`` (every field of the reference's), ``slu_batch``,
``SLUTask`` (the two vocabularies, the datasets, the bucketed batch
iterator, the BERT weight grafting and ``train``), ``Speech2Understand``
(speech [+ transcript] -> intent+entity text: an optional first pass
through Speech2Text, dialogue history, greedy decoding over the fused
memory) and ``_greedy_over_memory``.

As the reference's, the task tokenizes both streams by words
(``WordTokenizer``) whatever ``data.token_type`` says, and reads from the
data section only the directories, the batching and the seed. A
``postdecoder_hf_dir`` raises in ``SLUTask.train`` and
``Speech2Understand``: the reference feeds a pretrained BERT the task's own
word ids, not the ids of the checkpoint's WordPiece vocabulary (ROADMAP.md
queue 3); ``SLUTask.load_postdecoder_weights`` still grafts the weights.

Unlike the reference, the vocabulary reads the train text only when a
token list is missing from the experiment directory, so an experiment
decodes without its training data.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.collate import common_collate
from ..data.dataset import CommonPreprocessor, SpeechDataset
from ..data.fileio import read_2column_text
from ..data.prefetch import prefetch_to_device
from ..data.sampler import build_batches, bucket_length, epoch_shuffle
from ..data.tokenizer import TokenIDConverter, WordTokenizer, build_token_list
from ..decode.greedy import attention_greedy_decode
from ..models.asr_model import unported_options
from ..slu.model import SLUConfig, SLUModel
from ..train.checkpoint import CheckpointManager
from ..train.optim import OptimConfig, build_optimizer
from ..train.state import TrainState, make_eval_step, make_train_step
from ..train.trainer import Trainer, TrainerOptions
from ..utils.config import from_dict, load_yaml, merge_dicts, save_yaml
from ..utils.device import resolve_device
from .asr import ASRTask, DataConfig


@dataclasses.dataclass(frozen=True)
class SLUTaskConfig:
    exp_dir: str = "exp/slu"
    model: SLUConfig = SLUConfig()
    optim: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()
    max_epoch: int = 40
    patience: Optional[int] = None
    keep_nbest: int = 10
    nbest_average: int = 5
    log_interval: int = 50
    resume: bool = True


def load_slu_config(path=None, overrides=None) -> SLUTaskConfig:
    d = load_yaml(path) if path else {}
    if overrides:
        d = merge_dicts(d, overrides)
    return from_dict(SLUTaskConfig, d)


def refuse_unported_slu(cfg: SLUTaskConfig) -> None:
    """Raises for a model value that selects a path not ported yet, and for
    ``postdecoder_hf_dir`` (the pretrained BERT would read the task's word
    ids: ROADMAP.md queue 3)."""
    todo = unported_options(cfg.model.asr)
    if cfg.model.postdecoder_hf_dir:
        todo.append("model.postdecoder_hf_dir (the pretrained BERT reads the "
                    "task's word ids, not its WordPiece ids: ROADMAP.md "
                    "queue 3; the WordPiece tokenization: queue 1 item 19)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def slu_batch(uids, data) -> Dict[str, np.ndarray]:
    out = {
        "speech": data["speech"].astype(np.float32),
        "speech_lengths": data["speech_lengths"],
        "text": np.maximum(data["text"], 0).astype(np.int32),
        "text_lengths": data["text_lengths"],
    }
    if "transcript" in data:
        out["transcript"] = np.maximum(data["transcript"], 0).astype(np.int32)
        out["transcript_lengths"] = data["transcript_lengths"]
    return out


def _token_list(path: Path, texts, tokenizer) -> TokenIDConverter:
    """The converter of the list at ``path``, built from ``texts()`` and
    written there first when it is missing."""
    if path.exists():
        return TokenIDConverter(path)
    tl = build_token_list(texts().values(), tokenizer)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(tl) + "\n", encoding="utf-8")
    return TokenIDConverter(tl)


class SLUTask:
    @staticmethod
    def prepare_vocab(cfg: SLUTaskConfig):
        """SLU vocab: word tokenizer over intent+entity text; separate word
        vocab for the transcript stream (SLUPreprocessor semantics).
        Returns (tokenizer, converter, extra, resolved SLUConfig)."""
        data, exp = cfg.data, Path(cfg.exp_dir)
        tokenizer = WordTokenizer()
        conv = _token_list(exp / "tokens.txt", lambda: read_2column_text(
            Path(data.train_dir) / "text"), tokenizer)
        extra, t_conv = {}, None
        if cfg.model.two_pass:
            t_conv = _token_list(
                exp / "transcript_tokens.txt", lambda: read_2column_text(
                    Path(data.train_dir) / "transcript"), tokenizer)
            extra["transcript"] = (WordTokenizer(), t_conv)
        asr_cfg = dataclasses.replace(cfg.model.asr,
                                      vocab_size=conv.vocab_size)
        model_cfg = dataclasses.replace(
            cfg.model, asr=asr_cfg,
            transcript_vocab_size=t_conv.vocab_size if t_conv else 0)
        return tokenizer, conv, extra, model_cfg

    @staticmethod
    def build_dataset(cfg: SLUTaskConfig, data_dir: str, tokenizer, conv,
                      extra) -> SpeechDataset:
        pre = CommonPreprocessor(tokenizer, conv, extra=extra)
        streams = [(str(Path(data_dir) / "wav.scp"), "speech", "sound"),
                   (str(Path(data_dir) / "text"), "text", "text")]
        if cfg.model.two_pass:
            streams.append(
                (str(Path(data_dir) / "transcript"), "transcript", "text"))
        return SpeechDataset(streams, preprocess=pre)

    @classmethod
    def build_iter_factory(cls, cfg: SLUTaskConfig, dataset, shuffle=True):
        """epoch -> iterator of numpy batches (``slu_batch``): batches by
        the speech lengths alone, as the reference's (read from the wav
        headers, the decoded lengths), bucketed padding of the speech, text
        and transcript streams."""
        data = cfg.data
        sound = dataset.loaders["speech"]
        shapes = {uid: (sound.shape(uid),) for uid in dataset.keys}
        batches = build_batches([shapes], batch_type=data.batch_type,
                                batch_size=data.batch_size,
                                batch_bins=data.batch_bins)
        buckets = {"speech": data.speech_bucket_multiple,
                   "text": data.text_bucket_multiple,
                   "transcript": data.text_bucket_multiple}

        def factory(epoch):
            bs = epoch_shuffle(batches, data.seed, epoch) if shuffle \
                else batches
            for utts in bs:
                items = [dataset[u] for u in utts]
                uids, coll = common_collate(items, bucket_multiples=buckets)
                yield slu_batch(uids, coll)

        return factory

    @staticmethod
    def load_postdecoder_weights(model: SLUModel, model_cfg: SLUConfig,
                                 ) -> SLUModel:
        """Grafts a local HF BERT checkpoint (``postdecoder_hf_dir``) into
        the postdecoder's ``bert`` module, byte for byte; a model without
        one is returned as it is."""
        if model_cfg.postdecoder != "bert" or not model_cfg.postdecoder_hf_dir:
            return model
        from ..models.hf_transformer import load_bert_from_dir
        _, sd = load_bert_from_dir(model_cfg.postdecoder_hf_dir,
                                   device=model.device)
        model.text_encoder.bert.load_state_dict(sd)
        return model

    @classmethod
    def train(cls, cfg: SLUTaskConfig, device=None) -> TrainState:
        """Trains on ``device`` (the card unless given, e.g. "cpu"):
        config.yaml, tokens.txt and transcript_tokens.txt into exp_dir,
        the reference's initialisation from ``data.seed``, then the Trainer
        with its checkpoints and n-best average. Returns the final
        TrainState."""
        refuse_unported_slu(cfg)
        dev = resolve_device(device)
        exp = Path(cfg.exp_dir)
        exp.mkdir(parents=True, exist_ok=True)
        tokenizer, conv, extra, model_cfg = cls.prepare_vocab(cfg)
        save_yaml(dataclasses.replace(cfg, model=model_cfg),
                  exp / "config.yaml")
        model = SLUModel(model_cfg, device=dev)
        ASRTask.init_params(model, cfg.data.seed)

        train_ds, valid_ds = (
            cls.build_dataset(cfg, d, tokenizer, conv, extra)
            for d in (cfg.data.train_dir, cfg.data.valid_dir))
        tx = build_optimizer(cfg.optim)
        state = TrainState.create(model, tx, seed=cfg.data.seed,
                                  ema=cfg.optim.ema_decay > 0)
        ckpt = CheckpointManager(exp, cfg.keep_nbest)
        trainer = Trainer(
            model,
            make_train_step(model, tx, grad_noise_eta=cfg.optim.grad_noise_eta,
                            ema_decay=cfg.optim.ema_decay),
            make_eval_step(model), ckpt,
            TrainerOptions(max_epoch=cfg.max_epoch, patience=cfg.patience,
                           keep_nbest=cfg.keep_nbest,
                           nbest_average=cfg.nbest_average,
                           log_interval=cfg.log_interval, resume=cfg.resume))
        train_if = cls.build_iter_factory(cfg, train_ds, shuffle=True)
        valid_if = cls.build_iter_factory(cfg, valid_ds, shuffle=False)
        return trainer.run(
            state, lambda epoch: prefetch_to_device(train_if(epoch), dev),
            valid_if)


class Speech2Understand:
    """Inference: speech [+ transcript] -> intent+entity text, greedy over
    the fused memory, on ``device`` (the card unless ``device="cpu"``).

    With ``asr_exp_dir`` a Speech2Text of that experiment (beam
    ``asr_beam_size``) supplies the transcript when none is given (the full
    two-pass loop); with ``use_history`` the previous turns' decoded text
    rolls into the transcript stream (at most ``history_max_words`` words);
    ``reset_history`` clears it at a dialogue boundary."""

    def __init__(self, exp_dir: str, ckpt_name: Optional[str] = None,
                 max_len: int = 64, asr_exp_dir: Optional[str] = None,
                 asr_beam_size: int = 5, use_history: bool = False,
                 history_max_words: int = 48, device=None):
        exp = Path(exp_dir)
        self.cfg = load_slu_config(exp / "config.yaml")
        refuse_unported_slu(self.cfg)
        tok, conv, extra, model_cfg = SLUTask.prepare_vocab(self.cfg)
        self.tokenizer, self.converter = tok, conv
        self.extra = extra
        self.model = SLUModel(model_cfg, device=device)
        mgr = CheckpointManager(exp, self.cfg.keep_nbest)
        self.model.load_state_dict(mgr.load_params(ckpt_name))
        self.max_len = max_len
        self.first_pass = None
        if asr_exp_dir is not None:
            from .asr import Speech2Text
            self.first_pass = Speech2Text.from_exp_dir(
                asr_exp_dir, beam_size=asr_beam_size, device=device)
        self.use_history = use_history
        self.history_max_words = history_max_words
        self._history = ""

    def reset_history(self):
        self._history = ""

    @torch.inference_mode()
    def __call__(self, speech: np.ndarray,
                 transcript: Optional[str] = None) -> str:
        cfg, dev = self.cfg, self.model.device
        n = bucket_length(len(speech), cfg.data.speech_bucket_multiple)
        buf = np.zeros((1, n), np.float32)
        buf[0, :len(speech)] = speech
        kwargs = {"speech": torch.from_numpy(buf).to(dev),
                  "speech_lengths": torch.tensor([len(speech)],
                                                 dtype=torch.int32,
                                                 device=dev)}
        two_pass = cfg.model.two_pass
        if two_pass and transcript is None and self.first_pass is not None:
            transcript = self.first_pass(speech)
        if two_pass and transcript is not None and self.use_history \
                and self._history:
            words = (self._history + " " + transcript).split()
            transcript = " ".join(words[-self.history_max_words:])
        if two_pass and transcript is not None:
            wt, wconv = self.extra["transcript"]
            ids = wconv.tokens2ids(wt.text2tokens(transcript))
            tbuf = np.zeros((1, bucket_length(max(len(ids), 1), 8)),
                            np.int32)
            tbuf[0, :len(ids)] = ids
            kwargs["transcript"] = torch.from_numpy(tbuf).to(dev)
            kwargs["transcript_lengths"] = torch.tensor(
                [len(ids)], dtype=torch.int32, device=dev)
        memory, mem_mask = self.model.encode(**kwargs)
        tokens, lengths = _greedy_over_memory(self.model, memory, mem_mask,
                                              self.max_len)
        ids = tokens[0, :int(lengths[0])].cpu().numpy()
        out = self.tokenizer.tokens2text(self.converter.ids2tokens(ids))
        if self.use_history:
            # the decoded turn rolls into the context
            self._history = (self._history + " " + out).strip()
        return out


def _greedy_over_memory(model: SLUModel, memory: torch.Tensor,
                        mem_mask: torch.Tensor, max_len: int):
    """Greedy decode with an explicit memory mask (the SLU fused memory):
    -> (tokens [B, max_len] eos-padded, lengths [B]); one host sync a step
    (decode/greedy.py)."""
    return attention_greedy_decode(model.asr, memory, None, max_len,
                                   memory_mask=mem_mask)
