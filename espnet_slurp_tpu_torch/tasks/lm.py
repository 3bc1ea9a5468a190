"""LM task: train a Transformer / LSTM LM on text; perplexity; the LM as a
shallow-fusion scorer of the beam search.

Port of espnet_slurp_tpu/tasks/lm.py (``LMDataConfig``, ``LMTaskConfig``,
``load_lm_config``, ``build_lm``, ``LMTask`` and ``make_lm_fusion``).
Batches are the reference's: the input sos-prefixed, the target
eos-suffixed (one ``sos_eos`` id, the last of the token list), lengths
padded to a multiple of 8, targets padded with 0. Parameters start from the
reference's flax initializers (tasks/asr.py:ASRTask.init_params, seeded by
``data.seed``); the step is the reference's: forward, masked NLL, backward,
the optimizer (train/optim.py), no non-finite skip. Checkpoints are the
port's ``torch.save`` format (train/checkpoint.py). Training and perplexity
run on the card unless the caller passes ``device`` (e.g. "cpu").
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from ..data.fileio import read_2column_text
from ..data.tokenizer import TokenIDConverter, build_token_list, build_tokenizer
from ..models.lm import LMConfig, LSTMLM, TransformerLM, lm_loss
from ..train.checkpoint import CheckpointManager
from ..train.optim import OptimConfig, Optimizer, build_optimizer, flatten
from ..train.reporter import Reporter, SubReporter
from ..train.state import TrainState
from ..utils.config import from_dict, load_yaml, merge_dicts, save_yaml
from ..utils.device import resolve_device

log = logging.getLogger("espnet_slurp_tpu_torch")


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    train_text: str = ""
    valid_text: str = ""
    token_type: str = "char"
    bpemodel: Optional[str] = None
    bpe_marker: str = "prefix"
    batch_size: int = 32
    max_len: int = 128
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LMTaskConfig:
    exp_dir: str = "exp/lm"
    model: LMConfig = LMConfig()
    optim: OptimConfig = OptimConfig()
    data: LMDataConfig = LMDataConfig()
    max_epoch: int = 20
    keep_nbest: int = 5
    log_interval: int = 100
    resume: bool = True


def load_lm_config(path=None, overrides=None) -> LMTaskConfig:
    d = load_yaml(path) if path else {}
    if overrides:
        d = merge_dicts(d, overrides)
    return from_dict(LMTaskConfig, d)


def build_lm(cfg: LMConfig, device=None) -> nn.Module:
    return TransformerLM(cfg, device) if cfg.arch == "transformer" \
        else LSTMLM(cfg, device)


def make_lm_train_step(model: nn.Module, tx: Optimizer) -> Callable:
    """(state, batch) -> (state, {"loss", "ppl"}): the reference's LM step
    (forward, lm_loss, backward, the optimizer's update in place)."""
    params = [p for p in model.parameters() if p.requires_grad]
    sizes = [p.numel() for p in params]

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        for p in params:
            p.grad = None
        logits = model(batch["ys"], batch["ys_lengths"])
        loss, ppl, _ = lm_loss(logits, batch["targets"], batch["ys_lengths"])
        loss.backward()
        with torch.no_grad():
            grad = flatten([torch.zeros_like(p) if p.grad is None else p.grad
                            for p in params])
            update, opt = tx.update(grad, torch.linalg.vector_norm(grad),
                                    state.opt_state, params)
            torch._foreach_add_(params, [u.view_as(p) for u, p in
                                         zip(update.split(sizes), params)])
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt), \
            {"loss": loss.detach(), "ppl": ppl.detach()}

    return step_fn


class LMTask:
    @staticmethod
    def prepare_vocab(cfg: LMTaskConfig):
        """(tokenizer, converter, model config with the vocabulary's size):
        exp_dir/tokens.txt if it exists, else the token list of the train
        text, written there."""
        exp = Path(cfg.exp_dir)
        tokenizer = build_tokenizer(cfg.data.token_type,
                                    bpemodel=cfg.data.bpemodel,
                                    bpe_marker=cfg.data.bpe_marker)
        tl_path = exp / "tokens.txt"
        if tl_path.exists():
            conv = TokenIDConverter(tl_path)
        else:
            texts = read_2column_text(cfg.data.train_text)
            tl = build_token_list(texts.values(), tokenizer)
            tl_path.parent.mkdir(parents=True, exist_ok=True)
            tl_path.write_text("\n".join(tl) + "\n", encoding="utf-8")
            conv = TokenIDConverter(tl)
        model_cfg = dataclasses.replace(cfg.model,
                                        vocab_size=conv.vocab_size)
        return tokenizer, conv, model_cfg

    @staticmethod
    def batches(text_path, tokenizer, conv, cfg: LMTaskConfig, epoch: int,
                shuffle: bool, device=None) -> Iterator[Dict[str,
                                                             torch.Tensor]]:
        """{ys, targets, ys_lengths} long tensors on ``device`` (the CPU
        unless given): [sos, tokens...] and [tokens..., eos], the epoch's
        shuffle from RandomState(seed + epoch) (espnet2/lm/espnet_model.py
        semantics)."""
        texts = read_2column_text(text_path)
        sos_eos = conv.vocab_size - 1
        seqs = []
        for line in texts.values():
            ids = conv.tokens2ids(tokenizer.text2tokens(line))
            seqs.append(ids[:cfg.data.max_len - 1])
        order = np.arange(len(seqs))
        if shuffle:
            np.random.RandomState(cfg.data.seed + epoch).shuffle(order)
        bs = cfg.data.batch_size
        dev = torch.device(device or "cpu")
        for i in range(0, len(order), bs):
            chunk = [seqs[j] for j in order[i:i + bs]]
            maxlen = max(len(s) + 1 for s in chunk)
            maxlen = ((maxlen + 7) // 8) * 8
            ys = np.full((len(chunk), maxlen), sos_eos, np.int64)
            tgt = np.zeros((len(chunk), maxlen), np.int64)
            lens = np.zeros((len(chunk),), np.int64)
            for r, s in enumerate(chunk):
                ys[r, 1:1 + len(s)] = s
                tgt[r, :len(s)] = s
                tgt[r, len(s)] = sos_eos
                lens[r] = len(s) + 1
            yield {k: torch.from_numpy(v).to(dev) for k, v in
                   (("ys", ys), ("targets", tgt), ("ys_lengths", lens))}

    @staticmethod
    def init_model(model_cfg: LMConfig, seed: int, device=None) -> nn.Module:
        """The LM with the reference's initial distributions (flax's Dense,
        Embed, LayerNorm and OptimizedLSTMCell initializers)."""
        from .asr import ASRTask
        return ASRTask.init_params(build_lm(model_cfg, device), seed)

    @classmethod
    def train(cls, cfg: LMTaskConfig, device=None) -> nn.Module:
        """Trains on ``device`` (the card unless given): config.yaml and
        tokens.txt into exp_dir, an epoch checkpoint each epoch (resuming
        from the latest with ``resume``), reporter.json. Returns the
        model."""
        dev = resolve_device(device)
        exp = Path(cfg.exp_dir)
        exp.mkdir(parents=True, exist_ok=True)
        tokenizer, conv, model_cfg = cls.prepare_vocab(cfg)
        save_yaml(dataclasses.replace(cfg, model=model_cfg),
                  exp / "config.yaml")
        model = cls.init_model(model_cfg, cfg.data.seed, dev)
        tx = build_optimizer(cfg.optim)
        state = TrainState.create(model, tx, seed=cfg.data.seed)
        train_step = make_lm_train_step(model, tx)
        ckpt = CheckpointManager(exp, cfg.keep_nbest)
        reporter = Reporter()
        start = 1
        if cfg.resume and ckpt.latest_epoch() is not None:
            state = ckpt.restore(ckpt.latest_epoch(), model, state)
            reporter = ckpt.load_reporter()
            start = ckpt.latest_epoch() + 1
        for epoch in range(start, cfg.max_epoch + 1):
            sub = SubReporter()
            model.train()
            for batch in cls.batches(cfg.data.train_text, tokenizer, conv,
                                     cfg, epoch, True, dev):
                state, stats = train_step(state, batch)
                sub.register(stats)
            reporter.observe(epoch, "train", sub.mean())
            sub = SubReporter()
            model.eval()
            with torch.no_grad():
                for batch in cls.batches(cfg.data.valid_text, tokenizer,
                                         conv, cfg, epoch, False, dev):
                    logits = model(batch["ys"], batch["ys_lengths"])
                    loss, ppl, _ = lm_loss(logits, batch["targets"],
                                           batch["ys_lengths"])
                    sub.register({"loss": loss, "ppl": ppl})
            reporter.observe(epoch, "valid", sub.mean())
            log.info(reporter.log_line(epoch))
            ckpt.save_epoch(epoch, model, state, reporter)
        return model

    @classmethod
    def load(cls, exp_dir: str, ckpt_name: Optional[str] = None,
             device=None):
        """(model, tokenizer, converter) of a trained LM exp dir: its
        config.yaml and tokens.txt, the checkpoint ``ckpt_name`` (default:
        the latest epoch), on ``device`` (the card unless given)."""
        exp = Path(exp_dir)
        cfg = load_lm_config(exp / "config.yaml")
        tokenizer, conv, model_cfg = cls.prepare_vocab(
            dataclasses.replace(cfg, exp_dir=str(exp)))
        model = build_lm(model_cfg, device)
        mgr = CheckpointManager(exp, cfg.keep_nbest)
        model.load_state_dict(mgr.load_params(
            ckpt_name or f"{mgr.latest_epoch()}epoch"))
        return model.eval(), tokenizer, conv

    @classmethod
    @torch.no_grad()
    def perplexity(cls, exp_dir: str, text_path: str,
                   ckpt_name: Optional[str] = None, device=None) -> float:
        """exp(token-weighted mean NLL) of ``text_path`` under the LM of
        ``exp_dir`` (lm_calc_perplexity.py)."""
        dev = resolve_device(device)
        model, tokenizer, conv = cls.load(exp_dir, ckpt_name, dev)
        cfg = load_lm_config(Path(exp_dir) / "config.yaml")
        total_nll, total_n = 0.0, 0
        for batch in cls.batches(text_path, tokenizer, conv, cfg, 1, False,
                                 dev):
            logits = model(batch["ys"], batch["ys_lengths"])
            loss, _, n = lm_loss(logits, batch["targets"],
                                 batch["ys_lengths"])
            total_nll += float(loss) * int(n)
            total_n += int(n)
        return float(np.exp(total_nll / max(total_n, 1)))


def make_lm_fusion(model: nn.Module, max_len: int):
    """(lm_step, lm_init) hooks of decode/beam.py's shallow fusion:
    lm_step(y_prev [N], state) -> (fp32 log-probs [N, V], state). A
    Transformer LM's cache holds ``max_len`` positions (the beam's
    max_len). The reference's ``params`` and unused ``batch_size``
    arguments are gone: the model holds its parameters."""
    if isinstance(model, TransformerLM):
        def lm_init(n):
            return model.init_cache(n, max_len)
    else:
        def lm_init(n):
            return model.init_carry(n)

    @torch.inference_mode()
    def lm_step(y_prev, state):
        logits, state = model.step(y_prev, state)
        return torch.log_softmax(logits.float(), dim=-1), state

    return lm_step, lm_init
