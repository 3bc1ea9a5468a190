"""Staged ASR recipe pipeline, the asr.sh analogue. Port of
espnet_slurp_tpu/recipe/asr_pipeline.py.

The reference's stage numbers:

  1  data validation            (wav.scp / text agree)
  2  speed perturbation         (resample_sinc copies, e.g. x0.9/1.0/1.1)
  3  feature dump               (feats_type fbank: the frontend on the
                                 device, .npy per utterance + feats.scp;
                                 fbank_pitch: not ported yet, raises)
  4  length filtering           (min / max audio seconds)
  5  token list / BPE training
  7  LM training, 8 perplexity  (train_lm: tasks/lm.py on the train text,
                                 on the device; perplexity of the valid
                                 text into results["lm_ppl"])
  9  n-gram training            (train_ngram: decode/ngram_train.py over
                                 the decode token units, then the .npz
                                 cache that stage 12 fuses at
                                 ngram_weight)
  10 collect-stats              (global MVN stats, on the device)
  11 ASR training               (ASRTask.train)
  12 decoding                   (Speech2Text.from_exp_dir, length-sorted
                                 batches; the stage-9 n-gram fused; the
                                 stage-7 LM is not, as in the reference)
  13 scoring (WER / CER)
  14 pack                       (model.zip: what from_exp_dir needs)
  15 unpack + verify            (the unpacked dir decodes as exp_dir does)

``publish`` / ``fetch`` keep a local model registry (a directory with an
index of sha256 digests), with no network, as the reference's do. The
stages that need the card (3, 7-8, 10-12 and 15) run on ``device``: the
card unless the caller passes e.g. "cpu"; with no card and no device the
pipeline raises before any stage runs. A stage never skips on an error.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.fileio import (DatadirWriter, load_wav, read_2column_text,
                           write_wav)
from ..ops.frontend import default_frontend, feature_dim
from ..ops.resample import speed_perturb
from ..tasks.asr import ASRTask, ASRTaskConfig, Speech2Text, load_task_config
from ..utils.config import save_yaml
from ..utils.device import resolve_device
from ..utils.metrics import error_rate

log = logging.getLogger("espnet_slurp_tpu_torch")


@dataclasses.dataclass
class PipelineOptions:
    speed_perturb_factors: tuple = ()  # e.g. (0.9, 1.0, 1.1)
    # "raw" | "fbank" | "fbank_pitch" (asr.sh feats_type): fbank_pitch
    # raises at stage 3.
    feats_type: str = "raw"
    min_audio_sec: float = 0.05
    max_audio_sec: float = 30.0
    fs: int = 16000
    # Stages 7-8: train a small Transformer LM on the train text and
    # report its validation perplexity.
    train_lm: bool = False
    # Stage 9 (asr.sh's n-gram stage): an ARPA n-gram over the decode token
    # units (decode/ngram_train.py) + its binary cache, fused at decode.
    train_ngram: bool = False
    ngram_order: int = 3
    ngram_weight: float = 0.3
    decode_beam_size: int = 5
    decode_ctc_weight: float = 0.3
    decode_max_len: int = 128
    decode_batch_size: int = 8


def refuse_unported_stages(opts: PipelineOptions, stage: int,
                           stop_stage: int) -> None:
    """Raises NotImplementedError for a stage in [stage, stop_stage] whose
    options select a path not ported yet, naming its ROADMAP.md queue 1
    item."""
    on = lambda s: stage <= s <= stop_stage
    todo = []
    if on(3) and opts.feats_type == "fbank_pitch":
        todo.append("stage 3 feats_type 'fbank_pitch' (ops/pitch.py: queue "
                    "1 item 15)")
    if on(3) and opts.feats_type not in ("raw", "fbank", "fbank_pitch"):
        raise ValueError(f"feats_type {opts.feats_type!r}")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def validate_data_dir(d: str | Path) -> int:
    """Stage 1: wav.scp and text name the same utterances; returns their
    number."""
    d = Path(d)
    wavs = read_2column_text(d / "wav.scp")
    texts = read_2column_text(d / "text")
    if set(wavs) != set(texts):
        raise RuntimeError(
            f"{d}: wav.scp/text utterance mismatch "
            f"({len(wavs)} vs {len(texts)})")
    return len(wavs)


# Utterances whose source and copies stage 2 holds at once: host memory
# stays bounded whatever the corpus's size.
SP_WINDOW = 32


def stage2_speed_perturb(src_dir: str | Path, out_dir: str | Path,
                         factors=(0.9, 1.0, 1.1), fs: int = 16000) -> Path:
    """A combined data dir with sp<factor>-prefixed copies (asr.sh:448-468).
    The copies are resampled on a pool of threads (numpy releases the GIL),
    SP_WINDOW utterances at a time: a window is read, resampled and written
    before the next is read. Wavs are read and written, and the lists kept,
    in the reference's order."""
    src, out = Path(src_dir), Path(out_dir)
    wav_out = out / "wav"
    wav_out.mkdir(parents=True, exist_ok=True)
    wavs = list(read_2column_text(src / "wav.scp").items())
    texts = read_2column_text(src / "text")
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool, \
            DatadirWriter(out) as w:
        for i in range(0, len(wavs), SP_WINDOW):
            entries = []  # (uid, new uid, new path, resampling, rate)
            for uid, path in wavs[i:i + SP_WINDOW]:
                x, sr = load_wav(path) if set(factors) - {1.0} else (None, fs)
                for f in factors:
                    if f == 1.0:
                        entries.append((uid, uid, path, None, sr))
                    else:
                        nuid = f"sp{f}-{uid}"
                        entries.append((uid, nuid,
                                        str(wav_out / f"{nuid}.wav"),
                                        pool.submit(speed_perturb, x, f), sr))
            for uid, nuid, npath, resampled, sr in entries:
                if resampled is not None:
                    write_wav(npath, resampled.result(), sr)
                w["wav.scp"][nuid] = npath
                w["text"][nuid] = texts[uid]
    return out


@torch.inference_mode()
def stage3_dump_feats(src_dir: str | Path, out_dir: str | Path,
                      frontend_cfg, device=None) -> Path:
    """Stage 3 with feats_type fbank (asr.sh:472-543): the frontend the raw
    path runs (ops/frontend.py:default_frontend, on ``device``) computes
    each utterance's [T, D] features, saved as out_dir/feats/<uid>.npy
    and listed in feats.scp; text is copied and wav.scp kept, so later
    stages still reach the audio."""
    src, out = Path(src_dir), Path(out_dir)
    feat_dir = out / "feats"
    feat_dir.mkdir(parents=True, exist_ok=True)
    wavs = read_2column_text(src / "wav.scp")
    texts = read_2column_text(src / "text")
    dev = resolve_device(device)
    with DatadirWriter(out) as w:
        for uid, path in wavs.items():
            x, _ = load_wav(path)
            feats, flens = default_frontend(
                torch.as_tensor(np.asarray(x, np.float32), device=dev)[None],
                torch.tensor([len(x)], device=dev), frontend_cfg)
            npy = feat_dir / f"{uid}.npy"
            np.save(npy, feats[0, :int(flens[0])].cpu().numpy())
            w["feats.scp"][uid] = str(npy)
            w["wav.scp"][uid] = path
            w["text"][uid] = texts[uid]
    log.info("stage3: dumped fbank features for %d utts -> %s", len(wavs),
             out)
    return out


def stage4_filter(src_dir: str | Path, out_dir: str | Path,
                  min_sec: float, max_sec: float, fs: int) -> Path:
    """Length filtering (asr.sh:575): keeps utterances of [min_sec,
    max_sec] seconds with a non-empty text (and their feats.scp entries,
    after a stage-3 dump)."""
    src, out = Path(src_dir), Path(out_dir)
    wavs = read_2column_text(src / "wav.scp")
    texts = read_2column_text(src / "text")
    feats = (read_2column_text(src / "feats.scp")
             if (src / "feats.scp").exists() else None)
    kept = 0
    with DatadirWriter(out) as w:
        for uid, path in wavs.items():
            x, sr = load_wav(path)
            if min_sec <= len(x) / sr <= max_sec and texts[uid].strip():
                w["wav.scp"][uid] = path
                w["text"][uid] = texts[uid]
                if feats is not None:
                    w["feats.scp"][uid] = feats[uid]
                kept += 1
    log.info("stage4: kept %d/%d utts", kept, len(wavs))
    return out


def decode_dir(s2t: Speech2Text, data_dir: str | Path, out_dir: str | Path,
               batch_size: int) -> Dict[str, str]:
    """Stage 12 on one data dir: length-sorted batches through
    ``s2t.decode_batch``; writes out_dir/text, returns {uid: text}."""
    wavs = read_2column_text(Path(data_dir) / "wav.scp")
    loaded = sorted(((uid, load_wav(path)[0]) for uid, path in wavs.items()),
                    key=lambda x: len(x[1]))
    hyps = {}
    with DatadirWriter(out_dir) as w:
        for i in range(0, len(loaded), batch_size):
            chunk = loaded[i:i + batch_size]
            for (uid, _), text in zip(chunk,
                                      s2t.decode_batch([x for _, x in chunk])):
                hyps[uid] = text
                w["text"][uid] = text
    return hyps


def run_pipeline(cfg: ASRTaskConfig, opts: PipelineOptions = PipelineOptions(),
                 stage: int = 1, stop_stage: int = 13,
                 test_dirs: Optional[List[str]] = None,
                 device=None) -> Dict[str, object]:
    """Runs stages [stage, stop_stage] with the card (or ``device``) for
    stages 3, 7-8, 10-12 and 15. Returns the scores (``wer_<dir>``,
    ``cer_<dir>``), ``lm_ppl`` (stage 8), ``pack_path``,
    ``unpack_decode_match`` and ``stage_seconds`` {stage: seconds}."""
    refuse_unported_stages(opts, stage, stop_stage)
    dev = resolve_device(device)
    results: Dict[str, object] = {}
    seconds: Dict[int, float] = {}
    results["stage_seconds"] = seconds
    on = lambda s: stage <= s <= stop_stage
    exp = Path(cfg.exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    work = exp / "data"
    train_dir = Path(cfg.data.train_dir)
    clock = time.perf_counter

    if on(1):
        t0 = clock()
        n = validate_data_dir(cfg.data.train_dir)
        validate_data_dir(cfg.data.valid_dir)
        seconds[1] = clock() - t0
        log.info("stage1: %d train utts validated", n)

    if on(2) and opts.speed_perturb_factors:
        t0 = clock()
        train_dir = stage2_speed_perturb(
            train_dir, work / "train_sp", opts.speed_perturb_factors, opts.fs)
        seconds[2] = clock() - t0

    valid_dir = cfg.data.valid_dir
    if on(3) and opts.feats_type == "fbank":
        t0 = clock()
        # The dumped dirs keep the source's basename, so that the decode
        # and score keys (wer_<dirname>) do not change with feats_type.
        train_dir = stage3_dump_feats(train_dir, work / "fbank" / "train",
                                      cfg.model.frontend, dev)
        valid_dir = str(stage3_dump_feats(
            cfg.data.valid_dir, work / "fbank" / Path(valid_dir).name,
            cfg.model.frontend, dev))
        # The task on the dump: the npy loader, the model past the
        # frontend, length buckets in frames. The dump's width is the
        # frontend's (the reference writes n_mels, which its flax layers
        # ignore; the port's input layer is built to it).
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(
                cfg.model, input_feats=True,
                input_feats_dim=feature_dim(cfg.model.frontend)),
            data=dataclasses.replace(
                cfg.data, feats_type="fbank",
                speech_bucket_multiple=max(
                    cfg.data.speech_bucket_multiple
                    // cfg.model.frontend.hop_length, 16)))
        seconds[3] = clock() - t0

    if on(4):
        t0 = clock()
        train_dir = stage4_filter(train_dir, work / "train_filtered",
                                  opts.min_audio_sec, opts.max_audio_sec,
                                  opts.fs)
        seconds[4] = clock() - t0

    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, train_dir=str(train_dir),
                                      valid_dir=str(valid_dir)))

    if on(5):
        t0 = clock()
        ASRTask.prepare_vocab(cfg)  # writes tokens.txt (+ the BPE model)
        seconds[5] = clock() - t0
        log.info("stage5: vocabulary ready")

    if opts.train_lm and on(7):
        from ..models.lm import LMConfig
        from ..tasks.lm import LMDataConfig, LMTask, LMTaskConfig
        t0 = clock()
        valid_text = str(Path(cfg.data.valid_dir) / "text")
        lm_cfg = LMTaskConfig(
            exp_dir=str(exp / "lm"),
            model=LMConfig(d_model=128, n_head=4, d_ff=512, num_blocks=4),
            data=LMDataConfig(train_text=str(Path(train_dir) / "text"),
                              valid_text=valid_text,
                              token_type=cfg.data.token_type),
            max_epoch=min(cfg.max_epoch, 10))
        LMTask.train(lm_cfg, device=dev)
        seconds[7] = clock() - t0
        if on(8):
            t0 = clock()
            results["lm_ppl"] = LMTask.perplexity(lm_cfg.exp_dir, valid_text,
                                                  device=dev)
            seconds[8] = clock() - t0
            log.info("stage8: LM ppl %.2f", results["lm_ppl"])

    ngram_file = None
    if opts.train_ngram and on(9):
        # over the decode token units (the scorer fuses token ids), as the
        # reference's BPE-tokenized lmplz input (asr.sh stage 9)
        from ..decode.ngram import ArpaLM
        from ..decode.ngram_train import train_arpa
        t0 = clock()
        tokenizer, conv, _ = ASRTask.prepare_vocab(cfg)
        sents = [tokenizer.text2tokens(text) for text in
                 read_2column_text(Path(train_dir) / "text").values()]
        arpa = exp / "train.arpa"
        train_arpa(sents, str(arpa), order=opts.ngram_order)
        ngram_file = str(exp / "train_ngram.npz")
        tok2id = {tok: i for i, tok in enumerate(conv.token_list)}
        sos = len(conv.token_list) - 1
        tok2id.setdefault("<s>", sos)
        tok2id.setdefault("</s>", sos)
        ArpaLM(str(arpa), tok2id, len(conv.token_list)).save_binary(
            ngram_file)
        seconds[9] = clock() - t0
        log.info("stage9: ngram trained -> %s", ngram_file)

    if on(10) and cfg.model.use_mvn == "global":
        from ..train.collect_stats import collect_stats
        t0 = clock()
        tokenizer, converter, _ = ASRTask.prepare_vocab(cfg)
        ds = ASRTask.build_dataset(str(train_dir), tokenizer, converter,
                                   text_cleaner=cfg.data.text_cleaner,
                                   feats_type=cfg.data.feats_type)
        factory = ASRTask.build_iter_factory(cfg, ds, shuffle=False)
        collect_stats(factory(1), cfg.model.frontend, exp / "stats",
                      input_feats=cfg.model.input_feats, device=dev)
        seconds[10] = clock() - t0
        log.info("stage10: feature stats collected")

    if on(11):
        t0 = clock()
        ASRTask.train(cfg, device=dev)
        seconds[11] = clock() - t0
        log.info("stage11: training done")

    decode_kw = dict(beam_size=opts.decode_beam_size,
                     ctc_weight=opts.decode_ctc_weight,
                     max_len=opts.decode_max_len, device=dev)
    if on(12):
        t0 = clock()
        s2t = Speech2Text.from_exp_dir(
            str(exp), ngram_file=ngram_file,
            ngram_weight=opts.ngram_weight if ngram_file else 0.0,
            **decode_kw)
        scored = 0.0
        for dname in [cfg.data.valid_dir] + list(test_dirs or []):
            dname = Path(dname)
            out = exp / f"decode_{dname.name}"
            hyps = decode_dir(s2t, dname, out, opts.decode_batch_size)
            if on(13):
                t1 = clock()
                refs = read_2column_text(dname / "text")
                wer, _ = error_rate(refs, hyps, "word")
                cer, _ = error_rate(refs, hyps, "char")
                results[f"wer_{dname.name}"] = wer
                results[f"cer_{dname.name}"] = cer
                with open(out / "score.txt", "w") as f:
                    f.write(f"WER {wer:.4f}\nCER {cer:.4f}\n")
                scored += clock() - t1
                log.info("stage13 %s: WER %.2f%% CER %.2f%%", dname.name,
                         wer * 100, cer * 100)
        seconds[12] = clock() - t0 - scored
        if on(13):
            seconds[13] = scored

    if on(14):
        t0 = clock()
        results["pack_path"] = str(pack(exp, exp / "model.zip"))
        seconds[14] = clock() - t0
        log.info("stage14: packed -> %s", results["pack_path"])
    if on(15):
        t0 = clock()
        unpacked = unpack(exp / "model.zip", exp / "unpacked")
        s2t_u = Speech2Text.from_exp_dir(str(unpacked), **decode_kw)
        s2t_o = Speech2Text.from_exp_dir(str(exp), **decode_kw)
        wavs = read_2column_text(Path(cfg.data.valid_dir) / "wav.scp")
        sample = [load_wav(path)[0] for _, path in sorted(wavs.items())[:4]]
        hyp_u = s2t_u.decode_batch(sample)
        hyp_o = s2t_o.decode_batch(sample)
        results["unpack_decode_match"] = hyp_u == hyp_o
        seconds[15] = clock() - t0
        if hyp_u != hyp_o:
            raise RuntimeError(f"stage15: unpacked model decode mismatch: "
                               f"{hyp_u} vs {hyp_o}")
        log.info("stage15: unpacked model decodes identically (%d utts)",
                 len(sample))
    return results


def pack(exp_dir: str | Path, out_path: str | Path) -> Path:
    """Stage 14 (espnet2/bin/pack.py, asr.sh:1398-1447): a zip of what
    Speech2Text.from_exp_dir needs to decode on its own: config.yaml,
    tokens.txt, the BPE model, stats/feats_stats.npz, reporter.json and the
    preferred checkpoint (the n-best average if there is one, else the
    latest epoch). latest.json goes in only with the epoch it names: an
    average's archive with a stale latest.json would make an unpacked
    exp dir try to resume from a missing epoch."""
    exp = Path(exp_dir)
    out_path = Path(out_path)
    with zipfile.ZipFile(out_path, "w") as z:
        for name in ["config.yaml", "tokens.txt", "reporter.json",
                     "bpe.json", "stats/feats_stats.npz"]:
            p = exp / name
            if p.exists():
                z.write(p, name)
        best = sorted(exp.glob("valid.*best"))[:1]
        if not best and (exp / "latest.json").exists():
            with open(exp / "latest.json") as f:
                best = [exp / f"{json.load(f)['epoch']}epoch"]
            z.write(exp / "latest.json", "latest.json")
        for ckpt in best:
            for f in ckpt.rglob("*"):
                if f.is_file():
                    z.write(f, str(f.relative_to(exp)))
    return out_path


def _zoo(zoo_dir) -> Path:
    return Path(zoo_dir or os.environ.get(
        "ESPNET_SLURP_TPU_ZOO",
        Path.home() / ".cache" / "espnet_slurp_tpu" / "zoo"))


def publish(archive: str | Path, name: str,
            zoo_dir: str | Path | None = None) -> Path:
    """Stage 16's upload, kept local: copies a packed model into the model
    registry directory (``zoo_dir``, else $ESPNET_SLURP_TPU_ZOO, else
    ~/.cache/espnet_slurp_tpu/zoo) and records name -> {file, sha256,
    bytes} in its index.json. ``fetch`` is the download."""
    zoo = _zoo(zoo_dir)
    zoo.mkdir(parents=True, exist_ok=True)
    archive = Path(archive)
    digest = hashlib.sha256(archive.read_bytes()).hexdigest()
    dest = zoo / f"{name}.zip"
    shutil.copyfile(archive, dest)
    index_path = zoo / "index.json"
    index = (json.loads(index_path.read_text())
             if index_path.exists() else {})
    index[name] = {"file": dest.name, "sha256": digest,
                   "bytes": dest.stat().st_size}
    index_path.write_text(json.dumps(index, indent=1))
    return dest


def fetch(name: str, out_dir: str | Path,
          zoo_dir: str | Path | None = None) -> Path:
    """Resolves ``name`` in the model registry, checks its sha256 against
    the index and unpacks it into a decodable exp dir."""
    index_path = _zoo(zoo_dir) / "index.json"
    if not index_path.exists():
        raise FileNotFoundError(f"no model zoo index at {index_path}")
    index = json.loads(index_path.read_text())
    if name not in index:
        raise KeyError(f"model {name!r} not in zoo ({sorted(index)})")
    entry = index[name]
    archive = index_path.parent / entry["file"]
    digest = hashlib.sha256(archive.read_bytes()).hexdigest()
    if digest != entry["sha256"]:
        raise ValueError(f"sha256 mismatch for {name}: registry "
                         f"{entry['sha256'][:12]}.. != file {digest[:12]}..")
    return unpack(archive, out_dir)


def unpack(archive: str | Path, out_dir: str | Path) -> Path:
    """Stage 15: extracts a packed model and rebases its config.yaml on the
    unpacked directory (its exp_dir, and the BPE model when packed), so
    that the directory decodes on its own."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(archive) as z:
        z.extractall(out)
    cfg_path = out / "config.yaml"
    if cfg_path.exists():
        cfg = dataclasses.replace(load_task_config(cfg_path),
                                  exp_dir=str(out))
        if (out / "bpe.json").exists():
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, bpemodel=str(out / "bpe.json")))
        save_yaml(cfg, cfg_path)
    return out
