"""Quality-evidence run: train the ASR stack on the largest realistic
synthetic corpus and record a falling WER curve (RESULTS.md).

Port of espnet_slurp_tpu/recipe/results_run.py: ``N_UNITS``,
``_unit_wave``, ``make_synth_corpus`` (the same files, byte for byte, from
the same seed) and ``main``, which trains through tasks/asr.py:ASRTask and
decodes with Speech2Text on ``--device`` (the card unless "cpu"). The
corpus: a 100-word vocabulary where each word is a 2-4 unit sequence over
30 phoneme-like units (tone complexes with word-specific harmonic ratios),
with per-utterance speaker pitch scaling, speaking-rate variation,
amplitude and noise jitter, so the mapping must be learned. Nothing is
downloaded. recipe/ka2g_run.py builds its corpus from the same units.

Usage: python -m espnet_slurp_tpu_torch.recipe.results_run [--out exp/results]
Writes {out}/RESULTS.md with the loss/acc curve and WER at several
checkpoints (decoded with the batched beam search).
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from ..data.fileio import DatadirWriter, write_wav

log = logging.getLogger("espnet_slurp_tpu_torch")

N_UNITS = 30


def _unit_wave(unit: int, f0: float, dur: int, fs: int, rng) -> np.ndarray:
    """Phoneme-like unit: f0-scaled tone complex with unit-specific
    harmonic structure + onset/offset ramp."""
    base = 180.0 * (2 ** (unit / 12.0))
    t = np.arange(dur) / fs
    h2 = 1.5 + 0.1 * (unit % 5)
    h3 = 2.3 + 0.07 * (unit % 7)
    x = (0.5 * np.sin(2 * np.pi * base * f0 * t)
         + 0.3 * np.sin(2 * np.pi * base * h2 * f0 * t)
         + 0.2 * np.sin(2 * np.pi * base * h3 * f0 * t))
    ramp = min(dur // 8, 160)
    env = np.ones(dur)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    return (x * env).astype(np.float32)


def make_synth_corpus(root, n_train=2000, n_dev=100, n_test=100,
                      vocab_size=100, fs=16000, seed=11):
    """Write {root}/{train,dev,test}. Returns the three dir paths."""
    root = Path(root)
    if (root / "test" / "wav.scp").exists():
        return root / "train", root / "dev", root / "test"
    rng = np.random.RandomState(seed)
    words = [f"w{i:03d}" for i in range(vocab_size)]
    lexicon = {w: rng.randint(0, N_UNITS, size=rng.randint(2, 5)).tolist()
               for w in words}
    dirs = []
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        d = root / split
        wav_dir = d / "wav"
        wav_dir.mkdir(parents=True, exist_ok=True)
        with DatadirWriter(d) as writer:
            for i in range(n):
                n_words = rng.randint(3, 9)
                utt_words = [words[rng.randint(vocab_size)]
                             for _ in range(n_words)]
                f0 = rng.uniform(0.9, 1.15)       # speaker pitch
                rate = rng.uniform(0.9, 1.1)      # speaking rate
                amp = rng.uniform(0.6, 1.2)
                segs = []
                for w in utt_words:
                    for u in lexicon[w]:
                        dur = int(fs * rng.uniform(0.05, 0.09) / rate)
                        segs.append(_unit_wave(u, f0, dur, fs, rng))
                    segs.append(np.zeros(int(fs * 0.02), np.float32))
                wav = amp * 0.3 * np.concatenate(segs)
                wav = wav + rng.uniform(0.02, 0.05) * rng.randn(
                    len(wav)).astype(np.float32)
                uid = f"{split}_{i:05d}"
                path = wav_dir / f"{uid}.wav"
                write_wav(str(path), wav, fs)
                writer["wav.scp"][uid] = str(path)
                writer["text"][uid] = " ".join(utt_words)
        dirs.append(d)
    return tuple(dirs)


def _device_name(dev) -> str:
    import torch
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="exp/results")
    p.add_argument("--corpus", default="exp/results/corpus")
    p.add_argument("--n_train", type=int, default=2000)
    p.add_argument("--max_epoch", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ..data.fileio import load_wav, read_2column_text
    from ..models.asr_model import ASRConfig
    from ..ops.specaug import SpecAugConfig
    from ..tasks.asr import ASRTask, ASRTaskConfig, DataConfig, Speech2Text
    from ..train.optim import OptimConfig
    from ..utils.device import cli_device
    from ..utils.metrics import error_rate

    dev = cli_device(args.device)

    t0 = time.time()
    train_dir, dev_dir, test_dir = make_synth_corpus(
        args.corpus, n_train=args.n_train)
    log.info("corpus ready (%.1fs)", time.time() - t0)

    exp = Path(args.out) / "exp"
    cfg = ASRTaskConfig(
        exp_dir=str(exp),
        model=ASRConfig(
            d_model=128, n_head=4, d_ff=512, num_encoder_blocks=4,
            num_decoder_blocks=2, decoder_d_ff=512, kernel_size=15,
            dropout_rate=0.1, ctc_weight=0.3, use_mvn="utterance",
            specaug=SpecAugConfig(freq_mask_width_range=(0, 10),
                                  time_mask_width_range=(0, 20)),
            dtype="bfloat16"),
        optim=OptimConfig(lr=1e-3, scheduler="warmuplr", warmup_steps=600),
        data=DataConfig(train_dir=str(train_dir), valid_dir=str(dev_dir),
                        token_type="word", batch_type="sorted",
                        batch_size=64, speech_bucket_multiple=8192,
                        text_bucket_multiple=8),
        max_epoch=args.max_epoch, keep_nbest=100, nbest_average=5,
        log_interval=20)
    ASRTask.train(cfg, device=dev)
    train_s = time.time() - t0
    log.info("training done (%.1fs)", train_s)

    refs = read_2column_text(Path(test_dir) / "text")
    wavs = read_2column_text(Path(test_dir) / "wav.scp")
    loaded = sorted(((u, load_wav(pth)[0]) for u, pth in wavs.items()),
                    key=lambda x: len(x[1]))

    def decode_with(ckpt_name):
        s2t = Speech2Text.from_exp_dir(str(exp), ckpt_name=ckpt_name,
                                       beam_size=5, ctc_weight=0.3,
                                       max_len=16, device=dev)
        hyps = {}
        for i in range(0, len(loaded), 16):
            chunk = loaded[i:i + 16]
            for (u, _), txt in zip(chunk, s2t.decode_batch(
                    [x for _, x in chunk])):
                hyps[u] = txt
        wer, _ = error_rate(refs, hyps, "word")
        return wer

    hist = json.loads((exp / "reporter.json").read_text())["history"]
    ckpts = []
    for e in (3, max(args.max_epoch // 2, 4), args.max_epoch):
        if (exp / f"{e}epoch").exists():
            ckpts.append(f"{e}epoch")
    ave = sorted(exp.glob("valid.*ave_*best"))
    if ave:
        ckpts.append(ave[0].name)
    wers = {}
    for name in ckpts:
        wers[name] = decode_with(name)
        log.info("WER[%s] = %.2f%%", name, wers[name] * 100)

    out = Path(args.out)
    lines = [
        "# RESULTS — synthetic-corpus quality run",
        "",
        f"Corpus: {args.n_train} train / 100 dev / 100 test utterances, "
        "100-word vocab over 30 phoneme-like units, per-utterance speaker "
        "pitch/rate/amplitude/noise variation "
        "(espnet_slurp_tpu_torch/recipe/results_run.py:make_synth_corpus).",
        f"Model: Conformer 4x128 + Transformer 2x128 decoder, CTC 0.3, "
        f"SpecAug, bf16; {args.max_epoch} epochs, "
        f"train wall-clock {train_s:.0f}s on "
        f"{_device_name(dev)}.",
        "",
        "## Validation curve (loss / att-accuracy by epoch)",
        "",
        "| epoch | train loss | valid loss | valid acc |",
        "|---|---|---|---|",
    ]
    for e in hist:
        lines.append(f"| {e['epoch']} | {e['train']['loss']:.3f} | "
                     f"{e['valid']['loss']:.3f} | "
                     f"{e['valid'].get('acc', float('nan')):.3f} |")
    lines += ["", "## Test WER by checkpoint (beam 5, ctc 0.3)", "",
              "| checkpoint | WER |", "|---|---|"]
    for name, wer in wers.items():
        lines.append(f"| {name} | {wer * 100:.2f}% |")
    (out / "RESULTS.md").write_text("\n".join(lines) + "\n")
    log.info("wrote %s", out / "RESULTS.md")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
