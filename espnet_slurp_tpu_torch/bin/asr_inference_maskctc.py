"""MaskCTC (non-autoregressive) inference CLI. Port of
espnet_slurp_tpu/bin/asr_inference_maskctc.py.

    python -m espnet_slurp_tpu_torch.bin.asr_inference_maskctc \
        --exp_dir exp --data_dir dev --output_dir dec [--device cpu]

Decodes a data dir with a ``model_arch: maskctc`` experiment (CTC greedy,
then ``--n_iterations`` mask-predict passes over the tokens below
``--threshold``), ``--batch_size`` utterances a call, length-sorted.
Writes ``<output_dir>/text`` and, when the data dir has references,
``score.txt`` (WER, CER, RTF). Decodes on the card unless ``--device``
names another device; with no card and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path


def get_parser():
    p = argparse.ArgumentParser(
        description="Decode with a trained MaskCTC model")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True,
                   help="dir with wav.scp (+ text for scoring)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir name under exp_dir")
    p.add_argument("--max_len", type=int, default=128)
    p.add_argument("--n_iterations", type=int, default=4,
                   help="mask-predict refinement passes (maskctc_n_iter)")
    p.add_argument("--threshold", type=float, default=0.99,
                   help="CTC confidence below which a token is re-predicted")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="device to decode on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    from ..data.fileio import DatadirWriter, load_wav, read_2column_text
    from ..tasks.asr import Speech2TextMaskCTC
    from ..utils.device import cli_device
    from ..utils.metrics import error_rate

    s2t = Speech2TextMaskCTC.from_exp_dir(
        args.exp_dir, ckpt_name=args.ckpt, max_len=args.max_len,
        n_iterations=args.n_iterations, threshold=args.threshold,
        device=cli_device(args.device))
    wavs = read_2column_text(Path(args.data_dir) / "wav.scp")
    loaded = sorted(((uid, *load_wav(path)) for uid, path in wavs.items()),
                    key=lambda x: len(x[1]))
    hyps, audio_sec, decode_sec = {}, 0.0, 0.0
    with DatadirWriter(args.output_dir) as w:
        for i in range(0, len(loaded), args.batch_size):
            chunk = loaded[i:i + args.batch_size]
            t0 = time.perf_counter()
            # decode_batch returns host strings: the device has finished.
            texts = s2t.decode_batch([wav for _, wav, _ in chunk])
            decode_sec += time.perf_counter() - t0
            for (uid, wav, sr), text in zip(chunk, texts):
                hyps[uid] = text
                audio_sec += len(wav) / sr
                w["text"][uid] = text
    rtf = decode_sec / max(audio_sec, 1e-9)
    logging.info("decoded %.1fs audio in %.1fs (RTF %.4f)", audio_sec,
                 decode_sec, rtf)
    ref_path = Path(args.data_dir) / "text"
    if ref_path.exists():
        refs = read_2column_text(ref_path)
        cleaner_type = s2t.task_cfg.data.text_cleaner
        if cleaner_type:
            from ..data.cleaner import TextCleaner
            clean = TextCleaner(cleaner_type)
            refs = {k: clean(v) for k, v in refs.items()}
        wer, stats = error_rate(refs, hyps, unit="word")
        cer, _ = error_rate(refs, hyps, unit="char")
        logging.info("WER=%.2f%% CER=%.2f%% (%d ref words)", wer * 100,
                     cer * 100, stats.ref_len)
        with open(Path(args.output_dir) / "score.txt", "w") as f:
            f.write(f"WER {wer:.4f}\nCER {cer:.4f}\nRTF {rtf:.4f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
