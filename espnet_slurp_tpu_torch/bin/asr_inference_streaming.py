"""Streaming ASR inference CLI. Port of
espnet_slurp_tpu/bin/asr_inference_streaming.py.

    python -m espnet_slurp_tpu_torch.bin.asr_inference_streaming \
        --exp_dir exp --data_dir dev --output_dir dec \
        [--incremental] [--sim_chunk_length 8192] [--print_partial] \
        [--device cpu]

Feeds each utterance of ``wav.scp`` ``--sim_chunk_length`` samples a call
to decode/streaming.py:StreamingRecognizer (re-encodes the buffered audio
each chunk) or, with ``--incremental``, decode/incremental.py:
IncrementalRecognizer (per-layer caches: a constant cost a chunk; needs
``left_chunks >= 0``). Writes ``<output_dir>/text``, ``chunk_ms.json``
(each utterance's host ms a call, the partial hypothesis included) and,
when the data dir has references, ``score.txt`` (WER, CER, RTF). Decodes on
the card unless ``--device`` names another device; with no card and no
``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path


def get_parser():
    p = argparse.ArgumentParser(
        description="Streaming decode with a chunk-attention ASR model")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True,
                   help="dir with wav.scp (+ text for scoring)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir name under exp_dir")
    p.add_argument("--sim_chunk_length", type=int, default=8192,
                   help="samples fed per streaming call")
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--max_len", type=int, default=128)
    p.add_argument("--print_partial", action="store_true",
                   help="log the CTC-greedy partial hypothesis per chunk")
    p.add_argument("--incremental", action="store_true",
                   help="O(1)-state exact incremental encoder (per-layer "
                        "caches) instead of re-encoding the prefix")
    p.add_argument("--device", default="cuda",
                   help="device to decode on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    import numpy as np

    from ..data.fileio import DatadirWriter, load_wav, read_2column_text
    from ..decode.incremental import IncrementalRecognizer
    from ..decode.streaming import StreamingRecognizer
    from ..tasks.asr import Speech2Text
    from ..utils.device import cli_device
    from ..utils.metrics import error_rate

    # Speech2Text loads the config, vocabulary, weights and MVN stats; the
    # recognizer wraps its model.
    s2t = Speech2Text.from_exp_dir(args.exp_dir, ckpt_name=args.ckpt,
                                   max_len=args.max_len,
                                   beam_size=args.beam_size,
                                   device=cli_device(args.device))
    cls = IncrementalRecognizer if args.incremental else StreamingRecognizer
    rec = cls(s2t.model, tokenizer=s2t.tokenizer, converter=s2t.converter,
              chunk_samples=args.sim_chunk_length, max_len=args.max_len,
              beam_size=args.beam_size, mvn_stats=s2t.mvn_stats)

    wavs = read_2column_text(Path(args.data_dir) / "wav.scp")
    hyps, chunk_ms = {}, {}
    audio_sec = decode_sec = 0.0
    n = args.sim_chunk_length
    with DatadirWriter(args.output_dir) as w:
        for uid, path in wavs.items():
            wav, sr = load_wav(path)
            audio_sec += len(wav) / sr
            rec.reset()
            ids, times = [], []
            for off in range(0, max(len(wav), 1), n):
                t0 = time.perf_counter()
                # the ids reach the host: the device has finished the chunk
                ids, done = rec(wav[off:off + n], is_final=off + n >= len(wav))
                times.append((time.perf_counter() - t0) * 1e3)
                if args.print_partial and not done and ids:
                    logging.info("%s [partial] %s", uid, rec.text(ids))
            decode_sec += sum(times) / 1e3
            chunk_ms[uid] = times
            hyps[uid] = rec.text(ids)
            w["text"][uid] = hyps[uid]
    rtf = decode_sec / max(audio_sec, 1e-9)
    every = [t for ts in chunk_ms.values() for t in ts]
    logging.info("streamed %.1fs audio in %.1fs (RTF %.4f, chunk %d, "
                 "median %.2f ms a call)", audio_sec, decode_sec, rtf, n,
                 float(np.median(every)) if every else 0.0)
    out = Path(args.output_dir)
    (out / "chunk_ms.json").write_text(json.dumps(chunk_ms))
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
        with open(out / "score.txt", "w") as f:
            f.write(f"WER {wer:.4f}\nCER {cer:.4f}\nRTF {rtf:.4f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
