"""Transducer inference CLI: decode a data dir, write hyps, score WER/CER.
Port of espnet_slurp_tpu/bin/asr_transducer_inference.py.

    python -m espnet_slurp_tpu_torch.bin.asr_transducer_inference \
        --exp_dir exp --data_dir dev --output_dir dec --beam_size 5 \
        --search alsa [--device cpu]

``--search`` is one of greedy | alsa | default | maes | tsd | nsc (greedy
whenever ``--beam_size`` is 1). Writes ``<output_dir>/text`` and, when the
data dir has references, ``score.txt`` (WER, CER, RTF). Decodes
``--batch_size`` utterances a call (1, as the reference decodes them, by
default), length-sorted. Decodes on the card unless ``--device`` names
another device; with no card and no ``--device cpu`` it raises.
``--streaming`` is not ported yet and raises.
"""
from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from ..decode.transducer_beam import SEARCHES


def get_parser():
    p = argparse.ArgumentParser(description="Decode with a transducer")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir name under exp_dir")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--max_len", type=int, default=128)
    p.add_argument("--search", default="alsa", choices=SEARCHES)
    p.add_argument("--batch_size", type=int, default=1,
                   help="utterances per batched decode call")
    p.add_argument("--streaming", action="store_true",
                   help="chunked incremental decode (not ported yet: "
                        "raises)")
    p.add_argument("--device", default="cuda",
                   help="device to decode on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    if args.streaming:
        raise NotImplementedError(
            "not ported yet: --streaming (decode/streaming.py: ROADMAP.md "
            "queue 1 item 15)")
    from ..data.fileio import DatadirWriter, load_wav, read_2column_text
    from ..tasks.asr_transducer import Speech2TextTransducer
    from ..utils.device import cli_device
    from ..utils.metrics import error_rate

    s2t = Speech2TextTransducer.from_exp_dir(
        args.exp_dir, ckpt_name=args.ckpt, beam_size=args.beam_size,
        max_len=args.max_len, search=args.search,
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
        wer, _ = error_rate(refs, hyps, unit="word")
        cer, _ = error_rate(refs, hyps, unit="char")
        logging.info("WER=%.2f%% CER=%.2f%%", wer * 100, cer * 100)
        with open(Path(args.output_dir) / "score.txt", "w") as f:
            f.write(f"WER {wer:.4f}\nCER {cer:.4f}\nRTF {rtf:.4f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
