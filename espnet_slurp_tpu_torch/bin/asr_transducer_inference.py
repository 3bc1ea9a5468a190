"""Transducer inference CLI: decode a data dir, write hyps, score WER/CER.
Port of espnet_slurp_tpu/bin/asr_transducer_inference.py.

    python -m espnet_slurp_tpu_torch.bin.asr_transducer_inference \
        --exp_dir exp --data_dir dev --output_dir dec --beam_size 5 \
        --search alsa [--device cpu]

``--search`` is one of greedy | alsa | default | maes | tsd | nsc (greedy
whenever ``--beam_size`` is 1). Writes ``<output_dir>/text`` and, when the
data dir has references, ``score.txt`` (WER, CER, RTF). Decodes
``--batch_size`` utterances a call (1, as the reference decodes them, by
default), length-sorted. ``--streaming`` feeds each utterance
``--sim_chunk_length`` (``--chunk_samples``) samples a call to
decode/streaming.py:StreamingTransducerRecognizer (a model trained with
``asr.chunk_size > 0``: the buffered audio re-encoded each chunk, greedy
partials, the final pass by ``--search``). Decodes on the card unless
``--device`` names another device; with no card and no ``--device cpu``
it raises.
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
                   help="chunked incremental decode (requires a model "
                        "trained with asr.chunk_size > 0)")
    p.add_argument("--sim_chunk_length", "--chunk_samples", type=int,
                   default=8192, help="samples fed per streaming call")
    p.add_argument("--device", default="cuda",
                   help="device to decode on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
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
    decode = s2t.decode_batch
    if args.streaming:
        from ..decode.streaming import StreamingTransducerRecognizer
        rec = StreamingTransducerRecognizer(
            s2t.model, tokenizer=s2t.tokenizer, converter=s2t.converter,
            chunk_samples=args.sim_chunk_length, max_len=args.max_len,
            beam_size=args.beam_size, search=args.search)
        decode = lambda wavs_: [_stream(rec, wav, args.sim_chunk_length)
                                for wav in wavs_]
    hyps, audio_sec, decode_sec = {}, 0.0, 0.0
    with DatadirWriter(args.output_dir) as w:
        for i in range(0, len(loaded), args.batch_size):
            chunk = loaded[i:i + args.batch_size]
            t0 = time.perf_counter()
            # the texts are host strings: the device has finished.
            texts = decode([wav for _, wav, _ in chunk])
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


def _stream(rec, wav, n: int) -> str:
    """One utterance through the streaming recognizer, n samples a call."""
    rec.reset()
    ids = []
    for off in range(0, max(len(wav), 1), n):
        ids, _ = rec(wav[off:off + n], is_final=off + n >= len(wav))
    return rec.text(ids)


if __name__ == "__main__":
    raise SystemExit(main())
