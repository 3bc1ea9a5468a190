"""SLU inference CLI: decode a data dir, score intent accuracy and SLU-F1.

Port of espnet_slurp_tpu/bin/slu_inference.py (reference
espnet2/bin/slu_inference.py + the slurp recipes' local/score.py): writes
``<output_dir>/text`` and, when the data dir has references,
``score.txt`` in the reference's format (intent_acc, slu_f1, precision,
recall). Logs the RTF and the greedy loops' host syncs an utterance.
Decodes on the card unless ``--device`` names another device; with no card
and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--use_transcript", action="store_true",
                   help="feed the GT transcript stream (two-pass upper bound)")
    p.add_argument("--asr_exp_dir", default=None,
                   help="first-pass ASR exp dir: its hypotheses feed the "
                        "two-pass transcript stream (the full deployment "
                        "loop)")
    p.add_argument("--asr_beam_size", type=int, default=5)
    p.add_argument("--use_history", action="store_true",
                   help="roll decoded turns into the transcript stream "
                        "(utterances are processed in uid order as one "
                        "dialogue)")
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="device to decode on (default cuda; cpu to run "
                        "without a card)")
    args = p.parse_args(argv)

    from ..data.fileio import DatadirWriter, load_wav, read_2column_text
    from ..slu.metrics import intent_accuracy, slu_f1
    from ..tasks.slu import Speech2Understand
    from ..utils import device as devmod

    s2u = Speech2Understand(args.exp_dir, max_len=args.max_len,
                            asr_exp_dir=args.asr_exp_dir,
                            asr_beam_size=args.asr_beam_size,
                            use_history=args.use_history,
                            device=devmod.cli_device(args.device))
    d = Path(args.data_dir)
    wavs = read_2column_text(d / "wav.scp")
    trs = read_2column_text(d / "transcript") \
        if (d / "transcript").exists() and args.use_transcript else {}
    hyps = {}
    audio_sec = decode_sec = 0.0
    syncs0 = devmod.host_syncs
    with DatadirWriter(args.output_dir) as w:
        for uid, path in wavs.items():
            wav, sr = load_wav(path)
            t0 = time.perf_counter()
            hyps[uid] = s2u(wav, transcript=trs.get(uid))
            decode_sec += time.perf_counter() - t0
            audio_sec += len(wav) / sr
            w["text"][uid] = hyps[uid]
    syncs = devmod.host_syncs - syncs0
    logging.info("decoded %.1fs audio in %.3fs (RTF %.5f); %d host syncs, "
                 "%.2f an utterance", audio_sec, decode_sec,
                 decode_sec / max(audio_sec, 1e-9), syncs,
                 syncs / max(len(wavs), 1))
    ref_path = d / "text"
    if ref_path.exists():
        refs = read_2column_text(ref_path)
        acc = intent_accuracy(refs, hyps)
        f1 = slu_f1(refs, hyps)
        logging.info("intent acc %.4f | SLU-F1 p=%.4f r=%.4f f1=%.4f",
                     acc, f1.precision, f1.recall, f1.f1)
        with open(Path(args.output_dir) / "score.txt", "w") as f:
            f.write(f"intent_acc {acc:.4f}\nslu_f1 {f1.f1:.4f}\n"
                    f"precision {f1.precision:.4f}\nrecall {f1.recall:.4f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
