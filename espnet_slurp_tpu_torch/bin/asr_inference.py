"""ASR inference CLI: decode a data dir, write hyps, score WER/CER. Port of
espnet_slurp_tpu/bin/asr_inference.py.

Parity target: reference espnet2/bin/asr_inference.py (Speech2Text over a
data dir, writing exp/.../text) + asr.sh stage 12-13 scoring. Writes
``<output_dir>/text`` and, when the data dir has references,
``score.txt`` (WER, CER, RTF). A ``feats_type: ssl`` model decodes the
data dir's feats.scp (a bin/ssl_dump.py dump), its RTF at 100 frames a
second as the reference counts it. Decodes on the card unless ``--device``
names another device; with no card and no ``--device cpu`` it raises.
``--lm_exp_dir`` / ``--lm_weight`` (a bin/lm_train experiment) and
``--ngram_file`` / ``--ngram_weight`` (an ARPA file or its
bin/ngram_compile cache) fuse into the beam search. ``--ctc_timesync``
decodes by the frame-synchronous CTC prefix beam (no LM: a positive
``--lm_weight`` or ``--ngram_weight`` raises with it) and ``--lattice`` by
the CTC n-best lattice, rescored by the decoder at
``--lattice_att_weight`` and by the LM and n-gram at their weights.
"""
from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path


def get_parser():
    p = argparse.ArgumentParser(description="Decode with a trained ASR model")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True,
                   help="dir with wav.scp (+ text for scoring)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir name under exp_dir")
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--max_len", type=int, default=128)
    p.add_argument("--nj", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8,
                   help="utterances per batched beam-search call")
    p.add_argument("--lm_exp_dir", default=None,
                   help="trained LM exp dir for shallow fusion")
    p.add_argument("--lm_weight", type=float, default=0.0)
    p.add_argument("--ngram_file", default=None,
                   help="ARPA n-gram LM (or its .npz cache) for shallow "
                        "fusion")
    p.add_argument("--ngram_weight", type=float, default=0.0)
    p.add_argument("--ctc_timesync", action="store_true",
                   help="frame-synchronous CTC prefix beam search")
    p.add_argument("--lattice", action="store_true",
                   help="CTC n-best lattice decode + LM rescoring "
                        "(asr_inference_k2.py analogue)")
    p.add_argument("--lattice_att_weight", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="device to decode on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    from ..data.fileio import DatadirWriter, load_wav, read_2column_text
    from ..tasks.asr import Speech2Text
    from ..utils.device import cli_device
    from ..utils.metrics import error_rate

    s2t = Speech2Text.from_exp_dir(
        args.exp_dir, ckpt_name=args.ckpt, max_len=args.max_len,
        beam_size=args.beam_size, ctc_weight=args.ctc_weight,
        device=cli_device(args.device), lm_exp_dir=args.lm_exp_dir,
        lm_weight=args.lm_weight, ngram_file=args.ngram_file,
        ngram_weight=args.ngram_weight, ctc_timesync=args.ctc_timesync,
        lattice=args.lattice, lattice_att_weight=args.lattice_att_weight)
    hyps = {}
    audio_sec = 0.0
    decode_sec = 0.0
    # Sort by duration and decode in batches: one batched beam-search call
    # per group (length-sorted so pad waste inside a batch stays low).
    loaded = []
    if s2t.feats_type == "ssl":
        # an SSL dump: decode its feats.scp matrices. The dump states no
        # frame rate, so RTF counts 100 frames a second, as the
        # reference's log does (wav2vec2 frames are 20 ms: ROADMAP.md
        # queue 3).
        import numpy as np
        feats = read_2column_text(Path(args.data_dir) / "feats.scp")
        for uid, path in feats.items():
            loaded.append((uid, np.load(path), 100))
    else:
        wavs = read_2column_text(Path(args.data_dir) / "wav.scp")
        for uid, path in wavs.items():
            wav, sr = load_wav(path)
            loaded.append((uid, wav, sr))
    loaded.sort(key=lambda x: len(x[1]))
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
    # RTF report (utils/calculate_rtf.py analogue).
    rtf = decode_sec / max(audio_sec, 1e-9)
    logging.info("decoded %.1fs audio in %.1fs (RTF %.4f)", audio_sec,
                 decode_sec, rtf)
    ref_path = Path(args.data_dir) / "text"
    if ref_path.exists():
        refs = read_2column_text(ref_path)
        # score against CLEANED references when the model was trained with
        # a text cleaner (asr.sh stage 13 passes --cleaner to the scoring
        # tokenization too) — hypotheses come out of the cleaned vocab
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
