"""CTC forced-alignment CLI: align known transcripts to audio and write
per-word timings and confidences. Port of espnet_slurp_tpu/bin/asr_align.py.

    python -m espnet_slurp_tpu_torch.bin.asr_align --exp_dir exp \
        --data_dir dev --output_dir ali [--device cpu]

Each utterance of ``wav.scp`` that ``text`` transcribes is encoded alone
(padded to its bucket) and its CTC log-posteriors come back to the host,
where decode/ctc_segmentation.py aligns the transcript's tokens; word-level
tokens are their own words, others merge by align_words. Writes
``<output_dir>/segments``: ``uid start end confidence word`` a line, times
in seconds. An encoder frame lasts hop x the subsampling factor samples at
the frontend's ``fs`` (the reference assumes 16 kHz: ROADMAP.md queue 3).
Encodes on the card unless ``--device`` names another device; with no card
and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path


def get_parser():
    p = argparse.ArgumentParser(description="CTC segmentation / alignment")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True,
                   help="dir with wav.scp + text (the transcripts to align)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda",
                   help="device to encode on (default cuda; cpu to run "
                        "without a card)")
    return p


def frame_seconds(model_cfg) -> float:
    """One encoder frame's duration: hop x the input layer's time
    reduction, at the frontend's sampling rate."""
    fc = model_cfg.frontend
    sub = model_cfg.subsampling_factor if model_cfg.input_layer == "conv2d" \
        else 1
    return fc.hop_length * sub / fc.fs


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    import numpy as np
    import torch

    from ..data.fileio import load_wav, read_2column_text
    from ..data.sampler import bucket_length
    from ..decode.ctc_segmentation import align_words, ctc_viterbi_align
    from ..tasks.asr import Speech2Text
    from ..utils.device import cli_device

    s2t = Speech2Text.from_exp_dir(args.exp_dir, ckpt_name=args.ckpt,
                                   device=cli_device(args.device))
    model, cfg = s2t.model, s2t.task_cfg
    frame_s = frame_seconds(model.cfg)
    dev = model.device

    wavs = read_2column_text(Path(args.data_dir) / "wav.scp")
    texts = read_2column_text(Path(args.data_dir) / "text")
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_done = 0
    with open(out / "segments", "w", encoding="utf-8") as f:
        for uid, path in wavs.items():
            if uid not in texts:
                continue
            wav, _ = load_wav(path)
            n = bucket_length(len(wav), cfg.data.speech_bucket_multiple)
            buf = np.zeros((1, n), np.float32)
            buf[0, :len(wav)] = wav
            with torch.inference_mode():
                hs, hl = model.encode(torch.from_numpy(buf).to(dev),
                                      torch.tensor([len(wav)], device=dev),
                                      s2t.mvn_stats)
                lp = model.ctc_logprobs(hs)[0, :int(hl[0])].cpu().numpy()
            toks = s2t.tokenizer.text2tokens(texts[uid])
            ids = s2t.converter.tokens2ids(toks)
            timings = ctc_viterbi_align(lp, list(ids), model.cfg.blank_id)
            if cfg.data.token_type == "word":
                # word-level tokens: every token IS a word
                rows = [(st, en, cf, w) for (st, en, cf), w
                        in zip(timings, toks)]
            else:
                rows = align_words(timings, toks)
            for start, end, conf, word in rows:
                f.write(f"{uid} {start * frame_s:.3f} {end * frame_s:.3f} "
                        f"{conf:.3f} {word}\n")
            n_done += 1
    logging.info("aligned %d utts -> %s/segments", n_done, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
