"""Dump SSL features for ``feats_type: ssl`` training.

Port of espnet_slurp_tpu/bin/ssl_dump.py (the S3PRL frontend analogue):
the wav2vec2 encoder (models/wav2vec2.py; seeded random weights, or an HF
``Wav2Vec2Model`` state dict through ``wav2vec2_params_from_torch`` with
``--torch_ckpt``) plays the external SSL model. Every utterance's per-layer
states are written as .npy [T, L, D] (``--layer -1``, all layers) or [T,
D] (``--layer k``) under ``<out_dir>/data``, listed in feats.scp, with the
data dir's text carried over. Utterances go through the encoder in sorted
order, in batches of about ``--batch_frames`` samples, on the card unless
``--device`` names another device (with no card and no ``--device cpu``
it raises).

Usage:
  python -m espnet_slurp_tpu_torch.bin.ssl_dump --data_dir data/train \
      --out_dir dump/ssl/train [--torch_ckpt w2v2.pt] [--layer -1] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="Dump SSL features (S3PRL "
                                            "frontend analogue)")
    p.add_argument("--data_dir", required=True, help="dir with wav.scp")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--torch_ckpt", default=None,
                   help="HF wav2vec2 state-dict .pt to load (random-"
                        "initialized extractor otherwise — useful for "
                        "pipeline tests)")
    p.add_argument("--layer", type=int, default=-1,
                   help="-1: stack ALL layers [T, L, D]; k: single layer")
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--num_blocks", type=int, default=3)
    p.add_argument("--n_head", type=int, default=4)
    p.add_argument("--d_ff", type=int, default=128)
    p.add_argument("--batch_frames", type=int, default=1_600_000,
                   help="waveform samples per dump batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to run the encoder on (default cuda; cpu "
                        "to run without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    import torch

    from ..data.fileio import DatadirWriter, load_wav, read_2column_text
    from ..models.wav2vec2 import (Wav2Vec2Config, Wav2Vec2Encoder,
                                   wav2vec2_params_from_torch)
    from ..tasks.asr import ASRTask
    from ..utils.device import cli_device

    dev = cli_device(args.device)
    cfg = Wav2Vec2Config(d_model=args.d_model, num_blocks=args.num_blocks,
                         n_head=args.n_head, d_ff=args.d_ff)
    enc = ASRTask.init_params(Wav2Vec2Encoder(cfg), args.seed)
    if args.torch_ckpt:
        enc.load_state_dict(wav2vec2_params_from_torch(args.torch_ckpt, cfg))
    enc = enc.to(dev).eval()
    wavs = read_2column_text(Path(args.data_dir) / "wav.scp")
    out = Path(args.out_dir)
    feat_dir = out / "data"
    feat_dir.mkdir(parents=True, exist_ok=True)
    items = sorted(wavs.items())
    n_frames = 0
    with DatadirWriter(out) as w:
        batch, batch_n = [], 0

        def flush():
            nonlocal n_frames
            if not batch:
                return
            n_max = max(len(x) for _, x in batch)
            buf = np.zeros((len(batch), n_max), np.float32)
            lens = np.zeros((len(batch),), np.int32)
            for i, (_, x) in enumerate(batch):
                buf[i, :len(x)] = x
                lens[i] = len(x)
            with torch.inference_mode():
                states, flens = enc.layer_states(
                    torch.from_numpy(buf).to(dev),
                    torch.from_numpy(lens).to(dev))
                states = states.float().cpu().numpy()
                flens = flens.cpu().numpy()
            for i, (uid, _) in enumerate(batch):
                t = int(flens[i])
                mat = states[i, :t]            # [T, L, D]
                if args.layer >= 0:
                    mat = mat[:, args.layer]   # [T, D]
                path = feat_dir / f"{uid}.npy"
                np.save(path, mat)
                w["feats.scp"][uid] = str(path)
                n_frames += t
            batch.clear()

        for uid, path in items:
            wav, _ = load_wav(path)
            batch.append((uid, wav))
            batch_n += len(wav)
            if batch_n >= args.batch_frames:
                flush()
                batch_n = 0
        flush()
        # carry text through so the dump dir is a complete data dir
        text_path = Path(args.data_dir) / "text"
        if text_path.exists():
            for uid, txt in read_2column_text(text_path).items():
                if uid in wavs:
                    w["text"][uid] = txt
    logging.info("dumped %d utts (%d frames, %s layers x %d dims) to %s",
                 len(items), n_frames,
                 "all" if args.layer < 0 else 1, args.d_model, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
