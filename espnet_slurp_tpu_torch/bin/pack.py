"""Model packaging CLI: pack, unpack, publish and fetch. Port of
espnet_slurp_tpu/bin/pack.py (recipe/asr_pipeline.py's functions).

    python -m espnet_slurp_tpu_torch.bin.pack pack --exp_dir exp --out m.zip
    python -m espnet_slurp_tpu_torch.bin.pack unpack --archive m.zip \
        --out_dir unpacked [--verify_data_dir dev --device cpu]
    python -m espnet_slurp_tpu_torch.bin.pack publish --archive m.zip \
        --name m --zoo_dir zoo
    python -m espnet_slurp_tpu_torch.bin.pack fetch --name m --out_dir x \
        --zoo_dir zoo

``unpack`` / ``fetch`` with ``--verify_data_dir`` decode that data dir's
first 4 utterances from the unpacked directory on ``--device`` (the card
unless given; with no card and no ``--device cpu`` they raise).
"""
from __future__ import annotations

import argparse
import logging


def get_parser():
    p = argparse.ArgumentParser(description="Pack/unpack a trained exp dir")
    sub = p.add_subparsers(dest="mode", required=True)
    pk = sub.add_parser("pack", help="exp dir -> zip archive")
    pk.add_argument("--exp_dir", required=True)
    pk.add_argument("--out", required=True, help="output .zip path")
    up = sub.add_parser("unpack", help="zip archive -> exp dir")
    up.add_argument("--archive", required=True)
    up.add_argument("--out_dir", required=True)
    pb = sub.add_parser("publish", help="archive -> local model registry")
    pb.add_argument("--archive", required=True)
    pb.add_argument("--name", required=True)
    pb.add_argument("--zoo_dir", default=None)
    ft = sub.add_parser("fetch", help="registry name -> decodable exp dir")
    ft.add_argument("--name", required=True)
    ft.add_argument("--out_dir", required=True)
    ft.add_argument("--zoo_dir", default=None)
    for s in (up, ft):
        s.add_argument("--verify_data_dir", default=None,
                       help="decode this data dir's first 4 utterances "
                            "from the unpacked dir")
        s.add_argument("--device", default="cuda",
                       help="device of the verifying decode (default cuda; "
                            "cpu to run without a card)")
    return p


def verify(exp_dir, data_dir, device) -> list:
    """Decodes data_dir's first 4 utterances (sorted by id) from exp_dir;
    returns the texts."""
    from pathlib import Path

    from ..data.fileio import load_wav, read_2column_text
    from ..tasks.asr import Speech2Text
    from ..utils.device import cli_device
    s2t = Speech2Text.from_exp_dir(str(exp_dir), device=cli_device(device))
    wavs = read_2column_text(Path(data_dir) / "wav.scp")
    return s2t.decode_batch([load_wav(p)[0]
                             for _, p in sorted(wavs.items())[:4]])


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    from ..recipe.asr_pipeline import fetch, pack, publish, unpack
    if args.mode == "pack":
        out = pack(args.exp_dir, args.out)
        logging.info("packed %s -> %s", args.exp_dir, out)
    elif args.mode == "unpack":
        out = unpack(args.archive, args.out_dir)
        logging.info("unpacked %s -> %s", args.archive, out)
    elif args.mode == "publish":
        out = publish(args.archive, args.name, args.zoo_dir)
        logging.info("published %s as %r -> %s", args.archive, args.name,
                     out)
    else:
        out = fetch(args.name, args.out_dir, args.zoo_dir)
        logging.info("fetched %r -> %s", args.name, out)
    if getattr(args, "verify_data_dir", None):
        texts = verify(out, args.verify_data_dir, args.device)
        logging.info("decoded from %s: %s", out, texts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
