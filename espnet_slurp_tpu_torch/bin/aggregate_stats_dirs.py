"""Aggregate split collect-stats directories into one. Port of
espnet_slurp_tpu/bin/aggregate_stats_dirs.py (host numpy, copied).

When collect-stats runs in shards, each writes its own shape files and
feats_stats.npz; this concatenates the shape files (sorted by key) and sums
the npz fields (count, sum, sum_square). Sub-directories (the reference
layout's train / valid) are merged the same way.

    python -m espnet_slurp_tpu_torch.bin.aggregate_stats_dirs \
        --input_dir stats.1 --input_dir stats.2 --output_dir stats
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def _one_level(in_dirs, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    names = set()
    for d in in_dirs:
        names |= {f.name for f in d.iterdir()
                  if f.is_file() and not f.name.endswith(".npz")}
    for name in sorted(names):
        lines = []
        for d in in_dirs:
            p = d / name
            if p.exists():
                lines += [ln for ln in p.read_text(encoding="utf-8")
                          .splitlines() if ln.strip()]
        lines.sort(key=lambda x: x.split()[0])
        (out_dir / name).write_text("\n".join(lines) + "\n",
                                    encoding="utf-8")
    npz_names = set()
    for d in in_dirs:
        npz_names |= {f.name for f in d.glob("*.npz")}
    for name in sorted(npz_names):
        total = None
        for d in in_dirs:
            p = d / name
            if not p.exists():
                continue
            stats = dict(np.load(p))
            if total is None:
                total = stats
            else:
                for k in stats:
                    total[k] = total[k] + stats[k]
        np.savez(out_dir / name, **total)


def aggregate(input_dirs, output_dir) -> None:
    input_dirs = [Path(p) for p in input_dirs]
    out = Path(output_dir)
    for sub in [d.name for d in input_dirs[0].iterdir() if d.is_dir()]:
        _one_level([d / sub for d in input_dirs if (d / sub).exists()],
                   out / sub)
    if any(f.is_file() for f in input_dirs[0].iterdir()):
        _one_level(input_dirs, out)


def get_parser():
    p = argparse.ArgumentParser(
        description="Aggregate collect-stats directories into one")
    p.add_argument("--input_dir", action="append", required=True,
                   help="stats dir (repeatable)")
    p.add_argument("--output_dir", required=True)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    aggregate(args.input_dir, args.output_dir)
    logging.info("aggregated %d dirs -> %s", len(args.input_dir),
                 args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
