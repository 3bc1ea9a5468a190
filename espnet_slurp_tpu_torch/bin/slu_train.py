"""SLU training CLI. Port of espnet_slurp_tpu/bin/slu_train.py.

Usage: python -m espnet_slurp_tpu_torch.bin.slu_train --config conf/x.yaml \
           [--set key=value ...] [--device cpu]

Trains on the card unless ``--device`` names another device; with no card
and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging

from ..tasks.slu import SLUTask, load_slu_config
from ..utils.device import cli_device
from .asr_train import parse_overrides


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Train SLU (PyTorch/CUDA port)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", dest="overrides")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu to run "
                        "without a card)")
    args = p.parse_args(argv)
    SLUTask.train(load_slu_config(args.config,
                                  parse_overrides(args.overrides)),
                  device=cli_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
