"""Transducer training CLI. Port of
espnet_slurp_tpu/bin/asr_transducer_train.py.

    python -m espnet_slurp_tpu_torch.bin.asr_transducer_train \
        --config conf/train_transducer.yaml [--set key=value ...] \
        [--device cpu]

Trains on the card unless ``--device`` names another device; with no card
and no ``--device cpu`` it raises. A second call with a larger
``max_epoch`` resumes from the experiment's latest.json.
"""
from __future__ import annotations

import argparse
import logging

from ..tasks.asr_transducer import ASRTransducerTask, load_transducer_config
from ..utils.device import cli_device
from .asr_train import parse_overrides


def get_parser():
    p = argparse.ArgumentParser(description="Train transducer ASR")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", metavar="KEY=VALUE", dest="overrides")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    ASRTransducerTask.train(
        load_transducer_config(args.config, parse_overrides(args.overrides)),
        device=cli_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
