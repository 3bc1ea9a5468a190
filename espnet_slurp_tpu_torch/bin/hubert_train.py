"""HuBERT pretraining CLI. Port of espnet_slurp_tpu/bin/hubert_train.py.

Usage: python -m espnet_slurp_tpu_torch.bin.hubert_train --config C.yaml \
           [--set key=value ...] [--device cpu]

The config is tasks/hubert.py:HubertTaskConfig (``train_dir`` /
``valid_dir`` hold wav.scp and km). Trains on the card unless ``--device``
names another device; with no card and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging

from ..tasks.hubert import HubertTask, load_hubert_config
from ..utils.device import cli_device
from .asr_train import parse_overrides


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Train HuBERT (PyTorch/CUDA "
                                            "port)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", dest="overrides")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu to run "
                        "without a card)")
    args = p.parse_args(argv)
    cfg = load_hubert_config(args.config, parse_overrides(args.overrides))
    HubertTask.train(cfg, device=cli_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
