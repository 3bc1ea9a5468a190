"""LM training CLI. Port of espnet_slurp_tpu/bin/lm_train.py (reference
espnet2/bin/lm_train.py).

Usage: python -m espnet_slurp_tpu_torch.bin.lm_train --config lm.yaml \
           [--set key=value ...] [--device cpu]

The YAML holds tasks/lm.py:LMTaskConfig's fields (exp_dir, model, optim,
data: {train_text, valid_text, token_type, batch_size, max_len, seed},
max_epoch, ...). Trains on the card unless ``--device`` names another
device; with no card and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging

from ..tasks.lm import LMTask, load_lm_config
from ..utils.device import cli_device
from .asr_train import parse_overrides


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Train an LM (PyTorch/CUDA port)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", dest="overrides")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu to run "
                        "without a card)")
    args = p.parse_args(argv)
    LMTask.train(load_lm_config(args.config, parse_overrides(args.overrides)),
                 device=cli_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
