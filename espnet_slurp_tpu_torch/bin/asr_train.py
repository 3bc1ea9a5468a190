"""ASR training CLI. Port of espnet_slurp_tpu/bin/asr_train.py.

Parity target: reference espnet2/bin/asr_train.py (thin Task.main wrapper).
Usage: python -m espnet_slurp_tpu_torch.bin.asr_train --config conf/train.yaml \
           [--set key=value ...] [--device cpu]

Trains on the card unless ``--device`` names another device; with no card
and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import logging

from ..tasks.asr import ASRTask, load_task_config
from ..utils.device import cli_device


def parse_overrides(pairs):
    """['a.b=3', 'c=x'] -> nested dict with YAML-parsed values."""
    import yaml
    out = {}
    for pair in pairs or ():
        key, _, value = pair.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return out


def get_parser():
    p = argparse.ArgumentParser(description="Train ASR (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default=None, help="YAML config")
    p.add_argument("--set", nargs="*", metavar="KEY=VALUE", dest="overrides",
                   help="config overrides, e.g. optim.lr=1e-3")
    p.add_argument("--print_config", action="store_true",
                   help="print fully-resolved config and exit")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training (not ported yet: raises)")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu to run "
                        "without a card)")
    return p


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    cfg = load_task_config(args.config, parse_overrides(args.overrides))
    if args.print_config:
        import sys
        import yaml
        from ..utils.config import to_dict
        yaml.safe_dump(to_dict(cfg), sys.stdout, sort_keys=False)
        return 0
    if args.multihost:
        raise NotImplementedError(
            "--multihost: multi-process training is not ported yet "
            "(ROADMAP.md queue 1 item 17)")
    ASRTask.train(cfg, device=cli_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
