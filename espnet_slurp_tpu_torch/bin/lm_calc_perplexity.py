"""LM perplexity CLI. Port of espnet_slurp_tpu/bin/lm_calc_perplexity.py
(reference espnet2/bin/lm_calc_perplexity.py).

Usage: python -m espnet_slurp_tpu_torch.bin.lm_calc_perplexity --exp_dir E
           --text T [--ckpt 3epoch] [--device cpu]

Prints ``perplexity: <ppl>`` of the Kaldi-style text T under the LM of E.
"""
from __future__ import annotations

import argparse

from ..tasks.lm import LMTask
from ..utils.device import cli_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; cpu to run "
                        "without a card)")
    args = p.parse_args(argv)
    ppl = LMTask.perplexity(args.exp_dir, args.text, args.ckpt,
                            device=cli_device(args.device))
    print(f"perplexity: {ppl:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
