"""Compile a text ARPA n-gram LM to the binary scoring cache.

Port of espnet_slurp_tpu/bin/ngram_compile.py. Usage: python -m
espnet_slurp_tpu_torch.bin.ngram_compile --arpa lm.arpa --tokens
exp/tokens.txt --output lm.npz (host only: numpy, no device).

KenLM ``build_binary`` analogue (the reference's decode loads KenLM
binaries via scorers/ngram.py; tools/installers/install_kenlm.sh). The
cache holds the flattened sparse tables the scorer gathers from, keyed
to a specific token list, so ``asr_inference --ngram_file out.npz`` starts
without re-parsing the ARPA text.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Compile ARPA -> binary ngram")
    p.add_argument("--arpa", required=True, help="ARPA text (.arpa[.gz])")
    p.add_argument("--tokens", required=True,
                   help="token list file (exp_dir/tokens.txt)")
    p.add_argument("--output", required=True, help="output .npz cache")
    p.add_argument("--sos", default="<s>")
    p.add_argument("--eos", default="</s>")
    p.add_argument("--sos_id", type=int, default=-1,
                   help="decoder sos id (-1 = last token)")
    args = p.parse_args(argv)
    from ..decode.ngram import ArpaLM
    tokens = Path(args.tokens).read_text().splitlines()
    tok2id = {t: i for i, t in enumerate(tokens)}
    sos_id = args.sos_id if args.sos_id >= 0 else len(tokens) - 1
    tok2id.setdefault(args.sos, sos_id)
    tok2id.setdefault(args.eos, sos_id)
    lm = ArpaLM(args.arpa, tok2id, len(tokens))
    lm.save_binary(args.output)
    logging.info("compiled %s -> %s (V=%d, bi=%d rows, tri=%d rows)",
                 args.arpa, args.output, lm.v, len(lm.bi_ctx),
                 len(lm.tri_ctx))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
