"""Staged SLU recipe pipeline — the slu.sh analogue.

Port of espnet_slurp_tpu/recipe/slu_pipeline.py (reference
egs2/TEMPLATE/slu1/slu.sh + the slurp recipes' scoring stages: intent
accuracy, SLU-F1), with the asr_pipeline stage numbering: 1 validate ->
11 train -> 12 decode -> 13 score. Decoding feeds the GT transcript stream
when two-pass (the reference's 'GT transcript' upper-bound condition) or
omits it (1-pass). Trains and decodes on ``device`` (the card unless
``device="cpu"``).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

from ..data.fileio import DatadirWriter, load_wav, read_2column_text
from ..slu.metrics import intent_accuracy, slu_f1
from ..tasks.slu import SLUTask, SLUTaskConfig, Speech2Understand

log = logging.getLogger("espnet_slurp_tpu_torch")


def run_slu_pipeline(
    cfg: SLUTaskConfig,
    stage: int = 1,
    stop_stage: int = 13,
    test_dirs: Optional[List[str]] = None,
    use_gt_transcript: bool = True,
    max_len: int = 64,
    device=None,
) -> Dict[str, float]:
    """Stages: 1 validate -> 11 train -> 12 decode -> 13 score. Returns
    intent_acc_<dir> and slu_f1_<dir> of each scored directory."""
    results: Dict[str, float] = {}
    exp = Path(cfg.exp_dir)
    exp.mkdir(parents=True, exist_ok=True)

    if stage <= 1 <= stop_stage:
        for d in (cfg.data.train_dir, cfg.data.valid_dir):
            d = Path(d)
            wavs = read_2column_text(d / "wav.scp")
            texts = read_2column_text(d / "text")
            if set(wavs) != set(texts):
                raise RuntimeError(f"{d}: wav.scp/text mismatch")
            if cfg.model.two_pass and not (d / "transcript").exists():
                raise RuntimeError(f"{d}: two_pass requires a transcript "
                                   "stream")
        log.info("stage1: SLU data validated")

    if stage <= 11 <= stop_stage:
        SLUTask.train(cfg, device=device)
        log.info("stage11: SLU training done")

    if stage <= 12 <= stop_stage:
        s2u = Speech2Understand(str(exp), max_len=max_len, device=device)
        for dname in [cfg.data.valid_dir] + list(test_dirs or []):
            dname = Path(dname)
            out = exp / f"decode_{dname.name}"
            wavs = read_2column_text(dname / "wav.scp")
            trs = read_2column_text(dname / "transcript") \
                if use_gt_transcript and (dname / "transcript").exists() \
                else {}
            hyps = {}
            with DatadirWriter(out) as w:
                for uid, path in wavs.items():
                    wav, _ = load_wav(path)
                    hyps[uid] = s2u(wav, transcript=trs.get(uid))
                    w["text"][uid] = hyps[uid]
            if stage <= 13 <= stop_stage:
                refs = read_2column_text(dname / "text")
                acc = intent_accuracy(refs, hyps)
                f1 = slu_f1(refs, hyps)
                results[f"intent_acc_{dname.name}"] = acc
                results[f"slu_f1_{dname.name}"] = f1.f1
                with open(out / "score.txt", "w") as f:
                    f.write(f"intent_acc {acc:.4f}\nslu_f1 {f1.f1:.4f}\n"
                            f"precision {f1.precision:.4f}\n"
                            f"recall {f1.recall:.4f}\n")
                log.info("stage13 %s: intent acc %.4f SLU-F1 %.4f",
                         dname.name, acc, f1.f1)
    return results
