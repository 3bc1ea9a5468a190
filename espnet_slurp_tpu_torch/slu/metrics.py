"""SLU scoring: intent accuracy and entity SLU-F1.

Port of espnet_slurp_tpu/slu/metrics.py (plain Python there, so this is the
port's own copy): ``parse_entity_text``, ``intent_accuracy``, ``F1Stats``
and ``slu_f1``. Parity targets of the reference: egs2/slurp/slu1/local/
score.py (intent = first token of hyp vs ref) and egs2/slurp_entity/asr1/
local/ (entity extraction from 'intent SEP type FILL filler SEP ... SEP
transcript' strings; SLU-F1 precision/recall/F1 over (type, filler) pairs,
micro-averaged with per-utt multiset intersection, the official
slurp_evaluation semantics).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Tuple


def parse_entity_text(text: str) -> Tuple[str, List[Tuple[str, str]], str]:
    """'intent SEP type FILL filler SEP ... SEP transcript' ->
    (intent, [(type, filler)], transcript)."""
    parts = [p.strip() for p in text.split(" SEP ")]
    intent = parts[0].split()[0] if parts[0] else ""
    entities: List[Tuple[str, str]] = []
    transcript = ""
    for seg in parts[1:]:
        if " FILL " in seg:
            typ, _, filler = seg.partition(" FILL ")
            entities.append((typ.strip(), filler.strip()))
        else:
            transcript = seg
    return intent, entities, transcript


def intent_accuracy(refs: Dict[str, str], hyps: Dict[str, str]) -> float:
    """First-token intent accuracy (slurp slu1 local/score.py:16-35)."""
    n, correct = 0, 0
    for uid, ref in refs.items():
        hyp = hyps.get(uid, "")
        ri = ref.split()[0] if ref.split() else ""
        hi = hyp.split()[0] if hyp.split() else ""
        n += 1
        correct += int(ri == hi)
    return correct / max(n, 1)


@dataclass
class F1Stats:
    tp: int = 0
    fp: int = 0
    fn: int = 0

    @property
    def precision(self):
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self):
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-12)


def slu_f1(refs: Dict[str, str], hyps: Dict[str, str]) -> F1Stats:
    """Micro-averaged entity F1 over (type, lowercased filler) pairs."""
    stats = F1Stats()
    for uid, ref in refs.items():
        _, ref_ents, _ = parse_entity_text(ref)
        _, hyp_ents, _ = parse_entity_text(hyps.get(uid, ""))
        rc = Counter((t, f.lower()) for t, f in ref_ents)
        hc = Counter((t, f.lower()) for t, f in hyp_ents)
        inter = rc & hc
        tp = sum(inter.values())
        stats.tp += tp
        stats.fp += sum(hc.values()) - tp
        stats.fn += sum(rc.values()) - tp
    return stats
