"""SLURP corpus preparation: jsonl annotations -> Kaldi-style data dirs.

Port of espnet_slurp_tpu/recipe/prepare_slurp.py (host code there, so this
is the port's own copy: the same annotations give the same data dirs).
Parity target: reference egs2/slurp/asr1/local/prepare_slurp_data.py
(intent-prefixed transcripts) and egs2/slurp_entity/asr1/local/
prepare_slurp_entity_data.py:60-64 ('scenario_action SEP type FILL filler
... SEP transcript'). Also writes the plain `transcript` stream used by the
two-pass SLU task (egs2/slurp/slu1).

Usage:
    python -m espnet_slurp_tpu_torch.recipe.prepare_slurp \
        --slurp_dir /path/to/slurp --audio_dir /path/to/audio/slurp_real \
        --out data/slurp --format entity
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

from ..data.fileio import DatadirWriter


def clean_transcript(text: str) -> str:
    text = text.replace("@", " at ").replace("#", " hashtag ")
    text = text.replace(",", "").replace(".", "")
    return re.sub(" +", " ", text).strip().replace("<unk>", "unknown")


def parse_annotation(sentence_annotation: str) -> List[Tuple[str, str]]:
    """'[type : filler]' spans -> [(type, filler)] sorted by type."""
    ents = []
    for seg in sentence_annotation.split("[")[1:]:
        body = seg.split("]")[0]
        if ":" not in body:
            continue
        typ, _, filler = body.partition(":")
        ents.append((typ.strip(), filler.strip().lower()))
    return sorted(ents, key=lambda x: x[0].lower())


def format_text(record: dict, fmt: str) -> str:
    transcript = clean_transcript(record["sentence"])
    intent = f"{record['scenario']}_{record['action']}"
    if fmt == "intent":  # egs2/slurp/asr1 layout
        return f"{intent} {transcript}"
    if fmt == "entity":  # egs2/slurp_entity layout
        ents = parse_annotation(record.get("sentence_annotation", ""))
        parts = [intent]
        for typ, filler in ents:
            parts.append(f"SEP {typ} FILL {filler}")
        parts.append(f"SEP {transcript}")
        return " ".join(parts)
    if fmt == "transcript":
        return transcript
    raise ValueError(fmt)


def prepare_slurp(slurp_dir: str, audio_dir: str, out_dir: str,
                  fmt: str = "entity",
                  include_synthetic: bool = True) -> Dict[str, int]:
    """Write {out_dir}/{train,devel,test}/{wav.scp,text,transcript,utt2spk}."""
    slurp = Path(slurp_dir)
    audio = Path(audio_dir)
    out = Path(out_dir)
    counts = {}
    spk = {}
    meta_path = slurp / "metadata.json"
    if meta_path.exists():
        with open(meta_path) as f:
            for rec in json.load(f).values():
                for fname, info in rec.get("recordings", {}).items():
                    spk[fname[6:-5]] = info.get("usrid", "unk")

    for subset in ("train", "devel", "test"):
        files = [slurp / f"{subset}.jsonl"]
        if subset == "train" and include_synthetic:
            syn = slurp / "train_synthetic.jsonl"
            if syn.exists():
                files.append(syn)
        seen = set()
        n = 0
        with DatadirWriter(out / subset) as w:
            for path in files:
                if not path.exists():
                    continue
                with open(path) as f:
                    for line in f:
                        rec = json.loads(line)
                        text = format_text(rec, fmt)
                        transcript = format_text(rec, "transcript")
                        for recording in rec.get("recordings", []):
                            recoid = recording["file"][6:-5]
                            if recoid in seen:
                                continue
                            seen.add(recoid)
                            speaker = spk.get(recoid, "unk")
                            uid = f"slurp_{speaker}_{recoid}"
                            w["wav.scp"][uid] = str(
                                audio / recording["file"])
                            w["text"][uid] = text
                            w["transcript"][uid] = transcript
                            w["utt2spk"][uid] = f"slurp_{speaker}"
                            n += 1
        counts[subset] = n
    return counts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--slurp_dir", required=True,
                   help="dir with {train,devel,test}.jsonl + metadata.json")
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--format", default="entity",
                   choices=["intent", "entity"])
    p.add_argument("--no_synthetic", action="store_true")
    args = p.parse_args(argv)
    counts = prepare_slurp(args.slurp_dir, args.audio_dir, args.out,
                           args.format, not args.no_synthetic)
    print(counts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
