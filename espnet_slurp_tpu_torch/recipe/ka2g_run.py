"""KA2G SLU campaign: slot-KB TCPGen vs no-KB on entity F1 with headroom.

Port of espnet_slurp_tpu/recipe/ka2g_run.py. It builds a SLURP-style
corpus whose entity values have a long rare tail (each rare value appears
at most twice in training; every test utterance uses only rare values),
trains the KA2G composite model (slu/ka2g.py) with and without the
slot-ontology TCPGen through tasks/generic.py:run_training on
``--device`` (the card unless "cpu"), and publishes the entity-F1 deltas.
Reference of the method: the fork's KB_utils/SLU.py:658-1346 slot-wise
TCPGen over ontology trees; success = the slot-KB arm beats the no-KB arm
on (rare) entity F1.

The waveforms are device-resident (data/resident.py): a batch's speech is
a gather on the device, its token and slot streams and the teacher-forced
walk_forest arrays are made on the host. Three arms: ``nokb``,
``tcpgen_forest`` (TCPGen trained and decoding over the forest) and
``tcpgen_noforest`` (the same model decoding without it); each arm's
checkpoint is the n-best average when there is one, else the last epoch.

Usage: python -m espnet_slurp_tpu_torch.recipe.ka2g_run [--out exp/ka2g]
Writes {out}/results.json and {out}/RESULTS_KA2G.md; exits 1 if the KB
arm fails to beat the no-KB arm.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from ..data.fileio import DatadirWriter, read_2column_text, write_wav
from .results_run import N_UNITS, _unit_wave

log = logging.getLogger("espnet_slurp_tpu_torch")

N_SLOTS = 5
VALUE_LEN = 2  # every entity value is a 2-word phrase -> depth-2 tries
N_COMMON = 10  # values 0-9 of a slot are common, the rest rare


def make_ka2g_corpus(root, n_train=4000, n_dev=200, n_test=400,
                     n_words=120, values_per_slot=40,
                     n_common_values=N_COMMON, fs=16000, seed=41):
    """Corpus with rare-entity headroom.

    Each slot's ontology: ``values_per_slot`` 2-word phrases; the first
    ``n_common_values`` carry ~80% of the training mass, the rest are RARE
    (<= 2 train occurrences each). Test utterances use ONLY rare values.
    Writes wav.scp / text (transcript) / slots ("uid s<k>:w1+w2;...") and
    ontology.json. Returns (train, dev, test, ontology)."""
    root = Path(root)
    if (root / "ontology.json").exists():
        onto = json.loads((root / "ontology.json").read_text())
        return (root / "train", root / "dev", root / "test", onto)
    rng = np.random.RandomState(seed)
    words = [f"w{i:03d}" for i in range(n_words)]
    lexicon = {w: rng.randint(0, N_UNITS, size=rng.randint(2, 5)).tolist()
               for w in words}
    intents = [f"intent{i}" for i in range(6)]
    carrier = {it: [words[rng.randint(20)] for _ in range(2)]
               for it in intents}
    onto = []  # [slot][value] = [w_a, w_b]
    for s in range(N_SLOTS):
        vals, seen = [], set()
        while len(vals) < values_per_slot:
            v = (words[20 + rng.randint(n_words - 20)],
                 words[20 + rng.randint(n_words - 20)])
            if v not in seen:
                seen.add(v)
                vals.append(list(v))
        onto.append(vals)
    rare_budget = {(s, vi): 2 for s in range(N_SLOTS)
                   for vi in range(n_common_values, values_per_slot)}

    def pick_value(s, split):
        if split == "train":
            if rng.rand() < 0.2:
                open_rare = [vi for (ss, vi), k in rare_budget.items()
                             if ss == s and k > 0]
                if open_rare:
                    vi = open_rare[rng.randint(len(open_rare))]
                    rare_budget[(s, vi)] -= 1
                    return vi
            return int(rng.randint(n_common_values))
        if split == "dev":
            return int(rng.randint(n_common_values))
        return int(n_common_values
                   + rng.randint(len(onto[s]) - n_common_values))

    dirs = []
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        d = root / split
        (d / "wav").mkdir(parents=True, exist_ok=True)
        with DatadirWriter(d) as writer:
            for i in range(n):
                it = intents[rng.randint(len(intents))]
                slots = sorted(rng.choice(N_SLOTS, size=rng.randint(1, 3),
                                          replace=False).tolist())
                pairs = [(s, pick_value(s, split)) for s in slots]
                utt_words = list(carrier[it])
                for s, vi in pairs:
                    utt_words += onto[s][vi]
                f0 = rng.uniform(0.85, 1.2)
                rate = rng.uniform(0.9, 1.15)
                segs = []
                for w in utt_words:
                    for u in lexicon[w]:
                        dur = int(fs * rng.uniform(0.05, 0.09) / rate)
                        segs.append(_unit_wave(u, f0, dur, fs, rng))
                    segs.append(np.zeros(int(fs * 0.012), np.float32))
                wav = 0.3 * rng.uniform(0.6, 1.2) * np.concatenate(segs)
                wav += 0.03 * rng.randn(len(wav)).astype(np.float32)
                uid = f"{split}_{i:05d}"
                path = d / "wav" / f"{uid}.wav"
                write_wav(str(path), wav.astype(np.float32), fs)
                writer["wav.scp"][uid] = str(path)
                writer["text"][uid] = " ".join(utt_words)
                writer["slots"][uid] = ";".join(
                    f"s{s}:" + "+".join(onto[s][vi]) for s, vi in pairs)
        dirs.append(d)
    (root / "ontology.json").write_text(json.dumps(onto))
    return tuple(dirs) + (onto,)


def _parse_slots(txt: str):
    out = []
    for part in txt.split(";"):
        if not part:
            continue
        tag, val = part.split(":")
        out.append((int(tag[1:]), val.split("+")))
    return out


def _slot_arrays(slot_txt, tok2id):
    """slots line -> (present [S], values [S, VALUE_LEN] ids pad -1,
    value_lengths [S])."""
    present = np.zeros((N_SLOTS,), np.int32)
    values = np.full((N_SLOTS, VALUE_LEN), -1, np.int32)
    vlens = np.zeros((N_SLOTS,), np.int32)
    for s, ws in _parse_slots(slot_txt):
        present[s] = 1
        ids = [tok2id[w] for w in ws][:VALUE_LEN]
        values[s, :len(ids)] = ids
        vlens[s] = len(ids)
    return present, values, vlens


def build_vocab(texts, onto):
    """Word-level token list over the transcripts UNION the ontology
    (blank 0, unk 1, eos last): the KB is known up front, so a rare value
    that never occurs in training is still scorable."""
    vocab = sorted({w for t in texts.values() for w in t.split()}
                   | {w for slot_vals in onto for v in slot_vals
                      for w in v})
    return ["<blank>", "<unk>"] + vocab + ["<eos>"]


def build_cfg(vocab_size: int, use_tcpgen: bool):
    """The recipe's KA2G model: Conformer 6 x 144 (4 heads, d_ff 576,
    kernel 15, dropout 0.1, utterance MVN, SpecAug) with CTC weight 1.0,
    and a 5-slot generator 144 wide (2 blocks, d_ff 576), all bf16."""
    from ..models.asr_model import ASRConfig
    from ..ops.specaug import SpecAugConfig
    from ..slu.generator import SlotGenConfig
    from ..slu.ka2g import KA2GConfig
    return KA2GConfig(
        asr=ASRConfig(
            vocab_size=vocab_size, d_model=144, n_head=4, d_ff=576,
            num_encoder_blocks=6, num_decoder_blocks=1,
            decoder_d_ff=144, kernel_size=15, dropout_rate=0.1,
            ctc_weight=1.0, use_mvn="utterance",
            specaug=SpecAugConfig(freq_mask_width_range=(0, 10),
                                  time_mask_width_range=(0, 20)),
            dtype="bfloat16"),
        gen=SlotGenConfig(n_slots=N_SLOTS, value_vocab_size=vocab_size,
                          d_model=144, n_head=4, d_ff=576, num_blocks=2,
                          max_value_len=VALUE_LEN, use_tcpgen=use_tcpgen,
                          dtype="bfloat16"),
        slot_factor=1.0)


def forest_arrays(trie):
    return {"trie_token": trie.token,
            "trie_children_tok": trie.children_tok,
            "trie_children_node": trie.children_node,
            "trie_n_children": trie.n_children}


def load_split(d):
    txts = read_2column_text(Path(d) / "text")
    slots = read_2column_text(Path(d) / "slots")
    return sorted(txts), txts, slots


def make_factory(resident, d, tok2id, batch_size, use_tcpgen, shuffle,
                 trie=None, roots=None, seed=0):
    """epoch -> batches of ``batch_size`` utterances of split ``d``
    (length-sorted, the partial last batch dropped, shuffled per epoch):
    the speech gathered on the resident corpus's device, padded to a
    multiple of 8192 samples; the transcript, slot streams and (with
    ``use_tcpgen``) the forest and its walk_forest arrays as numpy."""
    from ..slu.generator import walk_forest
    uids, txts, slots = load_split(d)
    uids = sorted(uids, key=lambda u: resident.index[u][1])
    batches = [uids[i:i + batch_size]
               for i in range(0, len(uids), batch_size)]
    batches = [b for b in batches if len(b) == batch_size]
    trie_np = forest_arrays(trie) if use_tcpgen else None

    def factory(epoch):
        rng = np.random.RandomState(1000 * seed + epoch)
        order = rng.permutation(len(batches)) if shuffle \
            else np.arange(len(batches))
        for bi in order:
            chunk = batches[bi]
            t_pad = -(-max(resident.index[u][1] for u in chunk)
                      // 8192) * 8192
            speech, slens = resident.speech(chunk, t_pad)
            text_ids = [[tok2id.get(w, 1) for w in txts[u].split()]
                        for u in chunk]
            tl = max(len(t) for t in text_ids)
            text = np.full((len(chunk), tl), -1, np.int32)
            for r, t in enumerate(text_ids):
                text[r, :len(t)] = t
            present, values, vlens = (np.stack(a) for a in zip(
                *(_slot_arrays(slots[u], tok2id) for u in chunk)))
            batch = {
                "speech": speech, "speech_lengths": slens,
                "text": np.maximum(text, 0).astype(np.int32),
                "text_lengths": np.array([len(t) for t in text_ids],
                                         np.int32),
                "slot_present": present, "values": values,
                "value_lengths": vlens,
            }
            if use_tcpgen:
                n, l = len(chunk) * N_SLOTS, VALUE_LEN
                vals = np.maximum(values, 0).reshape(n, l)
                ys_in = np.pad(vals, ((0, 0), (1, 0)))[:, :l]
                slot_idx = np.tile(np.arange(N_SLOTS), len(chunk))
                node, pmask = walk_forest(trie, roots, ys_in, slot_idx)
                batch.update(trie_np,
                             node=node.reshape(len(chunk), N_SLOTS * l),
                             p_gen_mask=pmask.reshape(len(chunk),
                                                      N_SLOTS * l))
            yield batch
    return factory


def entity_scores(slot_logits, vals, chunk, test_slots, id2tok,
                  rare_sets, counts):
    """Adds one batch's entity counts (tp, fp, fn, rare tp, rare fn) into
    ``counts``: a slot is predicted where its logit is > 0, with the
    generated in-vocabulary tokens as its value."""
    vocab_size = len(id2tok)
    for r, u in enumerate(chunk):
        gold = {(s, tuple(ws)) for s, ws in _parse_slots(test_slots[u])}
        pred = set()
        for s in range(N_SLOTS):
            if slot_logits[r, s] > 0:
                ws = tuple(id2tok[t] for t in vals[r, s]
                           if 0 <= t < vocab_size)
                pred.add((s, ws))
        grare = {(s, v) for s, v in gold if v in rare_sets[s]}
        counts[0] += len(gold & pred)
        counts[1] += len(pred - gold)
        counts[2] += len(gold - pred)
        counts[3] += len(grare & pred)
        counts[4] += len(grare - pred)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="exp/ka2g")
    p.add_argument("--corpus", default="exp/ka2g/corpus")
    p.add_argument("--n_train", type=int, default=4000)
    p.add_argument("--n_dev", type=int, default=200)
    p.add_argument("--n_test", type=int, default=400)
    p.add_argument("--max_epoch", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=48)
    p.add_argument("--eval_batch", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch
    from ..data.resident import ResidentCorpus
    from ..slu.generator import build_ontology_forest
    from ..slu.ka2g import KA2GModel
    from ..tasks.asr import ASRTask
    from ..tasks.generic import RunOptions, run_training
    from ..train.checkpoint import CheckpointManager
    from ..train.optim import OptimConfig
    from ..utils.device import cli_device

    dev = cli_device(args.device)
    t0 = time.time()
    train_dir, dev_dir, test_dir, onto = make_ka2g_corpus(
        args.corpus, n_train=args.n_train, n_dev=args.n_dev,
        n_test=args.n_test)
    log.info("corpus ready (%.1fs)", time.time() - t0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    token_list = build_vocab(read_2column_text(Path(train_dir) / "text"),
                             onto)
    tok2id = {t: i for i, t in enumerate(token_list)}
    (out / "tokens.txt").write_text("\n".join(token_list) + "\n")
    vocab_size = len(token_list)
    trie, roots = build_ontology_forest(
        [[[tok2id[w] for w in v] for v in slot_vals] for slot_vals in onto])

    resident = ResidentCorpus.from_datadirs([str(train_dir), str(dev_dir)],
                                            device=dev)

    def factory(d, use_tcpgen, shuffle):
        return make_factory(resident, d, tok2id, args.batch_size,
                            use_tcpgen, shuffle, trie, roots)

    def train_arm(tag, use_tcpgen):
        exp = out / f"exp_{tag}"
        model = KA2GModel(build_cfg(vocab_size, use_tcpgen), device=dev)
        run_training(
            exp_dir=str(exp), model=model,
            init_fn=lambda m, seed: ASRTask.init_params(m, seed),
            train_factory=factory(train_dir, use_tcpgen, shuffle=True),
            valid_factory=factory(dev_dir, use_tcpgen, shuffle=False),
            optim=OptimConfig(lr=1e-3, scheduler="warmuplr",
                              warmup_steps=800),
            run=RunOptions(max_epoch=args.max_epoch, keep_nbest=3,
                           nbest_average=3, log_interval=20))
        return exp, model

    # ---- evaluation: entity F1 on (slot, value) pairs ----
    test_uids, _, test_slots = load_split(test_dir)
    test_rc = ResidentCorpus.from_datadirs([str(test_dir)], device=dev)
    rare_sets = [set(tuple(v) for v in slot_vals[N_COMMON:])
                 for slot_vals in onto]

    def evaluate(model, use_forest):
        biasing = {}
        if use_forest:
            biasing = dict(
                trie={k: torch.from_numpy(v).to(dev)
                      for k, v in forest_arrays(trie).items()},
                roots=torch.from_numpy(roots).to(dev),
                boundary_mask=torch.zeros(vocab_size + 1, dtype=torch.bool,
                                          device=dev),
                dead=trie.dead)
        counts = [0] * 5
        bs = args.eval_batch
        order = sorted(test_uids, key=lambda u: test_rc.index[u][1])
        for i in range(0, len(order), bs):
            chunk = order[i:i + bs]
            if len(chunk) < bs:
                break
            t_pad = -(-max(test_rc.index[u][1] for u in chunk)
                      // 8192) * 8192
            speech, slens = test_rc.speech(chunk, t_pad)
            slot_logits, vals = model.generate(
                speech, torch.from_numpy(slens).to(dev), **biasing)
            entity_scores(slot_logits.float().cpu().numpy(),
                          vals.cpu().numpy(), chunk, test_slots,
                          token_list, rare_sets, counts)
        tp, fp, fn, rtp, rfn = counts
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        rare_rec = rtp / max(rtp + rfn, 1)
        return {"f1": round(f1, 4), "precision": round(prec, 4),
                "recall": round(rec, 4), "rare_recall": round(rare_rec, 4)}

    results_json = out / "results.json"
    results = (json.loads(results_json.read_text())
               if results_json.exists() else {})

    def arm(tag, use_tcpgen, use_forest):
        if tag in results:
            log.info("%s: cached %s", tag, results[tag])
            return
        exp, model = train_arm("tcpgen" if use_tcpgen else "nokb",
                               use_tcpgen)
        model.load_state_dict(CheckpointManager(exp, 3).load_params())
        results[tag] = evaluate(model, use_forest)
        results_json.write_text(json.dumps(results, indent=1))
        log.info("%s: %s", tag, results[tag])

    arm("nokb", use_tcpgen=False, use_forest=False)
    arm("tcpgen_forest", use_tcpgen=True, use_forest=True)
    arm("tcpgen_noforest", use_tcpgen=True, use_forest=False)

    lines = [
        "# RESULTS — KA2G slot-KB biasing campaign",
        "",
        f"Corpus: {args.n_train} train / {args.n_dev} dev / {args.n_test} "
        f"test. {N_SLOTS} slots x 40 two-word values each; values 10-39 of "
        "every slot are RARE (<= 2 train occurrences); test uses ONLY rare "
        "values (recipe/ka2g_run.py:make_ka2g_corpus). Model: Conformer "
        "6x144 encoder + CTC transcript loss + slot generator (slu/ka2g.py), "
        f"ontology-forest TCPGen in the KB arms; {args.max_epoch} epochs on "
        f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}.",
        "",
        "| arm | entity F1 | precision | recall | rare-value recall |",
        "|---|---|---|---|---|",
    ]
    for tag, r in results.items():
        lines.append(f"| {tag} | {r['f1']:.4f} | {r['precision']:.4f} | "
                     f"{r['recall']:.4f} | {r['rare_recall']:.4f} |")
    lines += ["", "Expected: tcpgen_forest F1 > nokb F1 (the KA2G claim: "
              "ontology biasing recovers rare entity values the no-KB "
              "model cannot)."]
    (out / "RESULTS_KA2G.md").write_text("\n".join(lines) + "\n")
    log.info("wrote %s (total %.0fs)", out / "RESULTS_KA2G.md",
             time.time() - t0)

    ok = True
    if "tcpgen_forest" in results and "nokb" in results:
        a, b = results["tcpgen_forest"], results["nokb"]
        checks = [
            ("tcpgen_forest F1 > nokb F1", a["f1"] > b["f1"]),
            ("tcpgen_forest rare recall > nokb rare recall",
             a["rare_recall"] > b["rare_recall"]),
        ]
        for name, cond in checks:
            (log.info if cond else log.error)(
                "CHECK %s: %s", "PASS" if cond else "FAIL", name)
            ok = ok and cond
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
