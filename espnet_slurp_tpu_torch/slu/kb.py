"""Biasing-list (knowledge base) management: tries, walks, sampling.

Port of espnet_slurp_tpu/slu/kb.py (plain numpy there, so this is the
port's own copy): ``FlatTrie``, ``build_trie``, ``boundary_token_ids``,
``walk_trie`` (both boundary conventions), ``BiasingBatch``,
``BiasingListSampler`` and ``TCPGenBatchAugmenter``. With the same seed the
tries, walks, ``ptr_label_mask`` and ``smoothprob_scale`` are the
reference's bit for bit (numpy and ``np.random.RandomState`` as there);
``TCPGenBatchAugmenter.augment`` returns CPU torch tensors where the
reference returns jnp arrays, which the Trainer and the prefetch thread
move to the device like any other batch key.

The fork's nested-dict trie (KB_utils/KB.py, lm_utils.py:make_lexical_tree)
is a flat padded table here: children token / node tables with a static
maximum branching, padded to bucket sizes, so that the TCPGen gathers see
few shapes. Training walks the teacher-forced tokens on the host
(``walk_trie``); decoding walks on the device (models/tcpgen.py:trie_step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

ROOT = 0


@dataclasses.dataclass
class FlatTrie:
    """Flattened lexical prefix tree.

    token[n]    : subword id on the edge INTO node n (root: 0).
    children_tok[n, k] / children_node[n, k]: padded child tables (pad: -1/0).
    n_children[n], word_end[n] (bool), n_nodes (true count; arrays padded).
    An extra DEAD node (index n_nodes-1... stored at `dead`) has no children.
    """
    token: np.ndarray
    children_tok: np.ndarray
    children_node: np.ndarray
    n_children: np.ndarray
    word_end: np.ndarray
    n_nodes: int
    dead: int

    @property
    def max_branch(self) -> int:
        return self.children_tok.shape[1]


def build_trie(word_pieces: Sequence[Sequence[int]],
               pad_nodes_multiple: int = 64,
               max_branch: Optional[int] = None) -> FlatTrie:
    """Build a flat trie from subword-id sequences (one per biasing word)."""
    children: List[Dict[int, int]] = [{}]  # node -> {tok: child}
    token: List[int] = [0]
    word_end: List[bool] = [False]
    for pieces in word_pieces:
        node = ROOT
        for p in pieces:
            p = int(p)
            nxt = children[node].get(p)
            if nxt is None:
                nxt = len(children)
                children[node][p] = nxt
                children.append({})
                token.append(p)
                word_end.append(False)
            node = nxt
        if node != ROOT:
            word_end[node] = True
    # dead node (no children) for out-of-tree states
    dead = len(children)
    children.append({})
    token.append(0)
    word_end.append(False)

    n = len(children)
    n_pad = ((n + pad_nodes_multiple - 1) // pad_nodes_multiple
             ) * pad_nodes_multiple
    mb = max((len(c) for c in children), default=1)
    if max_branch is not None:
        assert mb <= max_branch, f"branching {mb} > {max_branch}"
        mb = max_branch
    mb = max(mb, 1)
    ct = np.full((n_pad, mb), -1, np.int32)
    cn = np.full((n_pad, mb), 0, np.int32)
    nc = np.zeros((n_pad,), np.int32)
    for i, c in enumerate(children):
        for k, (t, ch) in enumerate(sorted(c.items())):
            ct[i, k] = t
            cn[i, k] = ch
        nc[i] = len(c)
    tok = np.zeros((n_pad,), np.int32)
    tok[:n] = token
    we = np.zeros((n_pad,), bool)
    we[:n] = word_end
    return FlatTrie(token=tok, children_tok=ct, children_node=cn,
                    n_children=nc, word_end=we, n_nodes=n, dead=dead)


def boundary_token_ids(token_list) -> Tuple[Set[int], bool]:
    """Word-boundary token ids + the marker convention.

    Returns (ids, prefix): suffix convention (reference fork: pieces END
    with '▁', decoders.py:259 endswith) when any token ends with the
    metaspace marker; otherwise prefix convention (HF-tokenizers Metaspace:
    word-INITIAL pieces START with '▁') — the walk semantics adapt via the
    ``prefix_boundary`` flag of walk_trie/trie_step.
    """
    # A bare '▁' token occurs in BOTH conventions (a word whose first
    # merge wasn't learned emits it in prefix vocabs too), so it must not
    # decide the convention by itself: require a MULTI-char suffix-marked
    # token, and prefer prefix when multi-char '▁'-initial tokens dominate
    # (a default HF-Metaspace vocab has many of those and no multi-char
    # suffix tokens).
    n_suffix = sum(1 for t in token_list
                   if len(t) > 1 and t.endswith("▁")
                   and not t.startswith("▁"))
    n_prefix = sum(1 for t in token_list
                   if len(t) > 1 and t.startswith("▁")
                   and not t.endswith("▁"))
    if n_suffix >= n_prefix and n_suffix > 0:
        return {i for i, t in enumerate(token_list)
                if t.endswith("▁") or t == "<space>"}, False
    return {i for i, t in enumerate(token_list)
            if t.startswith("▁")}, True


def walk_trie(trie: FlatTrie, prev_tokens: np.ndarray,
              boundary_ids: Set[int], eos_id: int,
              prefix_boundary: bool = False
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Teacher-forced walk (training): prev_tokens [B, U] (token emitted at
    step i-1; step 0 gets sos/eos -> root). Returns (node [B, U],
    p_gen_mask [B, U]) — mask=1 where the pointer is disabled (out-of-tree).

    Suffix convention (prefix_boundary=False) implements
    get_lextree_step_embs semantics (decoders.py:286-320):
      - eos -> reset to root, ptr active
      - word-boundary token: descend if it continues the tree with children,
        else reset to root; ptr active
      - in-tree token -> descend; ptr active
      - out-of-tree token -> DEAD; ptr disabled

    Prefix convention (prefix_boundary=True; '▁'-INITIAL pieces start a
    word): a word-initial token restarts the walk from root THROUGH that
    token; any descend that lands on a childless node (word complete)
    resets to root so the pointer can immediately score the next word's
    first piece — the same one-step-early decision the reference's
    boundary case makes. Out-of-tree tokens also reset to ROOT with the
    pointer LIVE (not DEAD/disabled): in this convention every next step
    may start a new word, and root's children are exactly the biasing
    words' first pieces — parking at DEAD would blind the pointer at the
    very step a biased word begins (the reference's suffix convention gets
    this for free because its boundary marker is the word's LAST piece,
    decoders.py:300-311). The OOKB sink absorbs mid-word continuations.
    """
    b, u = prev_tokens.shape
    node = np.zeros((b, u), np.int32)
    mask = np.zeros((b, u), np.int32)
    for i in range(b):
        cur = ROOT
        for j in range(u):
            y = int(prev_tokens[i, j])
            start = cur
            if prefix_boundary and y in boundary_ids:
                start = ROOT
            row = trie.children_tok[start, :trie.n_children[start]]
            hit = np.nonzero(row == y)[0]
            child = (int(trie.children_node[start, hit[0]])
                     if hit.size else None)
            if y == eos_id:
                cur, m = ROOT, 0
            elif prefix_boundary:
                if child is not None:
                    cur = child if trie.n_children[child] > 0 else ROOT
                else:
                    cur = ROOT
                m = 0
            elif y in boundary_ids:
                if child is not None and trie.n_children[child] > 0:
                    cur, m = child, 0
                else:
                    cur, m = ROOT, 0
            elif child is not None:
                cur, m = child, 0
            else:
                cur, m = trie.dead, 1
            node[i, j] = cur
            mask[i, j] = m
    return node, mask


@dataclasses.dataclass
class BiasingBatch:
    """Per-batch biasing inputs fed to the TCPGen layer."""
    trie_token: np.ndarray       # [N]
    trie_children_tok: np.ndarray   # [N, MB]
    trie_children_node: np.ndarray  # [N, MB]
    trie_n_children: np.ndarray  # [N]
    node: np.ndarray             # [B, U] walk result (training only)
    p_gen_mask: np.ndarray       # [B, U]

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dataclasses.asdict(self)


class BiasingListSampler:
    """Training-time biasing list construction (KBmeetingTrain analogue,
    KB.py:120-230): for each batch, take the rare words present in the
    references plus random distractors, with dropout (DBdrop)."""

    def __init__(self, full_list: Sequence[Sequence[int]],
                 n_distractors: int = 50, drop_prob: float = 0.0,
                 seed: int = 0):
        self.full_list = [tuple(int(p) for p in w) for w in full_list]
        self.index = {w: i for i, w in enumerate(self.full_list)}
        self.n_distractors = n_distractors
        self.drop_prob = drop_prob
        self.rng = np.random.RandomState(seed)

    def sample(self, reference_words: Sequence[Sequence[int]]
               ) -> List[Tuple[int, ...]]:
        present = []
        for w in reference_words:
            w = tuple(int(p) for p in w)
            if w in self.index:
                if self.drop_prob > 0 and self.rng.rand() < self.drop_prob:
                    continue  # DBdrop: sometimes omit true biasing words
                present.append(w)
        chosen = set(present)
        n_extra = min(self.n_distractors, len(self.full_list))
        for i in self.rng.permutation(len(self.full_list))[:n_extra]:
            chosen.add(self.full_list[i])
        return sorted(chosen)


class TCPGenBatchAugmenter:
    """Per-batch biasing for TCPGen training — the fork's KBmeetingTrain +
    PtrSche recipe (KB.py:120-230; conf/train_slu_tcpgen_gcn.yaml:
    KBmaxlen 20, randomKBsample, DBdrop 0.3; decoders.py:777 epoch ramp).

    Each batch gets a FRESH small trie: the biasing words found in the
    batch's references (each dropped with prob ``db_drop`` so the model
    cannot over-rely on the pointer) plus random distractors up to
    ``kb_len`` words. A small, mostly-present list is what makes the
    pointer precise enough during training for the generation gate to
    learn to open — a static full-list trie starves it of positive signal.

    All trie arrays are padded to FIXED shapes (kb_len-derived), so the
    jitted train step compiles once. ``start_epoch``/``sched_epochs``
    emit a ``smoothprob_scale`` scalar per batch: 0 before ``start_epoch``
    (pointer branch inert — the reference's PtrSche gate, decoders.py:702:
    the SLURP recipe trains the plain model 20 epochs first, which is what
    keeps the generation gate from collapsing against an untrained
    pointer), then ramping to 1 over ``sched_epochs`` (the fullepoch
    curriculum, decoders.py:777).

    Use ``wrap(iter_factory)`` to augment an ASRTask iterator factory.
    """

    def __init__(self, word_pieces: Sequence[Sequence[int]],
                 boundary_ids: Set[int], sos_id: int, eos_id: int,
                 prefix_boundary: bool = False, kb_len: int = 20,
                 db_drop: float = 0.3, sched_epochs: int = 0,
                 start_epoch: int = 0, seed: int = 0):
        words = sorted({tuple(int(p) for p in w) for w in word_pieces
                        if len(w)})
        if not words:
            raise ValueError("empty biasing list")
        self.words = words
        self.kb_len = min(kb_len, len(words))
        self.db_drop = db_drop
        self.sched_epochs = sched_epochs
        self.start_epoch = start_epoch
        self.boundary_ids = boundary_ids
        self.prefix_boundary = prefix_boundary
        self.sos_id = sos_id
        self.eos_id = eos_id
        self.rng = np.random.RandomState(seed)
        # " id id " substring patterns for presence search (word-boundary
        # guarded); C-level `in` beats a python subsequence scan.
        self._pats = [" " + " ".join(map(str, w)) + " " for w in words]
        max_pieces = max(len(w) for w in words)
        need = self.kb_len * max_pieces + 2  # + root + dead
        self.pad_nodes = -(-need // 64) * 64
        self.max_branch = self.kb_len

    def sample_words(self, text_ids: np.ndarray) -> List[Tuple[int, ...]]:
        """Biasing list for one batch of padded reference ids [B, U]."""
        rows = [" " + " ".join(str(int(i)) for i in row if i >= 0) + " "
                for row in text_ids]
        chosen = []
        for w, pat in zip(self.words, self._pats):
            if any(pat in s for s in rows):
                if self.db_drop > 0 and self.rng.rand() < self.db_drop:
                    continue
                chosen.append(w)
        if len(chosen) > self.kb_len:
            keep = self.rng.permutation(len(chosen))[: self.kb_len]
            chosen = [chosen[i] for i in sorted(keep)]
        elif len(chosen) < self.kb_len:
            have = set(chosen)
            pool = [w for w in self.words if w not in have]
            for i in self.rng.permutation(len(pool))[
                    : self.kb_len - len(chosen)]:
                chosen.append(pool[i])
        return sorted(chosen)

    def augment(self, batch: Dict, epoch: int) -> Dict:
        text = np.asarray(batch["text"])
        trie = build_trie(self.sample_words(text),
                          pad_nodes_multiple=self.pad_nodes,
                          max_branch=self.max_branch)
        # Start column uses eos_id regardless of sos: the walk's eos case
        # is "reset to root, pointer live", which is exactly the sequence-
        # start state (decode-time search also starts at root) — a
        # distinct sos id must not park the first step at DEAD.
        ys_in = np.concatenate(
            [np.full((text.shape[0], 1), self.eos_id, np.int32),
             np.maximum(text, 0).astype(np.int32)], axis=1)
        node, mask = walk_trie(trie, ys_in, self.boundary_ids, self.eos_id,
                               prefix_boundary=self.prefix_boundary)
        # Oracle pointer labels (att_labs analogue) over LIVE steps:
        #   1 -> the target is a child of node[j]: point at it;
        #   2 -> it is not: the correct pointer action is the OOKB sink
        #        (which routes the generation mass back to the model);
        #   0 -> pointer masked / padding: no supervision.
        # Supervising BOTH cases trains the attention to discriminate,
        # which makes a nonzero p_gen harmless off the biasing list — the
        # precondition for the gate to learn to open at all.
        tgt = np.concatenate(
            [np.maximum(text, 0).astype(np.int32),
             np.full((text.shape[0], 1), self.eos_id, np.int32)], axis=1)
        # Replace padded-slot targets with eos: each row's true eos step is
        # at column L (its length), not the appended column U.
        lengths = (text >= 0).sum(axis=1)
        tgt = np.where(np.arange(tgt.shape[1])[None, :]
                       == lengths[:, None], self.eos_id, tgt)
        b, u = node.shape
        # Position j supervises target j of [text..., eos]: valid iff
        # j <= L (j == L is the real eos step; beyond is padding — the
        # earlier hardcoded zeros column supervised decoder state over
        # padding for every short row).
        pad = np.arange(u)[None, :] > lengths[:, None]
        ct = trie.children_tok[node.reshape(-1)]          # [B*U, MB]
        nc = trie.n_children[node.reshape(-1)]            # [B*U]
        valid = np.arange(ct.shape[1])[None, :] < nc[:, None]
        hit = ((ct == tgt.reshape(-1)[:, None]) & valid).any(axis=1)
        hit = hit.reshape(b, u)
        live = (mask == 0) & ~pad
        ptr_label = np.where(live & hit, 1,
                             np.where(live, 2, 0)).astype(np.int32)
        out = dict(batch)
        for key, value in (("trie_token", trie.token),
                           ("trie_children_tok", trie.children_tok),
                           ("trie_children_node", trie.children_node),
                           ("trie_n_children", trie.n_children),
                           ("node", node), ("p_gen_mask", mask),
                           ("ptr_label_mask", ptr_label)):
            out[key] = torch.from_numpy(np.ascontiguousarray(value))
        if self.sched_epochs > 0 or self.start_epoch > 0:
            past = epoch - self.start_epoch
            scale = (0.0 if past <= 0
                     else min(1.0, past / max(self.sched_epochs, 1)))
            out["smoothprob_scale"] = torch.tensor(scale, dtype=torch.float32)
        return out

    def wrap(self, base_factory):
        def factory(epoch):
            for batch in base_factory(epoch):
                yield self.augment(batch, epoch)
        return factory
