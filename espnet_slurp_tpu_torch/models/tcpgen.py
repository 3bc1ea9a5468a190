"""TCPGen: tree-constrained pointer generator over GNN-encoded prefix trees.

Port of espnet_slurp_tpu/models/tcpgen.py: the four tree encoders
(``GCNTreeEncoder``, ``GATTreeEncoder``, ``SageTreeEncoder``,
``TreeLSTMEncoder``), ``TCPGen`` (``encode_tree``, ``forward``,
``gen_prob``), ``tcpgen_final_logprobs`` and ``trie_step``. The modules and
parameters carry the flax names (``Qproj``, ``Kproj``, ``pointer_gate``,
``ooKBemb``, ``tree_encoder.gcn_l{i}`` ...), so utils/params.py maps the
reference's tree onto them. Parameters are fp32 and every layer computes in
``dtype``, as the flax modules do; the pointer scores, their softmax and
the vocab scatter are fp32 (the reference's ``preferred_element_type``),
the softmax weights are cast to ``dtype`` before they weight the keys, and
the generation gate's sigmoid is fp32.

The trie is the flat table of slu/kb.py; every position of a
teacher-forced batch is scored in one batched gather + einsum (the fork's
decoders.py loops per step), the GCN is two gathers and a product a layer,
and the decode-time walk is a vectorised compare and select
(``trie_step``). None of it is a kernel in the reference: plain tensor ops
here too.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear

Trie = Dict[str, torch.Tensor]


def _child_mask(n_children: torch.Tensor, mb: int) -> torch.Tensor:
    """[..., MB] bool: slot k holds a child (k < n_children)."""
    return (torch.arange(mb, device=n_children.device)
            < n_children[..., None])


class GCNTreeEncoder(nn.Module):
    """GCN over the trie: h' = relu(D^-1/2 A D^-1/2 (h W)), A = self +
    children, degree 1 + n_children (the fork's forward_gcn)."""

    def __init__(self, d_model: int, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"gcn_l{i + 1}", Linear(d_model, d_model))

    def forward(self, node_feats, children_node, n_children):
        """node_feats [N, D]; children_node [N, MB]; n_children [N] ->
        [N, D]."""
        cn = children_node.long()
        norm = torch.rsqrt(1.0 + n_children.float())[:, None]
        kmask = _child_mask(n_children, cn.shape[1])[..., None]
        h = node_feats.to(self.dtype)
        for i in range(self.num_layers):
            h1 = getattr(self, f"gcn_l{i + 1}")(h)
            gn = h1 * norm.to(h1.dtype)
            child = gn[cn] * kmask.to(gn.dtype)
            h = F.relu((gn + child.sum(dim=1)) * norm.to(gn.dtype))
        return h


class GATTreeEncoder(nn.Module):
    """Graph attention over the trie (the fork's GAT.py:GATLayerImp2): per
    layer, node i attends over {i} and its children with e_ij =
    leakyrelu_0.2(a_src . Wh_i + a_tgt . Wh_j); a raw skip where the input
    width equals the head width, else a projected one; heads concatenated
    with ELU on all but the last layer, which has one head and no
    activation; then a bias. Fixed-slot gathers over [N, 1 + MB]."""

    def __init__(self, d_model: int, num_layers: int = 2, n_head: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.n_head, self.dtype = num_layers, n_head, dtype
        f = self.f = d_model
        width = d_model
        for li in range(num_layers):
            nh = 1 if li == num_layers - 1 else n_head
            self.add_module(f"proj_l{li}", Linear(width, nh * f, bias=False))
            self.register_parameter(f"a_src_l{li}",
                                    nn.Parameter(torch.zeros(nh, f)))
            self.register_parameter(f"a_tgt_l{li}",
                                    nn.Parameter(torch.zeros(nh, f)))
            if width != f:
                self.add_module(f"skip_l{li}",
                                Linear(width, nh * f, bias=False))
            out = f if li == num_layers - 1 else nh * f
            self.register_parameter(f"bias_l{li}",
                                    nn.Parameter(torch.zeros(out)))
            width = out

    def forward(self, node_feats, children_node, n_children):
        cn = children_node.long()
        n, f, dt = cn.shape[0], self.f, self.dtype
        nbr = torch.cat([torch.arange(n, device=cn.device)[:, None], cn], 1)
        ok = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=cn.device),
                        _child_mask(n_children, cn.shape[1])], 1)
        h = node_feats.to(dt)
        for li in range(self.num_layers):
            last = li == self.num_layers - 1
            nh = 1 if last else self.n_head
            p = lambda name: getattr(self, f"{name}_l{li}")
            proj = p("proj")(h).reshape(n, nh, f)
            s_self = (proj * p("a_src").to(dt)[None]).sum(-1)   # [N, NH]
            s_nbr = (proj * p("a_tgt").to(dt)[None]).sum(-1)
            e = F.leaky_relu(s_self[:, None, :] + s_nbr[nbr], 0.2)
            e = torch.where(ok[..., None], e, torch.full_like(e, -1e9))
            alpha = torch.softmax(e, dim=1)                     # [N, K, NH]
            out = torch.einsum("nkh,nkhf->nhf", alpha.to(dt), proj[nbr])
            if h.shape[-1] == f:
                out = out + h[:, None, :]
            else:
                out = out + p("skip")(h).reshape(n, nh, f)
            out = out.mean(dim=1) if last else out.reshape(n, nh * f)
            out = out + p("bias").to(dt)
            h = out if last else F.elu(out)
        return h


class SageTreeEncoder(nn.Module):
    """GraphSAGE max-pool over children (the fork's forward_sage): pooled_i
    = max_k relu(pool(h_child_k)) (0 for a leaf); h_i' = relu(merge([h_i;
    pooled_i]))."""

    def __init__(self, d_model: int, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(1, num_layers + 1):
            self.add_module(f"sage_pool_{i}", Linear(d_model, d_model))
            self.add_module(f"sage_merge_{i}", Linear(2 * d_model, d_model))

    def forward(self, node_feats, children_node, n_children):
        cn = children_node.long()
        valid = _child_mask(n_children, cn.shape[1])[..., None]
        leaf = (n_children <= 0)[:, None]
        h = node_feats.to(self.dtype)
        for i in range(1, self.num_layers + 1):
            pooled = F.relu(getattr(self, f"sage_pool_{i}")(h))
            child = pooled[cn]
            child = torch.where(valid, child, torch.full_like(child, -1e9))
            # amax shares the gradient among tied maxima, as jnp.max does.
            pooled = child.amax(dim=1)
            pooled = torch.where(leaf, torch.zeros_like(pooled), pooled)
            h = F.relu(getattr(self, f"sage_merge_{i}")(
                torch.cat([h, pooled], dim=-1)))
        return h


class TreeLSTMEncoder(nn.Module):
    """Child-sum Tree-LSTM (the fork's forward_treelstm_cell): i / o / u
    from [sum_k h_k; x_j], a forget gate per child from [h_k; x_j], c_j =
    i u + sum_k f_k c_k, h_j = o tanh(c_j). The recursive bottom-up walk is
    ``n_iters`` synchronous sweeps over the flat trie: after depth(T)
    sweeps every node holds its recursive value."""

    def __init__(self, d_model: int, n_iters: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_iters, self.dtype = d_model, n_iters, dtype
        self.iou_gate = Linear(2 * d_model, 3 * d_model)
        self.forget_gate = Linear(2 * d_model, d_model)

    def forward(self, node_feats, children_node, n_children):
        cn = children_node.long()
        n = cn.shape[0]
        valid = _child_mask(n_children, cn.shape[1])[..., None]
        x = node_feats.to(self.dtype)
        x_k = x[:, None].expand(n, cn.shape[1], x.shape[-1])
        h = torch.zeros(n, self.d_model, dtype=self.dtype, device=x.device)
        c = torch.zeros_like(h)
        for _ in range(self.n_iters):
            zero = torch.zeros((), dtype=h.dtype, device=h.device)
            h_k = torch.where(valid, h[cn], zero)
            c_k = torch.where(valid, c[cn], zero)
            g = self.iou_gate(torch.cat([h_k.sum(dim=1), x], dim=-1))
            i_j, o_j, u_j = g.chunk(3, dim=-1)
            f_k = torch.sigmoid(self.forget_gate(torch.cat([h_k, x_k], -1)))
            c = (torch.sigmoid(i_j) * torch.tanh(u_j)
                 + torch.where(valid, f_k * c_k, zero).sum(dim=1))
            h = torch.sigmoid(o_j) * torch.tanh(c)
        return h


TREE_ENCODERS = {"gcn": GCNTreeEncoder, "gat": GATTreeEncoder,
                 "sage": SageTreeEncoder, "treelstm": TreeLSTMEncoder}


class TCPGen(nn.Module):
    """Pointer network over the current node's children plus the OOKB sink.

    ``forward`` is position-batched: queries [..., D] and node ids [...] of
    any leading shape ([B, U] in training, [N] hypotheses in decoding).
    ``tree_encoder`` names the GNN over the trie. The reference's
    ``dropout_rate`` field is unused there and not taken here."""

    def __init__(self, d_model: int, vocab_size: int, gcn_layers: int = 2,
                 tree_encoder: str = "gcn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if tree_encoder not in TREE_ENCODERS:
            raise ValueError(f"unknown tree encoder {tree_encoder!r}; "
                             f"choices: {sorted(TREE_ENCODERS)}")
        self.d_model, self.vocab_size, self.dtype = d_model, vocab_size, dtype
        self.Qproj = Linear(d_model, d_model)
        self.Kproj = Linear(d_model, d_model)
        self.pointer_gate = Linear(2 * d_model, 1)
        self.ooKBemb = nn.Parameter(torch.zeros(1, d_model))
        enc = TREE_ENCODERS[tree_encoder]
        self.tree_encoder = (enc(d_model, dtype=dtype)
                             if tree_encoder == "treelstm"
                             else enc(d_model, gcn_layers, dtype=dtype))

    def encode_tree(self, token_embs: torch.Tensor, trie: Trie
                    ) -> torch.Tensor:
        """Every trie node once a batch: token_embs [N, D] (the embedding
        of each node's incoming token, from the decoder's table) -> [N,
        D]."""
        return self.tree_encoder(token_embs, trie["trie_children_node"],
                                 trie["trie_n_children"])

    def forward(self, queries: torch.Tensor, node_ids: torch.Tensor,
                trie: Trie, tree_encs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (ptr_dist [..., V+1] fp32 (the last column is OOKB), kb_emb
        [..., D] in ``dtype``)."""
        dt, v = self.dtype, self.vocab_size
        nid = node_ids.long()
        ct = trie["trie_children_tok"].long()[nid]        # [..., MB]
        cn = trie["trie_children_node"].long()[nid]
        nc = trie["trie_n_children"][nid]
        mb = ct.shape[-1]
        keys = self.Kproj(tree_encs.to(dt)[cn])           # [..., MB, D]
        ookb_key = self.Kproj(self.ooKBemb.to(dt))[0]     # [D]
        q = self.Qproj(queries.to(dt))
        scale = 1.0 / math.sqrt(self.d_model)
        # bf16 products are exact in fp32: fp32 operands give the scores the
        # reference's preferred_element_type gives.
        s_child = torch.einsum("...kd,...d->...k", keys.float(),
                               q.float()) * scale
        valid = _child_mask(nc, mb)
        s_child = torch.where(valid, s_child, torch.full_like(s_child, -1e9))
        s_ookb = (q.float() @ ookb_key.float())[..., None] * scale
        w = torch.softmax(torch.cat([s_child, s_ookb], dim=-1), dim=-1)
        kb_emb = torch.einsum("...k,...kd->...d", w[..., :mb].to(dt), keys)
        # The children's weights into the vocab axis; empty slots point at
        # the OOKB column with weight 0.
        tok = torch.where(valid, ct, torch.full_like(ct, v)).reshape(-1, mb)
        wf = w[..., :mb].reshape(-1, mb)
        n = tok.shape[0]
        ptr = torch.zeros(n, v + 1, dtype=torch.float32, device=w.device)
        ptr = ptr.scatter_add(1, tok, wf)
        ptr = ptr.scatter_add(1, torch.full((n, 1), v, device=w.device),
                              w[..., mb:].reshape(n, 1))
        return ptr.reshape(*ct.shape[:-1], v + 1), kb_emb

    def gen_prob(self, hidden: torch.Tensor, kb_emb: torch.Tensor,
                 p_gen_mask: torch.Tensor, smoothprob=1.0) -> torch.Tensor:
        """p_gen = sigmoid(gate([hidden; kb_emb])) * smoothprob in fp32, 0
        where the walk left the tree (the fork's decoders.py:771-781)."""
        z = self.pointer_gate(torch.cat([hidden.to(self.dtype),
                                         kb_emb.to(self.dtype)], dim=-1))
        g = torch.sigmoid(z.float())[..., 0] * smoothprob
        return torch.where(p_gen_mask.to(g.device) > 0,
                           torch.zeros_like(g), g)


def tcpgen_final_logprobs(logits: torch.Tensor, ptr_dist: torch.Tensor,
                          p_gen: torch.Tensor) -> torch.Tensor:
    """log p, p = ptr[:, :V] p_gen + softmax(logits) (1 - p_gen + p_gen
    ptr[:, V]): the OOKB mass flows back through the model's distribution
    (the fork's calc_ptr_loss)."""
    v = logits.shape[-1]
    p_model = torch.softmax(logits.float(), dim=-1)
    pg = p_gen[..., None]
    p = (ptr_dist[..., :v] * pg
         + p_model * (1.0 - pg + pg * ptr_dist[..., v:v + 1]))
    return torch.log(p + 1e-9)


def trie_step(trie: Trie, node: torch.Tensor, y: torch.Tensor,
              boundary_mask: torch.Tensor, eos_id: int, dead: int, root=0,
              prefix_boundary: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode-time walk: (node [N], chosen token y [N]) -> (new node
    [N], p_gen_mask [N]), both long.

    ``boundary_mask`` [V+1] bool marks word-boundary tokens. The suffix
    convention (tokens ending in '▁' / <space>) is the fork's
    get_lextree_step_embs_inference; the prefix convention ('▁'-initial
    pieces) restarts from ``root`` through a word-initial token and resets
    to ``root`` when a descend completes a word or leaves the tree, the
    pointer live (mask 0), as slu/kb.py:walk_trie walks in training.
    ``root`` is the reset target on eos and word boundaries: 0, or an [N]
    tensor of per-hypothesis roots."""
    y = y.long()
    node = node.long()
    is_eos = y == eos_id
    is_boundary = boundary_mask.to(y.device)[y]
    root = torch.as_tensor(root, device=y.device).long().expand_as(y)
    start = torch.where(is_boundary, root, node) if prefix_boundary else node
    ct = trie["trie_children_tok"].long()[start]     # [N, MB]
    cn = trie["trie_children_node"].long()[start]
    nc = trie["trie_n_children"].long()
    hit = (ct == y[:, None]) & _child_mask(nc[start], ct.shape[1])
    found = hit.any(dim=1)
    child = torch.where(hit, cn, torch.zeros_like(cn)).sum(dim=1)
    child_nc = nc[child]
    if prefix_boundary:
        desc = torch.where(child_nc > 0, child, root)
        new_node = torch.where(is_eos, root, torch.where(found, desc, root))
        return new_node, torch.zeros_like(new_node)
    boundary_node = torch.where(found & (child_nc > 0), child, root)
    in_tree = torch.where(found, child, torch.full_like(child, dead))
    new_node = torch.where(is_eos, root,
                           torch.where(is_boundary, boundary_node, in_tree))
    p_gen_mask = (~(is_eos | is_boundary) & ~found).long()
    return new_node, p_gen_mask
