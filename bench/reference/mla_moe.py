"""Plain float32 reference of the MLA MoE family (kanana-2-30b-a3b).

Written from the published architecture (``deepseek_v3``'s
``modeling_deepseek_v3``: https://huggingface.co/kakaocorp/
kanana-2-30b-a3b-instruct-2601) and the configuration file alone; it
imports nothing of the program under test.  Each layer is a pre-norm
multi-head latent attention, then a pre-norm FFN: a dense gated SiLU MLP
in the leading ``mla`` layers, the routed experts and a shared expert in
the ``mla_moe`` layers.  A final norm and an untied LM head.

* **Attention**, always in its decompressed form (no absorption, no cache):
  q = a @ wq per head, split into ``qk_nope_head_dim`` dims and
  ``qk_rope_head_dim`` rotary dims; [c, k_pe] = a @ w_kv_a, c normed by
  ``kv_norm`` (RMSNorm); each head's key and value dims = c @ w_kv_b; the
  head's key is its ``qk_nope_head_dim`` dims and the shared rotary key;
  rotary on q's and the key's rotary dims (``rope_interleave``: the pairs
  (2i, 2i+1), gathered as halves first, as ``apply_rotary_pos_emb_
  interleave`` does); causal softmax at scale 1/sqrt(Dn + Dr); out @ wo.
  Computed in blocks of queries so that a long prompt's scores fit.
* **Router** (``scoring_func`` sigmoid, ``noaux_tc``, one group): scores =
  sigmoid(f @ w_router); the ``num_experts_per_tok`` largest of scores +
  ``router_bias`` pick (ties in expert order); the picked scores, over
  their sum plus 1e-20, times ``routed_scaling``, weigh.
* **Experts**: gated SiLU FFNs of ``d_ff``; a shared gated expert of
  ``shared_expert_ff`` every token runs, added.

Departures from the published model, each shared with the program: the
RMSNorm scales are applied as ``1 + w``; the experts have a capacity per
call, ``max(ceil(T * k / E * cf), k)`` copies over the T tokens of one
call, in token then rank order, and a copy past it is dropped (the
published model is dropless); a decode call of the cell's rows drops
nothing (``decode_drops_nothing``), so the extension runs dropless.

Precision: every weight product (the router's too) goes through ``prec``
(``F32``, the control's ``FP8``, the ``BF16`` witness), and attention's
q.k and p@v through ``prec.cast``, as in ``bench.reference.common``; the
norms, rotary, softmax and residual stay in float32.

A job's prefill rows (the whole call: the capacity couples them) run from
nothing, attention a row at a time; its extension attends over its own
row's keys and values, then its own positions, one at a time.  ``routes`` collects, per MoE layer,
each extension position's experts.  The calls go through every layer one
pass at a time (``hybrid_moe.passes``), so that only one pass's activations
live beside the served weights; each layer's weights are upcast as the
pass reaches it, each expert's as it is read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import F32, NEG_INF, Job, no_tf32, rms_norm
from bench.reference.hybrid_moe import HEAD_COLUMNS, _mm, passes
from bench.reference.moe import capacity, decode_drops_nothing  # noqa: F401

COUPLED_ROWS = True       # the prefill rows a job needs: the whole call
QUERY_BLOCK = 256         # attention's queries per block of scores
TOKEN_BLOCK = 8192        # tokens per block of a dense FFN's products
EXPERT_LEAVES = ("w_gate", "w_in", "w_out")


def rope(x, pos, m):
    """Rotary on x (R, S, H, Dr) at positions ``pos`` (S,)."""
    d = x.shape[-1]
    w = d // 2
    if m.get("rope_interleave"):
        x = x.unflatten(-1, (w, 2)).transpose(-1, -2).flatten(-2)
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        w, dtype=torch.float32, device=x.device) / w))
    ang = pos.float()[:, None] * inv                       # (S, W)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :w], x[..., w:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, q_pos, k_pos, scale, prec):
    """Causal attention, one key and value per query head, over query
    blocks: q (R, Sq, H, Dq), k (R, Sk, H, Dq), v (R, Sk, H, Dv), key
    positions ``k_pos`` ascending -> (R, Sq, H*Dv).  A block reads the keys
    up to its last query's position alone: the later ones would weigh
    exactly 0."""
    r, sq, h, _ = q.shape
    kc, vc = prec.cast(k, -1), prec.cast(v, -1)
    out = []
    for i in range(0, sq, QUERY_BLOCK):
        qp = q_pos[i:i + QUERY_BLOCK]
        n = int(torch.searchsorted(k_pos, qp[-1:], right=True))
        qb = prec.cast(q[:, i:i + QUERY_BLOCK], -1)
        s = torch.einsum("rqhd,rshd->rhqs", qb, kc[:, :n]) * scale
        s.masked_fill_(k_pos[None, :n] > qp[:, None], NEG_INF)
        prob = torch.softmax(s, dim=-1)
        del s
        o = torch.einsum("rhqs,rshv->rqhv", prec.cast(prob, -1), vc[:, :n])
        out.append(o.reshape(r, qb.shape[1], -1))
        del prob
    return torch.cat(out, 1)


def mla(a, w, m, prec, pos, past=None):
    """a (R, S, d) at positions ``pos`` -> (y, k, v): the output and these
    positions' decompressed keys and values; ``past`` is (k, v, positions)
    of earlier ones."""
    r, s, _ = a.shape
    h, rank = m["num_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    q = _mm(prec, a, w["wq"]).reshape(r, s, h, dn + dr)
    kv = _mm(prec, a, w["w_kv_a"])
    c = rms_norm(kv[..., :rank], w["kv_norm"], m["norm_eps"])
    k_pe = rope(kv[..., rank:][:, :, None], pos, m).expand(r, s, h, dr)
    kvb = _mm(prec, c, w["w_kv_b"]).reshape(r, s, h, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe], -1)
    v = kvb[..., dn:]
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, m)], -1)
    kk, vv, kpos = k, v, pos
    if past is not None:
        kk, vv = torch.cat([past[0], k], 1), torch.cat([past[1], v], 1)
        kpos = torch.cat([past[2], pos])
    o = attention(q, kk, vv, pos, kpos, 1.0 / math.sqrt(dn + dr), prec)
    return _mm(prec, o, w["wo"]), k, v


def mlp(f, w, prec):
    """A gated SiLU MLP on f (T, d), in blocks of ``TOKEN_BLOCK`` tokens
    (every precision scales per token and per weight column, so a block
    is the whole's)."""
    mm = prec.mm
    return torch.cat([mm(F.silu(mm(b, w["w_gate"])) * mm(b, w["w_in"]),
                         w["w_out"]) for b in f.split(TOKEN_BLOCK)])


def route(f, p, m, prec):
    """The experts (T, k) and their weights (T, k) of f (T, d)."""
    scores = torch.sigmoid(prec.mm(f, p["w_router"]))
    choice = scores + p["router_bias"]
    ids = torch.sort(choice, dim=-1, descending=True,
                     stable=True)[1][:, :m["num_experts_per_tok"]]
    picked = scores.gather(1, ids)
    gates = picked / (picked.sum(-1, keepdim=True) + 1e-20) \
        * m["routed_scaling"]
    return ids, gates


def ffn(f, w, m, prec, coupled, route_out):
    """f (T, d) through the layer's FFN: the dense MLP, or the routed
    experts (a call's capacity where ``coupled``) and the shared expert."""
    if "mlp" in w:
        return mlp(f, w["mlp"], prec)
    p = w["moe"]
    ids, gates = route(f, p, m, prec)
    t, k = ids.shape
    flat = ids.reshape(-1)                        # (token, rank) order
    keep = torch.ones_like(flat, dtype=torch.bool)
    if coupled:
        onehot = F.one_hot(flat, m["num_experts"])
        rank = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
        keep = rank < capacity(t, m)
        del onehot
    # The kept copies grouped by expert, in (token, rank) order within each.
    kept = keep.nonzero()[:, 0]
    kept = kept[torch.sort(flat[kept], stable=True)[1]]
    counts = torch.bincount(flat[kept], minlength=m["num_experts"]).tolist()
    token = kept // k
    weight = gates.reshape(-1)[kept]
    out = torch.zeros_like(f)
    start = 0
    for e, n in enumerate(counts):
        if n:
            sel = slice(start, start + n)
            expert = {name: p[name][e].float() for name in EXPERT_LEAVES}
            out.index_add_(0, token[sel], mlp(f[token[sel]], expert, prec)
                           * weight[sel][:, None])
        start += n
    if route_out is not None:
        route_out.append(ids)
    return out + mlp(f, p["shared"], prec)


def _layer(tree: dict, i=None, experts: bool = False) -> dict:
    """Layer ``i`` of a stacked block tree (the tree itself where None),
    upcast to float32; the routed experts' leaves stay in their stored
    dtype (``ffn`` upcasts each expert as it reads it: all 128 at once
    would take 2.4 GB a layer)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, i, experts=k == "moe")
        else:
            leaf = v if i is None else v[i]
            out[k] = leaf if experts and k in EXPERT_LEAVES else leaf.float()
    return out


def layer_stack(weights: dict, m: dict):
    """(kind, float32 weights) of each layer in order: the groups' stacked
    layers, then the tail."""
    pattern = list(m["pattern"])
    groups, rest = divmod(m["num_layers"], len(pattern))
    for g in range(groups):
        for i, kind in enumerate(pattern):
            yield kind, _layer(weights["groups"][i], g)
    for i in range(rest):
        yield pattern[i], _layer(weights["tail"][i])


def _run_pass(weights, m, calls: list[list[Job]], prec, routes) -> dict:
    """Every layer over one pass's prefill calls (each a list of its jobs)
    and their jobs' extensions; returns id(job) -> its prefill row's last
    position and its extension positions, hidden (n + 1, d)."""
    dev = weights["embed"].device
    embed, eps = weights["embed"], m["norm_eps"]
    state = [embed[js[0].rows.to(dev).long()].float() for js in calls]
    ext = {}
    for js in calls:
        for j in js:
            j.routes = []
            ext[id(j)] = embed[j.extend.to(dev).long()].float()[None]
    length = state[0].shape[1]
    pos = torch.arange(length, device=dev)
    for kind, w in layer_stack(weights, m):
        for c, js in enumerate(calls):
            x = state[c]
            r, _, d = x.shape
            # Attention row by row (rows attend independently), keeping the
            # keys and values of the rows whose jobs extend.
            a = rms_norm(x, w["norm1"], eps)
            extend = {j.row for j in js if j.extend.numel()}
            ys, past = [], {}
            for i in range(r):
                y, k, v = mla(a[i:i + 1], w["mla"], m, prec, pos)
                ys.append(y)
                if i in extend:
                    past[i] = (k, v, pos)
                del k, v
            x = x + torch.cat(ys)
            del a, ys
            f = rms_norm(x, w["norm2"], eps).reshape(r * length, d)
            state[c] = x + ffn(f, w, m, prec, True, None).reshape(
                r, length, d)
            del x, y, f
            for j in js:
                e = ext[id(j)]
                n = e.shape[1]
                if n == 0:
                    continue
                epos = torch.arange(length, length + n, device=dev)
                y, _, _ = mla(rms_norm(e, w["norm1"], eps), w["mla"], m,
                              prec, epos, past[j.row])
                e = e + y
                f = rms_norm(e, w["norm2"], eps)[0]
                got = [] if routes and kind == "mla_moe" else None
                ext[id(j)] = e + ffn(f, w, m, prec, False, got)[None]
                if got:
                    j.routes.append(got[0])
            del past
        del w
    return {id(j): torch.cat([state[c][j.row, -1:], ext[id(j)][0]], 0)
            for c, js in enumerate(calls) for j in js}


def logits(weights, m, jobs: list[Job], *, prec=F32, routes=False):
    """Logits (n + 1, V) of each job: its prefill row's last position,
    then each extension position."""
    no_tf32()
    groups: dict[int, list[Job]] = {}
    for j in jobs:
        groups.setdefault(j.group, []).append(j)
    last = {}                     # id(job) -> its rows for the head
    for keys in passes({g: tuple(js[0].rows.shape) for g, js in
                        groups.items()}):
        last.update(_run_pass(weights, m, [groups[g] for g in keys], prec,
                              routes))
    rows = [last[id(j)] for j in jobs]
    h = rms_norm(torch.cat(rows), weights["final_norm"], m["norm_eps"])
    # The head in blocks of its columns (every precision scales per row of
    # h and per column of the head, so a block is the whole's).
    vocab, head = m["vocab_size"], weights["lm_head"]
    logit = torch.cat([prec.mm(h, head[:, v:min(v + HEAD_COLUMNS, vocab)]
                               .float())
                       for v in range(0, vocab, HEAD_COLUMNS)], 1)
    return list(torch.split(logit, [len(x) for x in rows]))
