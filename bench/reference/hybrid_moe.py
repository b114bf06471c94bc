"""Plain float32 reference of the hybrid MoE family (granite-4.0-h-small).

Written from the published architecture (``granitemoehybrid``,
https://huggingface.co/ibm-granite/granite-4.0-h-small) and the
configuration file alone; it imports nothing of the program under test.
The token's embedding row is multiplied by ``embedding_multiplier``.  Each
layer is a pre-norm mixer, a Mamba-2 mixer or attention as the pattern
says, then a pre-norm MoE FFN; each branch's output joins the residual
times ``residual_multiplier``.  The final norm's output is multiplied by
the embedding (the head is tied) and divided by ``logits_scaling``.

* **Mamba-2 mixer.**  One in-projection to z, x, B, C (one group) and dt
  (one per head); a depthwise causal conv of width ``conv_width`` with
  bias over x, B and C, then SiLU; dt = softplus(dt + dt_bias) and A =
  -exp(a_log) per head; then the recurrence, stepped one position at a
  time: h <- exp(dt*A) h + dt x (x) B, y = C.h + D x.  The output is the
  RMSNorm of y * SiLU(z), out-projected.  The recurrence is the SSM's own
  definition, not the chunked dual form the program computes.
* **Attention.**  GQA without a position embedding (NoPE), with the
  softmax scale ``attention_multiplier`` in place of 1/sqrt(head_dim),
  causal; computed in blocks of queries so that a long prompt's scores
  fit beside the served weights.
* **MoE FFN.**  The MoE family's router and experts
  (``bench.reference.moe``: top ``num_experts_per_tok`` of the router's
  logits, a softmax over those, gated SiLU experts, the capacity of a
  call), plus a shared gated SiLU expert every token runs, added to the
  routed output.

Departures from the published model, each shared with the program: the
RMSNorm scales are applied as ``1 + w``; the experts have a capacity per
call, ``max(ceil(T * k / E * cf), k)``, as ``bench.reference.moe`` says
(the published model is dropless); a decode call of the cell's rows drops
nothing, so the extension runs dropless.

Precision: every weight product goes through ``prec`` (``F32``, the
control's ``FP8``, the ``BF16`` witness), and attention's q.k and p@v
through ``prec.cast``, as in ``bench.reference.common``; the conv, the
recurrence, the norms and the residual stay in float32 in every precision.

A job's prefill rows (the whole call: the MoE's capacity couples them)
run from a zero state; its extension continues from its own row's SSM
state, conv window, keys and values, one position at a time for the
recurrence.  ``routes`` collects, per MoE layer, each extension
position's experts.  The calls go through every layer in passes of a few
calls of one length, so that only one pass's states live beside the
served weights (``bench/control.py`` keeps the engine and its graphs
too): about 5 GB at 4 x 2048 tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import F32, NEG_INF, Job, no_tf32, rms_norm
from bench.reference.moe import (ROUTER_BF16, capacity,  # noqa: F401
                                 decode_drops_nothing, ffn as routed_ffn)

COUPLED_ROWS = True       # the prefill rows a job needs: the whole call
QUERY_BLOCK = 256         # attention's queries per block of scores
PASS_TOKENS = 8192        # prompt tokens per pass of a mixer over rows
HEAD_COLUMNS = 16384      # vocabulary columns of the head per product


def _mm(prec, x, w):
    """``x (..., a) @ w (a, b)`` through ``prec``."""
    return prec.mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], -1)


def mamba_mixer(a, w, m, prec, state=None, window=None):
    """a (R, S, d) -> (y (R, S, d), final SSM state (R, H, P, N), last
    ``conv_width - 1`` conv inputs (R, W-1, C)), from ``state`` and
    ``window`` (zeros where None).  Each (R, S, d_inner)-sized value is
    freed, or updated in place, as soon as it is used."""
    r, s, _ = a.shape
    h, n = m["ssm_heads"], m["ssm_state"]
    di = m["ssm_expand"] * m["d_model"]
    p = di // h
    width = w["w_conv"].shape[0]
    if window is None:
        window = a.new_zeros((r, width - 1, di + 2 * n))
    u = torch.cat([_mm(prec, a, w["w_x"]), _mm(prec, a, w["w_bc"])], -1)
    full = torch.cat([window, u], 1)                       # (R, W-1+S, C)
    del u
    conv = full[:, :s] * w["w_conv"][0]
    for i in range(1, width):
        conv.add_(full[:, i:i + s] * w["w_conv"][i])
    window = full[:, -(width - 1):].clone()
    del full
    if "conv_bias" in w:
        conv.add_(w["conv_bias"])
    x, bmat, cmat = torch.split(F.silu(conv, inplace=True), [di, n, n],
                                dim=-1)
    dt = F.softplus(_mm(prec, a, w["w_dt"]) + w["dt_bias"])   # (R, S, H)
    decay = torch.exp(dt * -torch.exp(w["a_log"]))         # (R, S, H)
    xh = x.reshape(r, s, h, p)
    xdt = xh * dt[..., None]
    hs = (state.clone() if state is not None
          else a.new_zeros((r, h, p, n)))
    ys = []
    for d_t, x_t, b_t, c_t in zip(decay.unbind(1), xdt.unbind(1),
                                  bmat.unbind(1), cmat.unbind(1)):
        hs.mul_(d_t[:, :, None, None]).addcmul_(x_t[..., None],
                                                 b_t[:, None, None, :])
        ys.append(hs @ c_t[:, None, :, None])             # (R, H, P, 1)
    del xdt
    y = torch.stack(ys, 1)[..., 0]
    del ys
    y.add_(xh * w["d_skip"][:, None])
    del conv, x, xh, bmat, cmat
    y = y.reshape(r, s, di).mul_(F.silu(_mm(prec, a, w["w_z"]),
                                        inplace=True))
    y = rms_norm(y, w["w_norm"], m["norm_eps"])
    return _mm(prec, y, w["w_out"]), hs, window


def attention(q, k, v, q_pos, k_pos, scale, prec):
    """Causal GQA over query blocks: q (R, Sq, H, D), k/v (R, Sk, K, D)
    -> (R, Sq, H*D)."""
    r, sq, h, d = q.shape
    kh = k.shape[2]
    kc, vc = prec.cast(k, -1), prec.cast(v, -1)
    out = []
    for i in range(0, sq, QUERY_BLOCK):
        qb = prec.cast(q[:, i:i + QUERY_BLOCK], -1)
        qg = qb.reshape(r, qb.shape[1], kh, h // kh, d)
        s = torch.einsum("rqkgd,rskd->rkgqs", qg, kc) * scale
        mask = k_pos[None, :] <= q_pos[i:i + QUERY_BLOCK, None]
        prob = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        o = torch.einsum("rkgqs,rskd->rqkgd", prec.cast(prob, -1), vc)
        out.append(o.reshape(r, qb.shape[1], h * d))
        del s, prob
    return torch.cat(out, 1)


def attention_mixer(a, w, m, prec, pos, past=None):
    """a (R, S, d) at positions ``pos`` -> (y, k, v), the keys and values
    of these positions; ``past`` is (k, v, positions) of earlier ones."""
    r, s, _ = a.shape
    h, kh, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = _mm(prec, a, w["attn"]["wq"]).reshape(r, s, h, hd)
    k = _mm(prec, a, w["attn"]["wk"]).reshape(r, s, kh, hd)
    v = _mm(prec, a, w["attn"]["wv"]).reshape(r, s, kh, hd)
    kk, vv, kpos = k, v, pos
    if past is not None:
        kk, vv = torch.cat([past[0], k], 1), torch.cat([past[1], v], 1)
        kpos = torch.cat([past[2], pos])
    o = attention(q, kk, vv, pos, kpos, m["attention_multiplier"], prec)
    return _mm(prec, o, w["attn"]["wo"]), k, v


def ffn(f, w, m, prec, coupled, route):
    """The routed experts and the shared expert on f (T, d)."""
    out = routed_ffn(f, w, m, prec, coupled, route)
    sh, mm = w["moe"]["shared"], prec.mm
    return out + mm(F.silu(mm(f, sh["w_gate"])) * mm(f, sh["w_in"]),
                    sh["w_out"])


def passes(shapes: dict) -> list[list]:
    """The prefill calls (key -> (R, L)) in passes of one L and at most
    ``PASS_TOKENS`` tokens (one call at least).  The mixers treat rows
    independently, so a pass over several calls' rows gives each row what
    a call on its own gives; the recurrence then steps once for them all."""
    by_len: dict[int, list] = {}
    for key, (_, length) in shapes.items():
        by_len.setdefault(length, []).append(key)
    out = []
    for length, keys in by_len.items():
        cur, rows = [], 0
        for key in keys:
            r = shapes[key][0]
            if cur and (rows + r) * length > PASS_TOKENS:
                out.append(cur)
                cur, rows = [], 0
            cur.append(key)
            rows += r
        out.append(cur)
    return out


class _Upcast:
    """A stacked expert leaf kept in its stored dtype; each expert is upcast
    to float32 as it is read (all 72 at once would take 2.7 GB a layer)."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getitem__(self, e):
        return self.t[e].float()


def _layer(tree: dict, i=None, experts: bool = False) -> dict:
    """Layer ``i`` of a stacked block tree (the tree itself where None),
    upcast to float32, the routed experts' leaves as they are read."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, i, experts=k == "moe")
        else:
            leaf = v if i is None else v[i]
            out[k] = (_Upcast(leaf) if experts and k != "w_router"
                      else leaf.float())
    return out


def layer_stack(weights: dict, m: dict):
    """(kind, float32 weights) of each layer in order: the groups' stacked
    layers, then the tail."""
    pattern = list(m["pattern"])
    groups, rest = divmod(m["num_layers"], len(pattern))
    for i in range(groups * len(pattern)):
        yield pattern[i % len(pattern)], _layer(
            weights["groups"][i % len(pattern)], i // len(pattern))
    for i in range(rest):
        yield pattern[i], _layer(weights["tail"][i])


def _run_pass(weights, m, calls: list[list[Job]], prec, routes) -> dict:
    """Every layer over one pass's prefill calls (each a list of its jobs)
    and their jobs' extensions; returns id(job) -> its prefill row's last
    position and its extension positions, hidden (n + 1, d)."""
    dev = weights["embed"].device
    embed, em = weights["embed"], m.get("embedding_multiplier", 1.0)
    rm, eps = m.get("residual_multiplier", 1.0), m["norm_eps"]
    state = [embed[js[0].rows.to(dev).long()].float() * em for js in calls]
    ext = {}
    for js in calls:
        for j in js:
            j.routes = []
            ext[id(j)] = embed[j.extend.to(dev).long()].float()[None] * em
    length = state[0].shape[1]
    pos = torch.arange(length, device=dev)
    sizes = [x.shape[0] for x in state]
    for kind, w in layer_stack(weights, m):
        a = torch.cat([rms_norm(x, w["norm1"], eps) for x in state])
        mixer = (mamba_mixer(a, w["mamba"], m, prec) if kind == "mamba_moe"
                 else attention_mixer(a, w, m, prec, pos))
        del a
        for c, (js, y, *past) in enumerate(zip(calls, *(
                torch.split(t, sizes) for t in mixer))):
            r, d = sizes[c], state[c].shape[2]
            x = state[c] + rm * y
            f = rms_norm(x, w["norm2"], eps).reshape(r * length, d)
            state[c] = x + rm * ffn(f, w, m, prec, True, None).reshape(
                r, length, d)
            for j in js:
                e = ext[id(j)]
                n = e.shape[1]
                if n == 0:
                    continue
                a = rms_norm(e, w["norm1"], eps)
                row = slice(j.row, j.row + 1)
                if kind == "mamba_moe":
                    y, _, _ = mamba_mixer(a, w["mamba"], m, prec,
                                          past[0][row], past[1][row])
                else:
                    epos = torch.arange(length, length + n, device=dev)
                    y, _, _ = attention_mixer(a, w, m, prec, epos,
                                              (past[0][row], past[1][row],
                                               pos))
                e = e + rm * y
                f = rms_norm(e, w["norm2"], eps)[0]
                got = [] if routes else None
                ext[id(j)] = e + rm * ffn(f, w, m, prec, False, got)[None]
                if routes:
                    j.routes.append(got[0])
        del mixer, w
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
    # The tied head in blocks of its columns (every precision scales per
    # row of h and per column of the head, so a block is the whole's).
    vocab, block = m["vocab_size"], HEAD_COLUMNS
    embed = weights["embed"]
    logit = torch.cat([prec.mm(h, embed[v:min(v + block, vocab)].float().T)
                       for v in range(0, vocab, block)], 1)
    logit = logit / m.get("logits_scaling", 1.0)
    return list(torch.split(logit, [len(x) for x in rows]))
