"""The plain float32 decoder the family references share.

A straightforward PyTorch forward pass of the decoder-only transformer the
benchmark's configurations describe: RMSNorm with a ``1 + w`` scale, GQA
attention with rotary embeddings, a family-specific feed-forward block, a
final norm and an untied LM head.  It is written from the published
architectures and the configuration file alone and imports nothing of the
program under test; the conventions it shares with the program (rotation of
halves, the ``1 + w`` norm scale, the capacity rule of the MoE family) are
frozen copies, so that the same weights give the same function.

Everything runs in float32 with TF32 off.  Weights stay in the dtype they
were drawn in and are upcast one layer at a time, so the reference fits
beside the served weights.  Every product goes through a precision
(``F32``, ``FP8`` or ``BF16``): ``FP8``, the control's lower precision,
puts both operands of every weight product (the router's too) and of
attention's q.k and p@v through float8 (e4m3), scaled per row or column,
and accumulates in float32; ``BF16``, a witness that ``bench/control.py``
can read beside them, rounds the same operands to bfloat16.

A *job* is one request as the program served it: the rows of the prefill
call that placed it (``rows``, the full token batch the program ran,
``row`` the request's own), then its served tokens fed one position at a
time (``extend``).  Prefill rows are computed together because a family's
feed-forward block may couple them (the MoE capacity); the extension sees
only its own row, as a decode step of independent rows does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

NEG_INF = float("-inf")
FP8_MAX = 448.0          # largest finite float8 e4m3 value


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with ``a`` quantised per row and ``w`` per column to
    float8 e4m3, accumulated in float32."""
    return _fp8(a, -1) @ _fp8(w, -2)


def _bf16(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def bf16_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with both operands rounded to bfloat16, accumulated in
    float32."""
    return _bf16(a) @ _bf16(w)


class F32:
    mm = staticmethod(f32_mm)

    @staticmethod
    def cast(x: torch.Tensor, dim: int) -> torch.Tensor:
        return x


class FP8:
    mm = staticmethod(fp8_mm)
    cast = staticmethod(_fp8)


class BF16:
    """A witness, never the check: every product's operands in bfloat16,
    the precision the configurations serve in."""
    mm = staticmethod(bf16_mm)
    cast = staticmethod(_bf16)


@dataclass
class Job:
    rows: torch.Tensor             # (R, L) int: the prefill call's tokens
    row: int                       # the request's row among them
    extend: torch.Tensor           # (n,) int: served tokens fed back
    group: int = 0                 # jobs of one prefill call share it
    routes: list = field(default_factory=list)   # per layer (n, k) ids


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, pos: torch.Tensor, m: dict) -> torch.Tensor:
    """Rotate the leading ``2 * W`` dims of each head as two halves, W =
    ``head_dim // 4`` for ChatGLM's rotary on half the head, ``head_dim //
    2`` otherwise.  x (..., S, H, D), pos (S,)."""
    d = x.shape[-1]
    w = d // 4 if m["rope_variant"] == "half" else d // 2
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        w, dtype=torch.float32, device=x.device) / w))
    ang = pos.float()[:, None] * inv                       # (S, W)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2, rest = x[..., :w], x[..., w:2 * w], x[..., 2 * w:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def attention(q, k, v, q_pos, k_pos, prec=F32):
    """Causal GQA: q (R, Sq, H, D), k/v (R, Sk, K, D) -> (R, Sq, H*D)."""
    r, sq, h, d = q.shape
    kh = k.shape[2]
    qg = prec.cast(q.reshape(r, sq, kh, h // kh, d), -1)
    s = torch.einsum("rqkgd,rskd->rkgqs", qg, prec.cast(k, -1)) / math.sqrt(d)
    mask = k_pos[None, :] <= q_pos[:, None]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("rkgqs,rskd->rqkgd", prec.cast(p, -1),
                       prec.cast(v, -1))
    return out.reshape(r, sq, h * d)


def layer_weights(group: dict, i: int) -> dict:
    """Layer ``i`` of a stacked block tree, upcast to float32."""
    out = {}
    for k, v in group.items():
        out[k] = layer_weights(v, i) if isinstance(v, dict) else v[i].float()
    return out


def attention_block(x, w, m, pos, past, prec):
    """x (R, S, d) -> (x + attention, (k, v) of these positions).
    ``past`` is (k, v, positions) of the earlier positions or None."""
    r, s, _ = x.shape
    h, kh, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a = rms_norm(x, w["norm1"], m["norm_eps"]).reshape(r * s, -1)
    q = prec.mm(a, w["attn"]["wq"]).reshape(r, s, h, hd)
    k = prec.mm(a, w["attn"]["wk"]).reshape(r, s, kh, hd)
    v = prec.mm(a, w["attn"]["wv"]).reshape(r, s, kh, hd)
    q, k = rope(q, pos, m), rope(k, pos, m)
    kk, vv, kpos = k, v, pos
    if past is not None:
        kk = torch.cat([past[0], k], 1)
        vv = torch.cat([past[1], v], 1)
        kpos = torch.cat([past[2], pos])
    o = attention(q, kk, vv, pos, kpos, prec).reshape(r * s, -1)
    return x + prec.mm(o, w["attn"]["wo"]).reshape(r, s, -1), (k, v)


def lm_logits(x, weights, m, prec):
    """x (n, d) -> logits (n, vocab_size), padded columns left out."""
    h = rms_norm(x, weights["final_norm"], m["norm_eps"])
    head = weights["lm_head"][:, :m["vocab_size"]].float()
    return prec.mm(h, head)


def run_jobs(weights: dict, m: dict, jobs: list[Job], ffn, *, prec=F32,
             routes: bool = False) -> list[torch.Tensor]:
    """Logits (n + 1, V) of each job: the prefill's last position of its
    row, then each extension position.

    ``ffn(f, w, m, prec, coupled, route)`` is the family's feed-forward block
    on f (T, d): ``coupled`` says the T tokens are one prefill call's (the
    rows the program ran together), ``route`` a list to which it appends the
    (T, k) experts it picked, if it has experts.  Layer-major: each layer's
    weights are upcast once for every job.
    """
    no_tf32()
    dev = weights["embed"].device
    embed = weights["embed"]
    groups: dict[int, list[Job]] = {}
    for j in jobs:
        groups.setdefault(j.group, []).append(j)
    state = {}                    # group -> prefill hidden (R, L, d)
    ext = {}                      # id(job) -> extension hidden (1, n, d)
    for g, js in groups.items():
        state[g] = embed[js[0].rows.to(dev).long()].float()
        for j in js:
            j.routes = []
            ext[id(j)] = embed[j.extend.to(dev).long()].float()[None]
    stack = weights["groups"][0]
    for i in range(m["num_layers"]):
        w = layer_weights(stack, i)
        for g, js in groups.items():
            x = state[g]
            r, length, d = x.shape
            pos = torch.arange(length, device=dev)
            x, (k, v) = attention_block(x, w, m, pos, None, prec)
            f = rms_norm(x, w["norm2"], m["norm_eps"]).reshape(r * length, d)
            state[g] = x + ffn(f, w, m, prec, True, None).reshape(r, length, d)
            for j in js:
                y = ext[id(j)]
                n = y.shape[1]
                if n == 0:
                    continue
                epos = torch.arange(length, length + n, device=dev)
                past = (k[j.row:j.row + 1], v[j.row:j.row + 1], pos)
                y, _ = attention_block(y, w, m, epos, past, prec)
                f = rms_norm(y, w["norm2"], m["norm_eps"])[0]
                got = [] if routes else None
                ext[id(j)] = y + ffn(f, w, m, prec, False, got)[None]
                if routes:
                    j.routes.append(got[0] if got else None)
        del w
    out = []
    for j in jobs:
        x = torch.cat([state[j.group][j.row, -1:], ext[id(j)][0]], 0)
        out.append(lm_logits(x, weights, m, prec))
    return out
