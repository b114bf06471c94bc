"""The three-pass schedule of the CUDA decode-attention step, on the CPU.

``csrc/decode_attention.cu`` runs the step as three launches, each on a
(B, K, NSPLIT) grid: one CTA per (batch row, kv head, chunk of whole
64-slot tiles) holding all G q heads of its group.  The scores pass ropes
q, has the one CTA whose chunk holds ``write`` write the new token (and
patch it into its staged tile), scores the chunk's live slots tile by tile
(G padded to 16 rows on the tensor-core build, dead slots zero-filled and
never written) and writes each chunk's row maxima; the stats pass sums
exp(s - M) per chunk under the row's max (lanes stride the chunk, a
butterfly sums the warp) and the group's last CTA adds the chunk sums in
chunk order; the p@V pass writes each chunk's f32 partial, which the
group's last CTA sums in chunk order and casts once.  The last CTA is found
by tickets that the same call's scores pass zeroes.  ``split_mirror``
below does all of that in plain PyTorch, with the chunks finishing in a
seeded random order as CTAs do on the card, and the tests hold it against
the port's plain version (``decode_attention_plain``) and against the
reference Pallas kernel in interpret mode, on inputs made from a numpy
seed.

The slot-shard form (a mesh's flash-decoding: each device holds a block of
the slots, the softmax's max and sum and the partial p@V are all-reduced
over the model axis) is held the same way over P in {1, 2, 3, 4} blocks
of one cache, reduced here: ``shard_mirror`` (the kernels' four passes on
each block: scores, max, sum, p@V) and the module's own plain form
(``decode_attention_over_shards``), with the new token on a block's first
or last slot, a ragged or empty last block, a ring wrap, a window and
int8 caches under f32 and bf16; one block is the whole call bit for bit.

Tolerances, those chip_smoke.py holds the CUDA kernels to:
  * against the plain version: caches, int8 codes and scales bit-exact;
    out f32 ``rtol=1e-5, atol=1e-6 * max(1, max|V|)``, bf16 ``rtol=1.6e-2,
    atol=1e-4`` (p@V and the score dot summed in another order);
  * against the reference: its own cache contract (tests/test_pallas_decode.py:
    the v-cache exact, the f32 k-cache ``rtol=3e-6``, bf16 within one ULP,
    int8 k codes at most one step apart) and out as above.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.decode_attention import (
    fused_decode_attention as ref_fused)
from repro.models import layers as RL
from repro_torch.kernels import decode_attention as DA
from repro_torch.models.convert import caches_from_numpy

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
SMS = 132            # SMs of the H100 SXM the serving shape is planned for
LANES = 32           # lanes of a warp: the stats pass's order within a chunk
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=1.6e-2, atol=1e-4)}

# (name, arch, B, S, H, K, D, dtype, lens, quant, is_ring, window).  Chunks
# are whole 64-slot tiles: S <= 64 is one chunk, S = 130 three (the last of
# 2 slots), S = 200 four (the last of 8).
CASES = [
    ("write-first-of-chunk", "chatglm3-6b", 2, 130, 8, 2, 16, "f32",
     [64, 0], False, False, 0),
    ("write-last-of-chunk", "chatglm3-6b", 2, 130, 8, 2, 16, "f32",
     [63, 127], False, False, 0),
    ("ragged-last-chunk", "chatglm3-6b", 3, 130, 8, 2, 16, "f32",
     [129, 128, 70], False, False, 0),
    ("ring-wrap", "chatglm3-6b", 3, 32, 8, 2, 16, "f32",
     [100, 3, 32], False, True, 32),
    ("window", "granite-3-8b", 2, 64, 4, 4, 8, "f32",
     [40, 10], False, False, 16),
    ("quant-f32", "chatglm3-6b", 3, 40, 8, 2, 16, "f32",
     [15, 0, 39], True, False, 0),
    ("quant-bf16", "chatglm3-6b", 2, 64, 8, 2, 16, "bf16",
     [5, 40], True, False, 0),
    ("bf16-std-rope", "granite-3-8b", 2, 32, 4, 4, 8, "bf16",
     [7, 31], False, False, 0),
    ("single-split", "granite-3-8b", 66, 24, 4, 2, 8, "f32",
     [(7 * i) % 24 for i in range(66)], False, False, 0),
    ("quant-narrow-head", "granite-3-8b", 2, 40, 4, 4, 8, "bf16",
     [7, 39], True, False, 0),
    # zamba2's shared attention (G = 1, D = 64), four chunks with a ragged
    # last one, on the tensor-core build.
    ("g1-d64-ragged-split", "zamba2-1.2b", 2, 200, 4, 4, 64, "bf16",
     [199, 130], False, False, 0),
    ("g1-d64-ragged-split-q8", "zamba2-1.2b", 2, 200, 4, 4, 64, "bf16",
     [192, 63], True, False, 0),
    # qwen3-moe's G = 8 (one m16 tile, half padding), and G = 64 (four).
    ("g8-split", "qwen3-moe-30b-a3b", 2, 130, 16, 2, 32, "bf16",
     [129, 64], False, False, 0),
    ("g64-split", "chatglm3-6b", 1, 70, 64, 1, 16, "bf16",
     [66], False, False, 0),
    ("g64-split-q8-f32", "chatglm3-6b", 1, 70, 64, 1, 16, "f32",
     [64], True, False, 0),
]


# Slot-shard cases, the fields of CASES.  S = 40 over 4 blocks of 10: the
# new token on a block's first or last slot; S = 37 over 3 or 4 blocks: a
# ragged last block; S = 6 over 4 blocks of 2: an empty last block.
SHARD_CASES = [
    ("shard-write-first", "chatglm3-6b", 2, 40, 8, 2, 16, "f32",
     [10, 20], False, False, 0),
    ("shard-write-last", "chatglm3-6b", 2, 40, 8, 2, 16, "f32",
     [9, 39], False, False, 0),
    ("shard-ragged", "chatglm3-6b", 3, 37, 8, 2, 16, "f32",
     [36, 12, 25], False, False, 0),
    ("shard-empty-block", "granite-3-8b", 2, 6, 4, 2, 8, "f32",
     [5, 2], False, False, 0),
    ("shard-ring-wrap", "chatglm3-6b", 3, 32, 8, 2, 16, "f32",
     [100, 3, 32], False, True, 32),
    ("shard-window", "granite-3-8b", 2, 64, 4, 4, 8, "f32",
     [40, 10], False, False, 16),
    ("shard-quant-f32", "chatglm3-6b", 3, 40, 8, 2, 16, "f32",
     [19, 0, 39], True, False, 0),
    ("shard-quant-bf16", "chatglm3-6b", 2, 64, 8, 2, 16, "bf16",
     [15, 48], True, False, 0),
]
SHARDS = (1, 2, 3, 4)
SHARD_PARAMS = [(c, p) for c in SHARD_CASES for p in SHARDS]
SHARD_IDS = [f"{c[0]}-P{p}" for c, p in SHARD_PARAMS]


def _inputs(case, seed=0):
    """Reference (JAX) inputs of a case, made from a numpy seed."""
    _, arch, b, s, h, kh, d, dt, lens, quant, _, _ = case
    rng = np.random.default_rng(seed)
    x = {"q": jnp.asarray(rng.standard_normal((b, 1, h, d)), JDT[dt]),
         "k": jnp.asarray(rng.standard_normal((b, 1, kh, d)), JDT[dt]),
         "v": jnp.asarray(rng.standard_normal((b, 1, kh, d)), JDT[dt])}
    if quant:
        for nm in ("kc", "vc"):
            x[nm] = jnp.asarray(rng.integers(-127, 128, (b, s, kh, d)),
                                jnp.int8)
        for nm in ("ks", "vs"):
            x[nm] = jnp.asarray(rng.uniform(0.001, 0.1, (b, s, kh, 1)),
                                jnp.float32)
    else:
        for nm in ("kc", "vc"):
            x[nm] = jnp.asarray(rng.standard_normal((b, s, kh, d)), JDT[dt])
        x["ks"] = x["vs"] = None
    x["idx"] = jnp.asarray(lens, jnp.int32)
    x["cos"], x["sin"] = RL.rope_cos_sin(x["idx"][:, None], d,
                                         ref_get_config(arch))
    return [x[n] for n in ("q", "k", "v", "kc", "vc", "idx", "cos", "sin",
                           "ks", "vs")]


def _to_torch(tree):
    return caches_from_numpy(tree, "cpu")


def _clone(args):
    return [None if a is None else a.clone() for a in args]


def _vec(k_cache: torch.Tensor, v_cache: torch.Tensor) -> int:
    """Cache elements per load, as the kernels pick it: 16 bytes where
    every row starts on a 16-byte boundary, else one element."""
    size, d = k_cache.element_size(), k_cache.shape[-1]
    aligned = (k_cache.data_ptr() | v_cache.data_ptr()) % 16 == 0
    return 16 // size if (d * size) % 16 == 0 and aligned else 1


def _offset_copy(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts ``offset`` elements into its
    allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype)
    return buf[offset:].view(t.shape).copy_(t)


def _live(n, lo, hi, slots, slot_base, window):
    """The live slots ``[a, e)`` of chunk ``[lo, hi)`` of a block holding
    global slots ``slot_base ...`` of a ``slots``-slot cache, row length n
    (the kernels' ``live_range``)."""
    a = max(lo, n - window - slot_base + 1) if window else lo
    return a, min(hi, min(n + 1, slots) - slot_base)


def _tiles(lo, a, e, tile):
    """The first slot of each tile of the chunk from ``lo`` that holds one
    of its live slots ``[a, e)``."""
    return range(lo + (a - lo) // tile * tile, e, tile) if a < e else ()


def _order(nsplit, seed):
    """The order in which a group's chunks finish (CTAs run in no order)."""
    return np.random.default_rng(seed).permutation(nsplit).tolist()


def _mirror_scores(q, k_new, v_new, k_cache, v_cache, lens, cos, sin,
                   k_scale, v_scale, tickets, *, window, is_ring, slot_base,
                   slots):
    """The scores pass on a block of ``slots``-slot caches holding global
    slots ``slot_base ...`` (the whole cache: 0 and its own length): the
    tickets zeroed, the one CTA whose chunk holds ``write`` writes the new
    token and reads it back in its tile, live slots scored tile by tile
    against the G heads (padded to 16 rows on tensor cores) with dead rows
    zero-filled.  Returns the f32 scores (B, K, G, S_block), NaN where the
    pass writes nothing, and the chunk maxima (B, K, NSPLIT, G)."""
    b, _, h, d = q.shape
    block, kh = k_cache.shape[1], k_new.shape[2]
    g = h // kh
    tc = DA.tensor_cores(q.dtype, d)
    tile, rows = (64, -(-g // 16) * 16) if tc else (32, g)
    nsplit, chunk = DA.split_plan(b, kh, block, SMS)
    assert chunk % 64 == 0 and (nsplit - 1) * chunk < block
    quant = k_scale is not None
    w = cos.shape[-1]
    cos2, sin2 = cos.float().reshape(b, w), sin.float().reshape(b, w)
    qr = DA._rope(q, cos2, sin2)
    kr = DA._rope(k_new, cos2, sin2)
    tickets.zero_()
    # What every CTA finds in the caches before any write: only the owner
    # of `write` reads the slot, from its patched tile.
    before = [t.clone() for t in (k_cache, k_scale) if t is not None]
    scores = torch.full((b, kh, g, block), math.nan)
    cmax = torch.empty((b, kh, nsplit, g))
    for bi in range(b):
        n = lens[bi]
        write = (n % slots if is_ring else n) - slot_base
        for kv in range(kh):
            qg = torch.zeros((rows, d))
            qg[:g] = qr[bi, 0, kv * g:(kv + 1) * g].float()
            for c in range(nsplit):
                lo, hi = c * chunk, min(c * chunk + chunk, block)
                src = before
                if lo <= write < hi:
                    src = [k_cache, k_scale]
                    if quant:
                        kq, ksc = DA.quantize_kv(kr[bi, 0, kv])
                        vq, vsc = DA.quantize_kv(v_new[bi, 0, kv])
                        k_cache[bi, write, kv], k_scale[bi, write, kv] = kq, ksc
                        v_cache[bi, write, kv], v_scale[bi, write, kv] = vq, vsc
                    else:
                        k_cache[bi, write, kv] = kr[bi, 0, kv].to(k_cache.dtype)
                        v_cache[bi, write, kv] = v_new[bi, 0, kv].to(v_cache.dtype)
                a, e = _live(n, lo, hi, slots, slot_base, window)
                m = torch.full((g,), DA.NEG_INF if (a > lo or e < hi or a >= e)
                               else -math.inf)
                for base in _tiles(lo, a, e, tile):
                    kt = torch.zeros((tile, d))
                    j0, j1 = max(a, base) - base, min(e, base + tile) - base
                    rows_k = src[0][bi, base + j0:base + j1, kv]
                    if quant:
                        rows_k = (rows_k.float()
                                  * src[1][bi, base + j0:base + j1, kv]
                                  ).to(q.dtype)
                    kt[j0:j1] = rows_k.float()
                    s = DA._true_div(qg @ kt.T, math.sqrt(d))[:g, j0:j1]
                    scores[bi, kv, :, base + j0:base + j1] = s
                    m = torch.maximum(m, s.amax(dim=-1))
                cmax[bi, kv, c] = m
    return scores, cmax


def _lanes_sum(x):
    """Sum each row of x (G, n) as a warp does: lane l adds slots l, l + 32,
    ... in order, then a butterfly over the lanes."""
    acc = torch.zeros((x.shape[0], LANES))
    for start in range(0, x.shape[1], LANES):
        seg = x[:, start:start + LANES]
        acc[:, :seg.shape[1]] = acc[:, :seg.shape[1]] + seg
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    assert bool((acc == acc[:, :1]).all() | acc.isnan().any())
    return acc[:, 0]


def _mirror_stats(scores, cmax, lens, tickets, *, window, slot_base, slots,
                  m=None, seed=0, fold=False):
    """The softmax's statistics, each chunk's sum of exp(s - M) under the
    row's max M (the chunk maxima's, or the reduced ``m`` (B, K, G) of a
    shard) added in chunk order.  The stats pass: its chunks finish in a
    seeded order and the group's last adds their sums.  ``fold``: every
    CTA of the p@V pass takes M and the sum itself, chunk by chunk, and
    they all hold the same values.  Returns (M, SUM), each (B, K, G)."""
    b, kh, g, block = scores.shape
    nsplit = cmax.shape[2]
    chunk = DA.split_plan(b, kh, block, SMS)[1]
    big_m = cmax.amax(dim=2) if m is None else m
    total = torch.full((b, kh, g), math.nan)

    def chunk_sum(bi, kv, c):
        lo, hi = c * chunk, min(c * chunk + chunk, block)
        a, e = _live(lens[bi], lo, hi, slots, slot_base, window)
        return _lanes_sum(torch.exp(scores[bi, kv, :, a:max(a, e)]
                                    - big_m[bi, kv, :, None]))

    for bi in range(b):
        for kv in range(kh):
            grp = bi * kh + kv
            if fold:             # each p@V CTA of the group, in its order
                held = []
                for _ in _order(nsplit, seed + grp):
                    t = torch.zeros(g)
                    for cc in range(nsplit):
                        t = t + chunk_sum(bi, kv, cc)
                    held.append(t)
                assert all(torch.equal(t, held[0]) for t in held)
                total[bi, kv] = held[0]
                continue
            psum = torch.full((nsplit, g), math.nan)
            for c in _order(nsplit, seed + grp):
                psum[c] = chunk_sum(bi, kv, c)
                tickets[0, grp] += 1
                if tickets[0, grp] == nsplit:        # the last CTA
                    t = torch.zeros(g)
                    for cc in range(nsplit):
                        t = t + psum[cc]
                    total[bi, kv] = t
    return big_m, total


def _mirror_pv(scores, v_cache, v_scale, lens, m, total, dtype, tickets, *,
               window, slot_base, slots, seed=0):
    """The p@V pass on a block under the softmax's max ``m`` and sum
    ``total`` (B, K, G): per chunk, tile by tile, p rounded to ``dtype``
    (0 off the live slots; G padded to 16 rows on tensor cores) times the
    zero-filled V tile, an f32 partial; the chunks finish in a seeded
    order and the group's last sums the partials in chunk order.  Returns
    the f32 (B, K, G, D) result, uncast."""
    b, kh, g, block = scores.shape
    d = v_cache.shape[-1]
    tc = DA.tensor_cores(dtype, d)
    tile, rows = (64, -(-g // 16) * 16) if tc else (32, g)
    nsplit, chunk = DA.split_plan(b, kh, block, SMS)
    out = torch.full((b, kh, g, d), math.nan)
    for bi in range(b):
        for kv in range(kh):
            grp = bi * kh + kv
            part = torch.full((nsplit, g, d), math.nan)
            for c in _order(nsplit, 1000 + seed + grp):
                lo, hi = c * chunk, min(c * chunk + chunk, block)
                a, e = _live(lens[bi], lo, hi, slots, slot_base, window)
                acc = torch.zeros((rows, d))
                for base in _tiles(lo, a, e, tile):
                    j0, j1 = max(a, base) - base, min(e, base + tile) - base
                    p = torch.zeros((rows, tile))
                    s = scores[bi, kv, :, base + j0:base + j1]
                    p[:g, j0:j1] = (torch.exp(s - m[bi, kv, :, None])
                                    / total[bi, kv, :, None]).to(dtype).float()
                    vt = torch.zeros((tile, d))
                    v = v_cache[bi, base + j0:base + j1, kv]
                    if v_scale is not None:
                        v = (v.float() * v_scale[bi, base + j0:base + j1, kv]
                             ).to(dtype)
                    vt[j0:j1] = v.float()
                    acc = acc + p @ vt
                part[c] = acc[:g]
                tickets[1, grp] += 1
                if tickets[1, grp] == nsplit:        # the last CTA
                    o = torch.zeros((g, d))
                    for cc in range(nsplit):
                        o = o + part[cc]
                    out[bi, kv] = o
    return out


def split_mirror(q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin,
                 k_scale=None, v_scale=None, *, window=0, is_ring=False,
                 tickets=None, seed=0):
    """The whole call's passes in plain PyTorch (the stats pass folded into
    p@V where ``DA.fold_stats`` says so); returns what the kernels return,
    caches updated in place.  ``tickets`` (2, B*K) carries over between
    calls as the kernels' workspace would."""
    b, _, h, d = q.shape
    slots, kh = k_cache.shape[1], k_new.shape[2]
    lens = DA._lens(cache_len, b, q.device).tolist()
    if tickets is None:
        tickets = torch.full((2, b * kh), 7)     # whatever memory held
    kw = dict(window=window, slot_base=0, slots=slots)
    sc, cmax = _mirror_scores(q, k_new, v_new, k_cache, v_cache, lens, cos,
                              sin, k_scale, v_scale, tickets,
                              is_ring=is_ring, **kw)
    fold = DA.fold_stats(h // kh, slots, cmax.shape[2])
    m, total = _mirror_stats(sc, cmax, lens, tickets, seed=seed, fold=fold,
                             **kw)
    out = _mirror_pv(sc, v_cache, v_scale, lens, m, total, q.dtype, tickets,
                     seed=seed, **kw)
    out = out.reshape(b, 1, h, d).to(q.dtype)
    return DA._returned(out, k_cache, v_cache, k_scale, v_scale)


def shard_mirror(q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin,
                 k_scale=None, v_scale=None, *, shards, window=0,
                 is_ring=False):
    """The slot-shard form's schedule over ``shards`` blocks of one cache
    (``DA.slot_blocks``), reduced here as the mesh's all-reduces reduce
    it: on each block the scores pass, the max pass (each row's max over
    its chunk maxima), then each row's max over the blocks, each block's
    sum pass under it, the sums added over the blocks, each block's f32
    p@V partial, those added, one cast."""
    b, _, h, d = q.shape
    slots, kh = k_cache.shape[1], k_new.shape[2]
    lens = DA._lens(cache_len, b, q.device).tolist()
    blocks = []
    for base, size in DA.slot_blocks(slots, shards):
        if not size:           # an empty block launches nothing
            continue
        view = [None if t is None else t[:, base:base + size]
                for t in (k_cache, v_cache, k_scale, v_scale)]
        tickets = torch.full((2, b * kh), 7)
        kw = dict(window=window, slot_base=base, slots=slots)
        sc, cmax = _mirror_scores(q, k_new, v_new, view[0], view[1], lens,
                                  cos, sin, view[2], view[3], tickets,
                                  is_ring=is_ring, **kw)
        blocks.append((view, sc, cmax, tickets, kw))
    m = torch.stack([cmax.amax(dim=2) for _, _, cmax, _, _ in blocks]
                    ).amax(dim=0)
    total = torch.stack([
        _mirror_stats(sc, cmax, lens, tickets, m=m, **kw)[1]
        for _, sc, cmax, tickets, kw in blocks]).sum(dim=0)
    out = torch.stack([
        _mirror_pv(sc, view[1], view[3], lens, m, total, q.dtype, tickets,
                   **kw) for view, sc, _, tickets, kw in blocks]).sum(dim=0)
    out = out.reshape(b, 1, h, d).to(q.dtype)
    return DA._returned(out, k_cache, v_cache, k_scale, v_scale)


def _out_tol(dt, v_cache, v_scale):
    tol = dict(TOL[dt])
    if dt == "f32":
        v = v_cache.float() * v_scale if v_scale is not None else v_cache
        tol["atol"] *= max(1.0, float(v.float().abs().max()))
    return tol


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def key(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_schedule_matches_plain_version(case):
    *_, dt, _, quant, is_ring, window = case
    args = _to_torch(_inputs(case))
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    got = split_mirror(*_clone(args), **kw)
    want = DA.decode_attention_plain(*_clone(args), **kw)
    _assert_caches_equal(got, want, case[0])
    torch.testing.assert_close(got[0], want[0],
                               **_out_tol(dt, want[2], want[4] if quant
                                          else None))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_schedule_matches_reference_kernel(case):
    *_, dt, _, quant, is_ring, window = case
    x = _inputs(case)
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    ref = _to_torch(tuple(ref_fused(*x, interpret=True, **kw)))
    _assert_like_reference(split_mirror(*_to_torch(x), **kw), ref, dt,
                           quant)


def _assert_caches_equal(got, want, name):
    for nm, a, b in zip(("k_cache", "v_cache", "k_scale", "v_scale"),
                        got[1:], want[1:]):
        assert torch.equal(a, b), f"{name}: {nm} not bit-exact"


def _assert_like_reference(got, ref, dt, quant):
    """The reference kernel's own cache contract, and out within TOL."""
    assert torch.equal(got[2], ref[2]), "v-cache not exact"
    if quant:
        assert torch.equal(got[4], ref[4]), "v-scale not exact"
        torch.testing.assert_close(got[3], ref[3], rtol=3e-6, atol=0)
        assert int((got[1].int() - ref[1].int()).abs().max()) <= 1
    elif dt == "bf16":
        assert _bf16_ulps(got[1], ref[1]) <= 1
    else:
        torch.testing.assert_close(got[1], ref[1], rtol=3e-6, atol=1e-6)
    torch.testing.assert_close(got[0], ref[0],
                               **_out_tol(dt, ref[2], ref[4] if quant
                                          else None))


@pytest.mark.parametrize("case,shards", SHARD_PARAMS, ids=SHARD_IDS)
def test_shard_form_matches_plain_version(case, shards):
    """The kernels' slot-shard schedule and the module's plain slot-shard
    form, over ``shards`` blocks, against the whole call's plain version:
    caches bit-exact, out within TOL."""
    *_, dt, _, quant, is_ring, window = case
    args = _to_torch(_inputs(case))
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    want = DA.decode_attention_plain(*_clone(args), **kw)
    tol = _out_tol(dt, want[2], want[4] if quant else None)
    for got in (shard_mirror(*_clone(args), shards=shards, **kw),
                DA.decode_attention_over_shards(*_clone(args), shards=shards,
                                                **kw)):
        _assert_caches_equal(got, want, case[0])
        torch.testing.assert_close(got[0], want[0], **tol)


@pytest.mark.parametrize("case,shards", SHARD_PARAMS, ids=SHARD_IDS)
def test_shard_form_matches_reference_kernel(case, shards):
    *_, dt, _, quant, is_ring, window = case
    x = _inputs(case)
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    ref = _to_torch(tuple(ref_fused(*x, interpret=True, **kw)))
    _assert_like_reference(shard_mirror(*_to_torch(x), shards=shards, **kw),
                           ref, dt, quant)


@pytest.mark.parametrize("shards", SHARDS)
def test_shard_form_block_by_block_with_collectives(shards):
    """``decode_attention_shard`` called once per block with ``all_max`` /
    ``all_sum`` callables, as a mesh calls it, gives what the blocks give
    side by side; one block without collectives is the whole call."""
    import threading
    case = SHARD_CASES[6]
    args = _to_torch(_inputs(case))
    want = DA.decode_attention_over_shards(*_clone(args), shards=shards)
    kc, vc, ks, vs = (t.clone() for t in (args[3], args[4], args[8],
                                          args[9]))
    barrier = threading.Barrier(shards)
    posted: dict = {}

    def collective(op, i):
        def reduce(t):
            posted[i] = t
            barrier.wait()
            vals = torch.stack([posted[j] for j in range(shards)])
            barrier.wait()
            return vals.amax(dim=0) if op == "max" else vals.sum(dim=0)
        return reduce

    outs = {}

    def run(i, base, size):
        view = [t[:, base:base + size] for t in (kc, vc, ks, vs)]
        outs[i] = DA.decode_attention_shard(
            args[0], args[1], args[2], view[0], view[1], args[5], args[6],
            args[7], view[2], view[3], slot_base=base, slots=kc.shape[1],
            all_max=collective("max", i), all_sum=collective("sum", i))[0]

    threads = [threading.Thread(target=run, args=(i, *blk)) for i, blk in
               enumerate(DA.slot_blocks(kc.shape[1], shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(shards):
        torch.testing.assert_close(outs[i], want[0], rtol=0, atol=0)
    _assert_caches_equal((None, kc, vc, ks, vs), want, "per-block calls")
    if shards == 1:
        one = DA.decode_attention_shard(*_clone(args))
        _assert_caches_equal(one, want, "one block")
        assert torch.equal(one[0], want[0])


def test_shard_launch_count_skips_an_empty_block(monkeypatch):
    """The kernels' slot-shard path launches its three entries and counts
    one under ``decode_attention_shard``, after the last, for a block that
    holds slots, and launches and counts nothing for an empty block: S = 40
    over 16 blocks of 3 (DTensor's cut) leaves the last two empty.  The card
    is faked: the one call path records each launch."""
    from types import SimpleNamespace

    from repro_torch.kernels import _build
    called = []
    monkeypatch.setattr(_build, "launch", lambda name, symbol, argtypes,
                        device, *args, count: called.append((symbol, count)))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    args = _to_torch(_inputs(SHARD_CASES[0]))
    slots = args[3].shape[1]
    blocks = DA.slot_blocks(slots, 16)
    assert [size for _, size in blocks[-3:]] == [1, 0, 0]
    for base, size in blocks:
        view = [t[:, base:base + size] for t in (args[3], args[4])]
        called[:] = []
        DA._reduce_with(DA._kernel_shard_steps(
            *args[:3], *view, *args[5:], slot_base=base, slots=slots,
            window=0, is_ring=False), None, None)
        counts = [count for _, count in called]
        assert counts == ([None, None, "decode_attention_shard"] if size
                          else []), (base, size, called)


@pytest.mark.parametrize("seed", range(4))
def test_split_schedule_property_sweep(seed):
    """Seeded shapes whose chunks end anywhere, against the plain version."""
    rng = np.random.default_rng(2000 + seed)
    b, kh = int(rng.integers(1, 5)), int(rng.choice([1, 2, 4]))
    g, d = int(rng.integers(1, 5)), int(rng.choice([8, 16, 24]))
    s = int(rng.integers(9, 90))
    lens = rng.integers(0, s, size=b).tolist()
    case = ("sweep", "granite-3-8b", b, s, kh * g, kh, d, "f32", lens,
            bool(seed % 2), False, 0)
    args = _to_torch(_inputs(case, seed))
    got = split_mirror(*_clone(args))
    want = DA.decode_attention_plain(*_clone(args))
    for a, w in zip(got[1:], want[1:]):
        assert torch.equal(a, w)
    torch.testing.assert_close(got[0], want[0], **_out_tol(
        "f32", want[2], want[4] if case[9] else None))


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("case", [CASES[2], CASES[6]],
                         ids=[CASES[2][0], CASES[6][0]])
def test_split_schedule_with_unaligned_caches(case, offset):
    """Caches off a 16-byte boundary take the kernels' one-element loads
    into the same tiles: the same schedule."""
    *_, dt, _, quant, _, _ = case
    args = _to_torch(_inputs(case))
    kargs = _clone(args)
    kargs[3], kargs[4] = (_offset_copy(t, offset) for t in kargs[3:5])
    assert _vec(kargs[3], kargs[4]) == 1 < _vec(args[3], args[4])
    got = split_mirror(*kargs)
    want = DA.decode_attention_plain(*_clone(args))
    for a, w in zip(got[1:], want[1:]):
        assert torch.equal(a, w)
    torch.testing.assert_close(got[0], want[0], **_out_tol(
        dt, want[2], want[4] if quant else None))


@pytest.mark.parametrize("sms", [114, 132])
def test_split_plan_takes_shapes_only_and_never_leaves_a_chunk_empty(sms):
    """Chunks of whole 64-slot tiles, about four CTAs per SM over the B*K
    groups (no more, and at least half as many, where there are tiles
    enough), however many groups there are."""
    assert DA.split_plan(4, 2, 160, 132) == (3, 64)      # one-shot serving
    assert DA.split_plan(4, 2, 1040, 132) == (17, 64)    # chatglm3-6b stream
    assert DA.split_plan(4, 4, 1040, 132) == (17, 64)    # qwen3-moe-30b-a3b
    assert DA.split_plan(4, 32, 1040, 132) == (5, 256)   # zamba2: B*K = 128
    assert DA.split_plan(8, 2, 32768, 132) == (32, 1024)  # decode_32k
    assert DA.split_plan(4, 2, 160, 114) == (3, 64)      # an H100 PCIe
    assert DA.split_plan(66, 2, 4096, sms)[0] == 4       # B*K = 132
    assert DA.split_plan(1, 1, 1, sms) == (1, 64)
    for b in (1, 2, 3, 4, 8, 33, 66, 200):
        for kh in (1, 2, 4, 8, 32):
            for s in list(range(1, 70)) + [127, 128, 129, 160, 161, 1000,
                                           1040, 32768]:
                nsplit, chunk = DA.split_plan(b, kh, s, sms)
                assert nsplit >= 1 and chunk >= 64 and chunk % 64 == 0
                assert (nsplit - 1) * chunk < s <= nsplit * chunk
                want = min(-(-4 * sms // (b * kh)), -(-s // 64))
                assert want <= 2 * nsplit and nsplit <= want
    for bad in ((0, 2, 160, sms), (4, 0, 160, sms), (4, 2, 0, sms),
                (4, 2, 160, 0)):
        with pytest.raises(ValueError):
            DA.split_plan(*bad)


# A whole call whose statistics are not folded into p@V: 16 rows of 1600
# slots exceed the fold's shared memory, so the stats pass runs.
UNFOLDED_CASE = ("unfolded-stats", "chatglm3-6b", 1, 1600, 16, 1, 16, "f32",
                 [1599], False, False, 0)


@pytest.mark.parametrize("case", [CASES[11], UNFOLDED_CASE],
                         ids=["folded", "unfolded"])
def test_two_calls_in_a_row_reuse_the_tickets(case):
    """The tickets that find a group's last CTA carry over from one call to
    the next (the workspace is not cleared); the scores pass zeroes them,
    so a second call, its chunks finishing in another order, gives the
    first's values bit for bit, as a replayed graph must."""
    args = _to_torch(_inputs(case))
    b, h, kh = args[0].shape[0], args[0].shape[2], args[1].shape[2]
    slots = args[3].shape[1]
    nsplit = DA.split_plan(b, kh, slots, SMS)[0]
    fold = DA.fold_stats(h // kh, slots, nsplit)
    assert fold == (case is not UNFOLDED_CASE) and nsplit > 3
    tickets = torch.full((2, b * kh), -3)
    first = split_mirror(*_clone(args), tickets=tickets, seed=0)
    used = torch.tensor([0 if fold else nsplit, nsplit])[:, None]
    assert bool((tickets == used).all())
    second = split_mirror(*_clone(args), tickets=tickets, seed=5)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert bool((tickets == used).all())
    want = DA.decode_attention_plain(*_clone(args))
    _assert_caches_equal(second, want, case[0])
    torch.testing.assert_close(second[0], want[0],
                               **_out_tol(case[7], want[2], None))


@pytest.mark.parametrize("case", [CASES[i] for i in (2, 6, 11, 13)],
                         ids=[CASES[i][0] for i in (2, 6, 11, 13)])
def test_one_block_of_the_shard_form_is_the_whole_call(case):
    """The slot-shard form's four passes over one block give the whole
    call's three passes bit for bit: the same chunk maxima, the same sum
    in chunk order, the same partials."""
    *_, is_ring, window = case
    args = _to_torch(_inputs(case))
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    whole = split_mirror(*_clone(args), **kw)
    one = shard_mirror(*_clone(args), shards=1, **kw)
    for x, y in zip(whole, one):
        assert torch.equal(x, y)


def test_shared_memory_and_workspace_follow_the_kernels_layout():
    """``smem_bytes`` and ``workspace_bytes`` as the kernels lay them out
    (``Layout``, ``Workspace``), and ``_check``'s limits."""
    # chatglm3-6b, bf16 on tensor cores: q heads 16 x 136 bf16 + the
    # inputs (q rows, k_new, v_new, cos, sin) + three 64-row tiles of 272 B
    # + the new k row + per-warp maxima.
    inputs = 4096 + 2 * 256 + 2 * 256
    assert DA.smem_bytes(16, 128, 2, 2, tc=True, pv=False) == (
        4352 + inputs + 52224 + 256 + 512)
    # The p@V pass: the p tile, the new v row, two V tiles, two score tiles
    # of 16 x 64 f32 (or, folded at S = 160, 3 x 16 chunk maxima, 16 rows
    # of 160 scores and 16 x 3 chunk sums), the f32 sums (16 x 128), the
    # row stats.
    assert DA.smem_bytes(16, 128, 2, 2, tc=True, pv=True) == (
        2304 + 272 + 34816 + 8192 + 8192 + 128)
    assert DA.fold_stats(16, 160, 3) and not DA.fold_stats(16, 1040, 17)
    assert DA.smem_bytes(16, 128, 2, 2, tc=True, pv=True, slots=160,
                         nsplit=3, fold=True) == (2304 + 272 + 34816 + 10624
                                                  + 8192 + 128)
    # int8 caches add their scales and the bf16 tile they dequantise into.
    assert DA.smem_bytes(16, 128, 2, 1, tc=True, pv=False) == (
        4352 + inputs + 27648 + 768 + 17408 + 128 + 512)
    # CUDA cores (f32): 32-row tiles, q heads in f32 rows of D + 1.
    assert DA.smem_bytes(16, 128, 4, 4, tc=False, pv=False) == (
        8256 + 8192 + 2 * 512 + 2 * 256 + 50688 + 512 + 512)
    # G = 64 (chip_smoke's BIG_SMEM_CASE) needs the shared-memory attribute.
    assert min(DA.smem_bytes(64, 128, 2, 2, tc=True, pv=pv) for pv in (0, 1)
               ) > 48 * 1024
    assert DA.workspace_bytes(4, 2, 16, 128, 1040, 64) == (
        532480 + 2 * 8704 + 2 * 512 + 256 + 1114112)
    case = CASES[0]
    args = _to_torch(_inputs(case))
    lens = args[5]
    DA._check(*args[:5], lens, args[6][:, 0], args[7][:, 0], None, None, 0)
    b, _, _, d = args[0].shape
    for h, kh, dim in ((130, 2, 16), (128, 1, 128)):   # G = 65, G = 128
        q = torch.zeros((b, 1, h, dim))
        kv = torch.zeros((b, 1, kh, dim))
        cache = torch.zeros((b, 8, kh, dim))
        with pytest.raises(ValueError):
            DA._check(q, kv, kv, cache, cache.clone(), lens,
                      args[6][:, 0], args[7][:, 0], None, None, 0)
