"""The two-kernel schedule of the CUDA decode-attention step, on the CPU.

``csrc/decode_attention.cu`` runs the step as two launches: kernel A on a
(B, K, NSPLIT) grid ropes q, has the one CTA whose chunk of slots holds
``write`` write the new token, and scores its chunk into an f32 scratch;
kernel B, one CTA per q head, takes the softmax over the whole score row
and sums p@V in its warps' partition and a fixed order.  ``split_mirror``
below does the same in plain PyTorch, and the tests hold it against the
port's plain version (``decode_attention_plain``) and against the
reference Pallas kernel in interpret mode, on inputs made from a numpy
seed.

The slot-shard form (a mesh's flash-decoding: each device holds a block of
the slots, the softmax's max and sum and the partial p@V are all-reduced
over the model axis) is held the same way over P in {1, 2, 3, 4} blocks
of one cache, reduced here: ``shard_mirror`` (the kernels' schedule on
each block) and the module's own plain form
(``decode_attention_over_shards``), with the new token on a block's first
or last slot, a ragged or empty last block, a ring wrap, a window and
int8 caches under f32 and bf16.

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
WARPS = 8            # kWarps of kernel B
SMS = 132            # SMs of the H100 SXM the serving shape is planned for
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=1.6e-2, atol=1e-4)}

# (name, arch, B, S, H, K, D, dtype, lens, quant, is_ring, window).  With
# B*K = 4 and S = 40 the slots split 5 ways into chunks of 8.
CASES = [
    ("write-first-of-chunk", "chatglm3-6b", 2, 40, 8, 2, 16, "f32",
     [8, 16], False, False, 0),
    ("write-last-of-chunk", "chatglm3-6b", 2, 40, 8, 2, 16, "f32",
     [7, 39], False, False, 0),
    ("ragged-last-chunk", "chatglm3-6b", 3, 37, 8, 2, 16, "f32",
     [36, 31, 32], False, False, 0),
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


def rows_per_pass(d: int, vec: int) -> int:
    """V rows one warp of kernel B covers at once (``rows_per_pass``)."""
    groups = d // vec
    return 1 if groups >= 32 else 32 // groups


def _mirror_scores(q, k_new, v_new, k_cache, v_cache, lens, cos, sin,
                   k_scale, v_scale, *, window, is_ring, slot_base, slots):
    """Kernel A on a block of ``slots``-slot caches holding global slots
    ``slot_base ...`` (the whole cache: 0 and its own length): grid (B, K,
    NSPLIT) over the block, the one CTA whose chunk holds ``write`` writes
    the new token.  Returns the f32 scores (B, K, G, S_block)."""
    b, _, h, d = q.shape
    block, kh = k_cache.shape[1], k_new.shape[2]
    g = h // kh
    quant = k_scale is not None
    nsplit, chunk = DA.split_plan(b, kh, block, SMS)
    w = cos.shape[-1]
    cos2, sin2 = cos.float().reshape(b, w), sin.float().reshape(b, w)
    qr = DA._rope(q, cos2, sin2)
    kr = DA._rope(k_new, cos2, sin2)
    # What every CTA of kernel A finds in the caches before any write: only
    # the owner of `write` reads the caches after its own write.
    before = [t.clone() for t in (k_cache, k_scale) if t is not None]

    def k_rows(src, bi, lo, hi, kv):
        rows = src[0][bi, lo:hi, kv]
        if quant:
            rows = (rows.float() * src[1][bi, lo:hi, kv]).to(q.dtype)
        return rows.float()

    scores = torch.empty((b, kh, g, block), dtype=torch.float32)
    for bi in range(b):
        n = lens[bi]
        write = (n % slots if is_ring else n) - slot_base
        n_live = min(n + 1, slots) - slot_base
        for kv in range(kh):
            qg = qr[bi, 0, kv * g:(kv + 1) * g].float()
            for c in range(nsplit):
                lo, hi = c * chunk, min(c * chunk + chunk, block)
                assert lo < hi, "empty chunk"
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
                pos = torch.arange(lo, hi)
                live = pos < n_live
                if window:
                    live &= pos + slot_base > n - window
                s = DA._true_div(qg @ k_rows(src, bi, lo, hi, kv).T,
                                 math.sqrt(d))
                scores[bi, kv, :, lo:hi] = torch.where(live, s, DA.NEG_INF)
    return scores


def _mirror_pv(scores, v_cache, v_scale, lens, m, total, dtype, *,
               slot_base, slots):
    """Kernel B on a block under the softmax's max ``m`` and sum ``total``
    (B, K, G): p rounded to ``dtype``, p@V over the block's live slots in
    the warps' partition, the partials summed in a fixed order.  Returns
    the f32 (B, K, G, D) result, uncast."""
    b, kh, g, block = scores.shape
    d = v_cache.shape[-1]
    parts = WARPS * rows_per_pass(d, _vec(v_cache, v_cache))
    out = torch.zeros((b, kh, g, d))
    for bi in range(b):
        n_live = max(0, min(min(lens[bi] + 1, slots) - slot_base, block))
        for kv in range(kh):
            v = v_cache[bi, :n_live, kv]
            if v_scale is not None:
                v = (v.float() * v_scale[bi, :n_live, kv]).to(dtype)
            v = v.float()
            owner = torch.arange(n_live) % parts
            for gi in range(g):
                row = scores[bi, kv, gi]
                p = torch.exp(row[:n_live] - m[bi, kv, gi]) / total[bi, kv, gi]
                p = p.to(dtype).float()
                acc = torch.zeros((parts, d)).index_add_(0, owner,
                                                         p[:, None] * v)
                o = torch.zeros(d)
                for i in range(parts):
                    o = o + acc[i]
                out[bi, kv, gi] = o
    return out


def split_mirror(q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin,
                 k_scale=None, v_scale=None, *, window=0, is_ring=False):
    """The kernels' schedule in plain PyTorch; returns what the kernels
    return, caches updated in place."""
    return shard_mirror(q, k_new, v_new, k_cache, v_cache, cache_len, cos,
                        sin, k_scale, v_scale, shards=1, window=window,
                        is_ring=is_ring)


def shard_mirror(q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin,
                 k_scale=None, v_scale=None, *, shards, window=0,
                 is_ring=False):
    """The slot-shard form's schedule over ``shards`` blocks of one cache
    (``DA.slot_blocks``), reduced here as the mesh's all-reduces reduce
    it: kernel A on each block, each row's max over the blocks, each
    block's sum of exp(s - M) summed over the blocks, kernel B's f32
    partials summed, one cast.  One block is the whole call's schedule."""
    b, _, h, d = q.shape
    slots = k_cache.shape[1]
    lens = DA._lens(cache_len, b, q.device).tolist()
    blocks = []
    for base, size in DA.slot_blocks(slots, shards):
        view = [None if t is None else t[:, base:base + size]
                for t in (k_cache, v_cache, k_scale, v_scale)]
        sc = (_mirror_scores(q, k_new, v_new, view[0], view[1], lens, cos,
                             sin, view[2], view[3], window=window,
                             is_ring=is_ring, slot_base=base, slots=slots)
              if size else None)
        blocks.append((base, view, sc))
    live = [sc for _, _, sc in blocks if sc is not None]
    m = torch.stack([sc.amax(dim=-1) for sc in live]).amax(dim=0)
    total = torch.stack([torch.exp(sc - m[..., None]).sum(dim=-1)
                         for sc in live]).sum(dim=0)
    out = sum(_mirror_pv(sc, view[1], view[3], lens, m, total, q.dtype,
                         slot_base=base, slots=slots)
              for base, view, sc in blocks if sc is not None)
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
    """The kernels' slot-shard path adds one to ``SHARD_LAUNCHES`` for a
    block whose kernels launched, and nothing for an empty block, which
    launches nothing: S = 40 over 16 blocks of 3 (DTensor's cut) leaves the
    last two empty.  The card is faked: each entry point returns 0."""
    from contextlib import nullcontext
    from types import SimpleNamespace
    called = []
    monkeypatch.setattr(DA, "_entry", lambda name, argtypes: (
        lambda *a: called.append(name) or 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    args = _to_torch(_inputs(SHARD_CASES[0]))
    slots = args[3].shape[1]
    blocks = DA.slot_blocks(slots, 16)
    assert [size for _, size in blocks[-3:]] == [1, 0, 0]
    for base, size in blocks:
        view = [t[:, base:base + size] for t in (args[3], args[4])]
        before, called[:] = DA.SHARD_LAUNCHES, []
        DA._reduce_with(DA._kernel_shard_steps(
            *args[:3], *view, *args[5:], slot_base=base, slots=slots,
            window=0, is_ring=False), None, None)
        assert DA.SHARD_LAUNCHES == before + (1 if size else 0), (base, size)
        assert len(called) == (3 if size else 0), (base, size, called)


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
    and kernel B's wider partition of slots."""
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
    assert DA.split_plan(4, 2, 160, 132) == (16, 10)   # the serving shape
    assert DA.split_plan(4, 2, 160, 114) == (14, 12)   # an H100 PCIe
    assert DA.split_plan(66, 2, 4096, sms)[0] == 1     # B*K > SMs / 2
    assert DA.split_plan(1, 1, 1, sms) == (1, 1)
    for b in (1, 2, 3, 4, 8, 33, 66, 200):
        for kh in (1, 2, 4, 8):
            for s in list(range(1, 70)) + [127, 160, 161, 1000, 32768]:
                nsplit, chunk = DA.split_plan(b, kh, s, sms)
                assert nsplit >= 1 and chunk >= 1
                assert chunk == -(-s // nsplit)            # the kernel's chunk
                assert (nsplit - 1) * chunk < s <= nsplit * chunk
                assert nsplit <= -(-s // 8)                # ~8 slots a chunk
                assert nsplit <= max(1, sms // (b * kh))   # one wave of CTAs
    for bad in ((0, 2, 160, sms), (4, 0, 160, sms), (4, 2, 0, sms),
                (4, 2, 160, 0)):
        with pytest.raises(ValueError):
            DA.split_plan(*bad)
