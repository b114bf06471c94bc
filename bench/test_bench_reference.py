"""The plain references against the program's own forward, prefill and
decode at a tiny size on the CPU, from the same weights."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from bench import testkit
from bench.reference import dense as ref_dense, moe as ref_moe
from bench.reference.common import Job, fp8_mm
from bench.weights import draw

from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models.config import ModelConfig

NAMES = {f.name for f in dataclasses.fields(ModelConfig)}


def model_config(m: dict) -> ModelConfig:
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items() if k in NAMES})


def tokens(b, s, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g)


@pytest.mark.parametrize("name,ref", [("tiny-dense", ref_dense),
                                      ("tiny-moe", ref_moe)])
def test_prefill_rows_match_the_program(name, ref):
    """The last position of every prompt row, the rows run together as
    one call (for the MoE: one capacity over all of them, a row of zeros
    among them as the slot prefill's free rows hold)."""
    m = testkit.TINY[name]
    cfg, w = model_config(m), draw(m, 11, "cpu", testkit.layout(m))
    toks = tokens(3, 12, m["vocab_size"], 1)
    toks[1] = 0
    got = forward(w, cfg, tokens=toks)[:, -1, :m["vocab_size"]]
    rows = range(3) if ref.COUPLED_ROWS else [0, 2]
    jobs = [Job(toks, i, torch.zeros(0, dtype=torch.long), group=0)
            if ref.COUPLED_ROWS else
            Job(toks[i:i + 1], 0, torch.zeros(0, dtype=torch.long), group=-i)
            for i in rows]
    want = ref.logits(w, m, jobs)
    for i, lg in zip(rows, want):
        torch.testing.assert_close(lg[0], got[i], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,ref", [("tiny-dense", ref_dense),
                                      ("tiny-moe", ref_moe)])
def test_decode_steps_match_the_program(name, ref):
    """A prefill into the cache then decode steps, one token per row per
    step, against the reference's prefill and extension."""
    m = testkit.TINY[name]
    cfg, w = model_config(m), draw(m, 12, "cpu", testkit.layout(m))
    b, s, n = 2, 8, 5
    assert ref_moe.decode_drops_nothing(dict(testkit.TINY["tiny-moe"]), b)
    toks = tokens(b, s, m["vocab_size"], 2)
    feed = tokens(b, n, m["vocab_size"], 3)
    caches = init_cache(cfg, b, s + n, device="cpu")
    logits, caches = prefill(w, cfg, caches=caches, tokens=toks)
    steps = [logits[:, -1]]
    for t in range(n - 1):
        lg, caches = decode_step(w, cfg, feed[:, t:t + 1], caches, s + t)
        steps.append(lg[:, 0])
    got = torch.stack(steps, 1)[..., :m["vocab_size"]]
    jobs = [Job(toks, i, feed[i, :n - 1], group=0) if ref.COUPLED_ROWS
            else Job(toks[i:i + 1], 0, feed[i, :n - 1], group=-i)
            for i in range(b)]
    for i, lg in enumerate(ref.logits(w, m, jobs)):
        torch.testing.assert_close(lg, got[i], rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_as_the_program_does():
    """With a capacity factor small enough to drop copies, the coupled
    reference still follows the program; run row by row it does not."""
    m = dict(testkit.TINY["tiny-moe"], capacity_factor=0.5)
    cfg, w = model_config(m), draw(m, 13, "cpu", testkit.layout(m))
    toks = tokens(4, 10, m["vocab_size"], 4)
    got = forward(w, cfg, tokens=toks)[:, -1, :m["vocab_size"]]
    none = torch.zeros(0, dtype=torch.long)
    coupled = ref_moe.logits(w, m, [Job(toks, i, none) for i in range(4)])
    alone = ref_moe.logits(w, m, [Job(toks[i:i + 1], 0, none, group=i)
                                  for i in range(4)])
    for i in range(4):
        torch.testing.assert_close(coupled[i][0], got[i], rtol=1e-4,
                                   atol=1e-4)
    assert any(not torch.allclose(alone[i][0], got[i], atol=1e-3)
               for i in range(4))


def test_fp8_product_is_coarser_than_f32():
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(16, 64, generator=g), torch.randn(64, 32, generator=g)
    err = (fp8_mm(a, b) - a @ b).abs().max() / (a @ b).abs().max()
    assert 1e-3 < err < 0.1
