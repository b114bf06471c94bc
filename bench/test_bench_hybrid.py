"""CPU tests of the hybrid MoE family (granite-4.0-h-small): the program
against the plain reference (``bench/reference/hybrid_moe.py``) at a small
size from seeded weights, the family's layout against the program's
parameter tree, its counts, the metric it brought, and its cell run
whole through the harness.

Tolerance of every comparison with the reference: the largest difference
of the logits at most ``TOL`` = 1e-4 of their largest magnitude.  Both
sides run float32 with TF32 off and differ only in the order of their sums
(the chunked SSD against the stepped recurrence, the engine's kernels'
plain versions against plain products): the largest reading was 7.3e-6
when these tests were written, so ``TOL`` leaves about 14 times that for
another library's order of sums.  A bfloat16 SSM state and every part of
the model left out read 0.39 or more
(``test_a_departure_fails_the_comparison``), over 3,000 times ``TOL``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math

import numpy as np
import pytest
import torch

from bench import harness, peaks, testkit, weights
from bench.counts import dense as dense_counts, hybrid_moe as counts
from bench.layouts import hybrid_moe as layout
from bench.reference import hybrid_moe as ref
from bench.reference.common import Job
from bench.window import Call

from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill, scaled_down)
from repro_torch.serve.batcher import ServingEngine

CPU = torch.device("cpu")
SEED = 2 ** 31 + 41
TOL = 1e-4
NAME = "granite-4.0-h-small"
FULL = json.loads((testkit.BENCH / "configs" / f"{NAME}.json").read_text())
H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


def small(**overrides):
    """``scaled_down`` of the configuration file's model (f32, chunk 8),
    as the program's ``ModelConfig`` and as the reference's dict."""
    cfg = scaled_down(harness.model_config(FULL["model"]), **overrides)
    m = dataclasses.asdict(cfg)
    m.update(pattern=list(cfg.pattern), family="hybrid_moe",
             ssm_heads=cfg.ssm_num_heads)
    return cfg, m


def tokens(b, s, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g)


def close(got, want, tol=TOL) -> float:
    """The largest difference over the reference's largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def program_logits(w, cfg, toks, s):
    """The program's prefill of ``toks[:, :s]`` into a cache, then one
    decode step per later token: the prefill's last logits and each
    step's, per row (B, n + 1, V)."""
    b, total = toks.shape
    caches = init_cache(cfg, b, total + 1, device="cpu")
    lg, caches = prefill(w, cfg, caches=caches, tokens=toks[:, :s])
    out = [lg[:, -1]]
    for t in range(s, total):
        lg, caches = decode_step(w, cfg, toks[:, t:t + 1], caches, t)
        out.append(lg[:, 0])
    return torch.stack(out, 1)


def reference_logits(w, m, toks, s):
    jobs = [Job(toks[:, :s], r, toks[r, s:], group=0)
            for r in range(toks.shape[0])]
    return torch.stack(ref.logits(w, m, jobs))


# The capacity rule couples a prefill's rows in both; a factor this large
# drops nothing, so the program's one-call forward is the reference's
# step-by-step extension.
DROPLESS = 100.0


@pytest.mark.parametrize("length", [16, 13])
def test_forward_logits_match_the_reference(length):
    """Every position of the program's forward (the chunked SSD over two
    whole chunks, then over a padded last chunk) against the reference's
    extension, which steps each position from a one-token prompt."""
    cfg, m = small(capacity_factor=DROPLESS)
    w = weights.draw(m, SEED, CPU, layout)
    toks = tokens(2, length, m["vocab_size"], 3)
    got = forward(w, cfg, tokens=toks)
    want = reference_logits(w, m, toks, 1)
    assert close(got[:, 0], want[:, 0]) < TOL
    assert close(got, want) < TOL


def test_prefill_rows_share_the_capacity_as_the_reference():
    """One prefill call of three rows (one all zeros, as a slot prefill's
    free rows hold) at the configuration's capacity, which drops copies:
    the last position of each row."""
    cfg, m = small()
    w = weights.draw(m, SEED + 1, CPU, layout)
    toks = tokens(3, 24, m["vocab_size"], 4)
    toks[1] = 0
    got = forward(w, cfg, tokens=toks)[:, -1]
    jobs = [Job(toks, r, toks[r, :0], group=0) for r in range(3)]
    want = torch.stack([lg[0] for lg in ref.logits(w, m, jobs)])
    assert close(got, want) < TOL


def test_prefill_then_decode_matches_the_reference():
    cfg, m = small(capacity_factor=DROPLESS)
    w = weights.draw(m, SEED + 2, CPU, layout)
    toks = tokens(2, 17, m["vocab_size"], 5)
    assert close(program_logits(w, cfg, toks, 11),
                 reference_logits(w, m, toks, 11)) < TOL


def test_the_engine_refills_a_slot_and_decodes_as_the_reference():
    """``ServingEngine``: a slot prefill into one of two live slots, the
    other row's state kept, then fused decode steps of both rows; each
    row against the reference's forward pass over its own tokens."""
    cfg, m = small()
    w = weights.draw(m, SEED + 3, CPU, layout)
    eng = ServingEngine(cfg, reduced=False, max_batch=2, max_len=40,
                        fused_decode=True, params=w, device="cpu")
    a, b = tokens(1, 16, m["vocab_size"], 6), tokens(1, 16, m["vocab_size"], 7)
    caches = eng.init_caches()
    rows = [[], []]
    first = np.concatenate([a.numpy(), np.zeros_like(a.numpy())])
    nxt, caches, _ = eng.prefill_into_slots(first, caches,
                                            np.array([True, False]))
    rows[0].append(int(nxt[0]))
    lens = np.array([16, 0], np.int32)
    second = np.concatenate([np.zeros_like(b.numpy()), b.numpy()])
    for step in range(6):
        if step == 2:       # refill slot 1 while slot 0 runs
            nxt, caches, _ = eng.prefill_into_slots(second, caches,
                                                    np.array([False, True]))
            rows[1].append(int(nxt[1]))
            lens[1] = 16
        tok = np.array([[r[-1] if r else 0] for r in rows], np.int32)
        nxt, caches, _ = eng.decode(tok, caches, lens)
        for i in (0, 1):
            if rows[i]:
                rows[i].append(int(nxt[i]))
                lens[i] += 1
    for prompt, call, served in ((a, first, rows[0]), (b, second, rows[1])):
        row = 0 if prompt is a else 1
        job = Job(torch.from_numpy(call).long(), row,
                  torch.tensor(served[:-1]), group=0)
        want = ref.logits(w, m, [job])[0]
        got = want.argmax(-1).tolist()
        # Greedy tokens: where the reference's best two logits lie within
        # the tolerance of each other, either is right.
        top = want.topk(2, -1).values
        tie = (top[:, 0] - top[:, 1]) < TOL * want.abs().max()
        assert all(t == g or tied for t, g, tied in zip(served, got, tie))


def test_the_engine_keeps_the_other_slots_state_bit_for_bit():
    cfg, m = small()
    w = weights.draw(m, SEED + 4, CPU, layout)
    eng = ServingEngine(cfg, reduced=False, max_batch=2, max_len=32,
                        params=w, device="cpu")
    caches = eng.init_caches()
    toks = tokens(2, 12, m["vocab_size"], 8).numpy()
    _, caches, _ = eng.prefill_into_slots(toks, caches,
                                          np.array([True, False]))
    before = [t[:, 0].clone() for e in caches["groups"] for t in e.values()]
    _, caches, _ = eng.prefill_into_slots(toks[::-1].copy(), caches,
                                          np.array([False, True]))
    after = [t[:, 0] for e in caches["groups"] for t in e.values()]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert len(before) == 10 * 2 - 9 * 2 + 9 * 2    # 9 x (ssm, conv), k, v


def test_the_reference_is_the_same_in_any_passes(monkeypatch):
    """Three prefill calls, two of one length: the mixers over all their
    rows at once, or one call's rows a pass, give the same logits."""
    cfg, m = small()
    w = weights.draw(m, SEED + 5, CPU, layout)
    calls = [tokens(2, 12, m["vocab_size"], 20 + i) for i in range(2)]
    calls.append(tokens(2, 9, m["vocab_size"], 22))
    jobs = [Job(t, r, t[r, :3], group=g) for g, t in enumerate(calls)
            for r in range(2)]
    whole = ref.logits(w, m, jobs)
    monkeypatch.setattr(ref, "PASS_TOKENS", 1)
    assert [len(p) for p in ref.passes({g: t[..., None] for g, t in
                                        enumerate(calls)})] == [1, 1, 1]
    for a, b in zip(ref.logits(w, m, jobs), whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


DEPARTURES = ["bf16_ssm_state", "no_shared_expert", "no_embedding_multiplier",
              "no_residual_multiplier", "no_attention_multiplier",
              "no_logits_scaling", "no_conv_bias"]


@pytest.mark.parametrize("departure", DEPARTURES)
def test_a_departure_fails_the_comparison(departure, monkeypatch):
    """The program with one part of the model changed or left out fails
    the tolerance of ``test_prefill_then_decode_matches_the_reference``."""
    from repro_torch.models import model as model_mod
    cfg, m = small(capacity_factor=DROPLESS)
    w = weights.draw(m, SEED + 2, CPU, layout)
    toks = tokens(2, 17, m["vocab_size"], 5)
    want = reference_logits(w, m, toks, 11)
    if departure == "bf16_ssm_state":
        entry = model_mod._cache_entry

        def bf16_state(kind, *args, **kw):
            out = entry(kind, *args, **kw)
            if "ssm" in out:
                out["ssm"] = out["ssm"].bfloat16()
            return out
        monkeypatch.setattr(model_mod, "_cache_entry", bf16_state)
    elif departure in ("no_shared_expert", "no_conv_bias"):
        leaf = "shared" if departure == "no_shared_expert" else "conv_bias"
        w = {**w, "groups": tuple(
            {k: ({kk: vv for kk, vv in v.items() if kk != leaf}
                 if isinstance(v, dict) else v) for k, v in g.items()}
            for g in w["groups"])}
    else:
        field = departure.removeprefix("no_")
        cfg = dataclasses.replace(
            cfg, **{field: 0.0 if field == "attention_multiplier" else 1.0})
    assert close(program_logits(w, cfg, toks, 11), want) > 10 * TOL


def test_the_layout_is_the_programs_tree_at_full_size():
    """Paths, shapes and dtypes of every leaf, against ``init_params`` on
    the meta device, and the parameter count: 32.21 B."""
    m = FULL["model"]
    cfg = harness.model_config(m)
    tree = init_params(cfg, device="meta")

    def leaves(t, path=()):
        if isinstance(t, torch.Tensor):
            return {path: (tuple(t.shape), t.dtype)}
        items = t.items() if isinstance(t, dict) else enumerate(t)
        return {p: v for k, x in items for p, v in leaves(x, path + (k,))
                .items()}

    want = leaves(tree)
    got = {path: (shape, weights.DTYPES[dt])
           for path, shape, _, dt in weights.specs(m, layout)}
    assert got == want
    assert weights.param_count(m, layout) == cfg.param_count() \
        == 32_207_337_984
    assert cfg.active_param_count() == 8_803_121_664


def test_the_counts_attend_over_the_four_attention_layers():
    m = FULL["model"]
    assert (counts.mamba_layers(m), counts.attn_layers(m)) == (36, 4)
    four = dict(m, num_layers=4)
    assert counts.prefill_attention_bytes_ops(m, 4, 4096) == \
        dense_counts.prefill_attention_bytes_ops(four, 4, 4096)
    lens = [1023, 2047, 3071, 4095]
    assert counts.decode_attention_bytes_ops(m, lens, 4160) == \
        dense_counts.decode_attention_bytes_ops(four, lens, 4160)
    assert counts.attn_flops(m, 10) == 4 * 4 * 32 * 128 * 10
    # The kernels' work over 4 layers reads below its roofline where 40
    # would not: 10 times the work.
    forty = dict(m, num_layers=40)
    assert dense_counts.prefill_attention_bytes_ops(forty, 4, 4096)[1] == \
        10 * counts.prefill_attention_bytes_ops(m, 4, 4096)[1]


def test_the_counts_by_hand():
    m = FULL["model"]
    d, di, h, p, n, q = 4096, 8192, 128, 64, 128, 256
    mamba = d * (2 * di + 2 * n + h) + di * d
    assert counts.mamba_params(m) == mamba
    ffn = d * 72 + 10 * 3 * d * 768 + 3 * d * 1536
    attn = d * 128 * (32 + 16) + 32 * 128 * d
    ssd = int((q + 1) / 2 * (2 * n + h * (2 * p + 1)) + 4 * h * p * n)
    conv = 2 * 4 * (di + 2 * n)
    assert counts.token_flops(m) == 36 * (2 * mamba + conv + ssd) \
        + 4 * 2 * attn + 40 * 2 * ffn
    assert counts.token_flops(m, decode=True) - counts.token_flops(m) == \
        36 * (5 * h * p * n - ssd)
    assert counts.prefill_flops(m, 8) == 8 * counts.token_flops(m) \
        + 4 * 4 * 32 * 128 * 36 + 2 * d * 100352
    state = 36 * (h * p * n * 4 + 3 * (di + 2 * n) * 2)
    assert counts.state_bytes_per_row(m) == state
    experts = [10] * 40
    one = counts.decode_step_bytes(m, [100], experts)
    two = counts.decode_step_bytes(m, [100, 200], experts)
    assert two - one == 2 * state + d * 2 + \
        counts.kv_bytes_per_slot(m) * 201
    assert counts.kv_bytes_per_slot(m) == 4 * 2 * 8 * 128 * 2


def _run(calls, model=None, counts_mod=counts, mix="rag-4"):
    model = model or FULL["model"]
    mix = json.loads((testkit.BENCH / "traffic" / f"{mix}.json").read_text())
    return harness.RunData(model, mix, counts_mod, H100, 0.0, 0.0, 10.0,
                           calls, None)


def _decode(lens):
    return Call("decode", 0.0, lens=np.asarray(lens, np.int32))


def test_decode_state_mb_counts_the_decode_calls():
    """Every slot's SSM state and conv window read and written, its keys
    and values read below its length and written at it, the mean over
    the decode calls; prefills count nothing."""
    from bench.metrics import decode_state_mb as reader
    m = FULL["model"]
    assert reader.read(_run([])) is None
    pre = Call("prefill", 0.0, tokens=np.zeros((4, 8), np.int32),
               mask=np.ones(4, bool))
    calls = [pre, _decode([1024, 2048, 0, 5]), _decode([1025, 2049, 0, 6])]
    state, kv = counts.state_bytes_per_row(m), counts.kv_bytes_per_slot(m)
    want = 2 * 4 * state + kv * ((3077 + 3080) / 2 + 4)
    assert reader.read(_run(calls)) == pytest.approx(want / 1e6)
    # A family without Mamba layers: keys and values alone, by the dense
    # count.
    glm = json.loads((testkit.BENCH / "configs" /
                      "chatglm3-6b.json").read_text())["model"]
    got = reader.read(_run(calls[1:2], glm, dense_counts,
                           "long-prompts-4"))
    assert got == pytest.approx(dense_counts.kv_bytes_per_slot(glm)
                                * (3077 + 4) / 1e6)


def test_decode_state_mb_equals_the_programs_cache_bytes():
    """At full width on the meta device, the count a decode call of full
    slots reads is every leaf of the engine's cache tree: the SSM states
    (4 MiB a row and layer in float32, 1.21 GB read and written for 4
    rows), the conv windows and every key and value below the length."""
    from bench.metrics import decode_state_mb as reader
    cfg = harness.model_config(FULL["model"])
    run = _run([])
    caches = init_cache(cfg, 4, run.max_len, device="meta")
    leaves = {k: sum(leaf.numel() * leaf.element_size()
                     for e in caches["groups"] for n, leaf in e.items()
                     if n in k) for k in (("ssm",), ("conv",), ("k", "v"))}
    assert 2 * leaves[("ssm",)] == 2 * 4 * 36 * 128 * 64 * 128 * 4 \
        == 1_207_959_552
    run.calls = [_decode([run.max_len] * 4)]
    whole = 2 * (leaves[("ssm",)] + leaves[("conv",)]) + leaves[("k", "v")]
    kv_new = 4 * counts.kv_bytes_per_slot(FULL["model"])
    assert reader.read(run) == pytest.approx((whole + kv_new) / 1e6)


def _tiny_root(tmp_path):
    tiny = dict(FULL["model"], name="tiny-granite", num_layers=20,
                d_model=64, d_ff=32, vocab_size=128, vocab_pad_to=1,
                num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
                num_experts_per_tok=2, shared_expert_ff=48, ssm_state=16,
                ssm_heads=8, ssm_head_dim=16, ssm_chunk=8, dtype="float32")
    testkit.TINY.setdefault("tiny-granite", tiny)
    root = testkit.make_root(tmp_path, configs=("tiny-granite",))
    mix = dict(testkit.MIX, prompt_lens=[8, 12], gen_lens=[4, 8])
    (root / "bench" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_serves_correctly_through_the_harness(tmp_path, trace):
    """The whole run: the layout's weights, the engine's slot refills (a
    prompt of 12, not a multiple of the chunk, among them) and decode
    steps, the reference's check, and with ``trace`` the state reader."""
    root = _tiny_root(tmp_path)
    result, lines = harness.run(root, "tiny-granite", SEED, testkit.SECONDS,
                                trace, CPU, 0.0)
    assert result["correct"], lines
    assert result["checks"]["logit_gap"]["value"] <= testkit.LIMIT
    if trace:
        assert result["metrics"]["decode_state_mb"]["value"] > 0


def test_the_reference_imports_nothing_of_the_program():
    import ast
    for kind in ("reference", "layouts", "counts"):
        src = (testkit.BENCH / kind / "hybrid_moe.py").read_text()
        names = {n.module.split(".")[0] if isinstance(n, ast.ImportFrom)
                 else a.name.split(".")[0]
                 for n in ast.walk(ast.parse(src))
                 if isinstance(n, (ast.Import, ast.ImportFrom))
                 for a in n.names}
        assert not names & {"repro_torch", "repro", "jax", "jaxlib"}, kind
    assert harness.forbidden_modules(["bench.reference.hybrid_moe"]) == []
    assert importlib.import_module("bench.reference.hybrid_moe") is ref
    assert math.isclose(FULL["model"]["attention_multiplier"], 1 / 128)
