"""CPU tests of the MLA MoE family (kanana-2-30b-a3b): the program against
the plain reference (``bench/reference/mla_moe.py``) at a small size from
seeded weights, the family's layout against the program's parameter tree,
its counts, and its cell run whole through the harness.  The tiny
configuration is defined here, beside the others of ``bench/testkit.py``.

Tolerance of every comparison with the reference: the largest difference
of the logits at most ``TOL`` = 1e-4 of their largest magnitude.  Both
sides run float32 with TF32 off and differ only in the order of their sums
(the program's absorbed decode over the latent against the reference's
decompressed keys and values, chunked against blocked attention): the
largest reading was 1.3e-6 when these tests were written, so ``TOL``
leaves about 75 times that for another library's order of sums.  Every
part of the model left out or changed reads 100 times ``TOL`` or more
(``test_a_departure_fails_the_comparison``).
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from bench import harness, peaks, testkit, weights
from bench.counts import mla_moe as counts
from bench.layouts import mla_moe as layout
from bench.reference import mla_moe as ref
from bench.reference.common import Job
from bench.window import Call

from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.serve.batcher import ServingEngine

CPU = torch.device("cpu")
SEED = 2 ** 31 + 53
TOL = 1e-4
NAME = "kanana-2-30b-a3b"
FULL = json.loads((testkit.BENCH / "configs" / f"{NAME}.json").read_text())
H100 = peaks.peaks("NVIDIA H100 80GB HBM3")
#: The family at a small size: the leading dense layer and three MoE
#: layers, narrow widths, float32.
TINY = dict(FULL["model"], name="tiny-kanana", num_layers=4,
            pattern=["mla", "mla_moe", "mla_moe", "mla_moe"], d_model=64,
            d_ff=32, dense_d_ff=96, vocab_size=128, vocab_pad_to=1,
            num_heads=4, num_kv_heads=4, head_dim=24, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            num_experts=8, num_experts_per_tok=2, shared_expert_ff=48,
            max_seq_len=256, dtype="float32")
# The capacity rule couples a prefill's rows in both; a factor this large
# drops nothing, so the program's one-call forward is the reference's
# step-by-step extension.
DROPLESS = 100.0


def small(**overrides):
    """The tiny configuration as the program's ``ModelConfig`` and as the
    reference's dict."""
    m = dict(TINY, **overrides)
    return harness.model_config(m), m


def tokens(b, s, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g)


def close(got, want) -> float:
    """The largest difference over the reference's largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def program_logits(w, cfg, toks, s):
    """The program's prefill of ``toks[:, :s]`` into the latent cache,
    then one decode step per later token: the prefill's last logits and
    each step's, per row (B, n + 1, V)."""
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


def test_forward_logits_match_the_reference():
    """Every position of the program's forward pass (no cache: the
    decompressed attention) against the reference's extension, which
    steps each position from a one-token prompt."""
    cfg, m = small(capacity_factor=DROPLESS)
    w = weights.draw(m, SEED, CPU, layout)
    toks = tokens(2, 15, m["vocab_size"], 3)
    assert close(forward(w, cfg, tokens=toks),
                 reference_logits(w, m, toks, 1)) < TOL


@pytest.mark.parametrize("prompt", [11, 1])
def test_prefill_then_decode_matches_the_reference(prompt):
    """The program's prefill into the latent cache and its absorbed decode
    steps against the reference's full forward pass, in logits."""
    cfg, m = small(capacity_factor=DROPLESS)
    w = weights.draw(m, SEED + 1, CPU, layout)
    toks = tokens(2, 17, m["vocab_size"], 4)
    assert close(program_logits(w, cfg, toks, prompt),
                 reference_logits(w, m, toks, prompt)) < TOL


def test_prefill_rows_share_the_capacity_as_the_reference():
    """One prefill call of three rows (one all zeros, as a slot prefill's
    free rows hold) at the configuration's capacity, which drops copies:
    the last position of each row."""
    cfg, m = small()
    w = weights.draw(m, SEED + 2, CPU, layout)
    toks = tokens(3, 24, m["vocab_size"], 5)
    toks[1] = 0
    got = forward(w, cfg, tokens=toks)[:, -1]
    jobs = [Job(toks, r, toks[r, :0], group=0) for r in range(3)]
    want = torch.stack([lg[0] for lg in ref.logits(w, m, jobs)])
    assert close(got, want) < TOL
    # The call drops copies: the dropless forward differs.
    dropless = forward(w, dataclasses.replace(cfg, capacity_factor=DROPLESS),
                       tokens=toks)[:, -1]
    assert close(dropless, want) > 100 * TOL


def test_the_engine_refills_a_slot_and_decodes_as_the_reference():
    """``ServingEngine``: a slot prefill into one of two live slots, the
    other row's latents kept, then decode steps of both rows; each row
    against the reference's forward pass over its own tokens."""
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
    for row, (call, served) in enumerate(((first, rows[0]),
                                          (second, rows[1]))):
        job = Job(torch.from_numpy(call).long(), row,
                  torch.tensor(served[:-1]), group=0)
        want = ref.logits(w, m, [job])[0]
        best = want.argmax(-1).tolist()
        # Greedy tokens: where the reference's best two logits lie within
        # the tolerance of each other, either is right.
        top = want.topk(2, -1).values
        tie = (top[:, 0] - top[:, 1]) < TOL * want.abs().max()
        assert all(t == g or tied for t, g, tied in zip(served, best, tie))


def _without(w, path):
    """``w`` with the leaf at ``path`` (within every block that has it)
    zeroed, in a copy."""
    groups = []
    for g in w["groups"]:
        g = {k: (dict(v) if isinstance(v, dict) else v) for k, v in g.items()}
        node = g
        for k in path[:-1]:
            node = node.get(k, {})
        if path[-1] in node:
            node[path[-1]] = torch.zeros_like(node[path[-1]])
        groups.append(g)
    return {**w, "groups": tuple(groups)}


DEPARTURES = ["no_router_bias", "no_routed_scaling", "softmax_router",
              "no_rope_interleave", "no_kv_norm", "no_shared_expert",
              "expert_width_in_the_dense_layer"]


@pytest.mark.parametrize("departure", DEPARTURES)
def test_a_departure_fails_the_comparison(departure):
    """The program with one part of the model changed or left out fails
    the tolerance of ``test_prefill_then_decode_matches_the_reference``."""
    cfg, m = small(capacity_factor=DROPLESS)
    w = weights.draw(m, SEED + 1, CPU, layout)
    toks = tokens(2, 17, m["vocab_size"], 4)
    want = reference_logits(w, m, toks, 11)
    if departure == "no_router_bias":
        w = _without(w, ("moe", "router_bias"))
    elif departure == "no_kv_norm":
        # A norm scale of 1 + 0: the latent still normed, its scale gone.
        w = _without(w, ("mla", "kv_norm"))
    elif departure == "no_shared_expert":
        w = _without(w, ("moe", "shared", "w_out"))
    elif departure == "expert_width_in_the_dense_layer":
        first = dict(w["groups"][0])
        first["mlp"] = {k: v[..., :32] if k != "w_out" else v[:, :32]
                        for k, v in first["mlp"].items()}
        w = {**w, "groups": (first, *w["groups"][1:])}
    else:
        cfg = dataclasses.replace(cfg, **{
            "no_routed_scaling": {"routed_scaling": 1.0},
            "softmax_router": {"router_scoring": "softmax"},
            "no_rope_interleave": {"rope_interleave": False}}[departure])
    assert close(program_logits(w, cfg, toks, 11), want) > 100 * TOL


def _leaves(t, path=()):
    if isinstance(t, torch.Tensor):
        return {path: (tuple(t.shape), t.dtype)}
    items = t.items() if isinstance(t, dict) else enumerate(t)
    return {p: v for k, x in items for p, v in _leaves(x, path + (k,))
            .items()}


def test_the_layout_is_the_programs_tree_at_full_size():
    """Paths, shapes and dtypes of every leaf, against ``init_params`` on
    the meta device, and the parameter count: 30.67 B."""
    m = FULL["model"]
    cfg = harness.model_config(m)
    want = _leaves(init_params(cfg, device="meta"))
    got = {path: (shape, weights.DTYPES[dt])
           for path, shape, _, dt in weights.specs(m, layout)}
    assert got == want
    assert weights.param_count(m, layout) == cfg.param_count() \
        == 30_670_815_104


def test_the_configuration_keeps_the_catalogs_numbers():
    """Every top-level number of the published config, and the port's
    model block read from them."""
    m = FULL["model"]
    assert FULL["reduced"] == [] and FULL["family"] == m["family"]
    assert (FULL["num_hidden_layers"], FULL["hidden_size"],
            FULL["moe_intermediate_size"], FULL["intermediate_size"],
            FULL["n_routed_experts"], FULL["num_experts_per_tok"],
            FULL["kv_lora_rank"], FULL["qk_nope_head_dim"],
            FULL["qk_rope_head_dim"], FULL["v_head_dim"],
            FULL["vocab_size"]) == (
        m["num_layers"], m["d_model"], m["d_ff"], m["dense_d_ff"],
        m["num_experts"], m["num_experts_per_tok"], m["kv_lora_rank"],
        m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
        m["vocab_size"])
    assert FULL["n_shared_experts"] * FULL["moe_intermediate_size"] == \
        m["shared_expert_ff"]
    assert FULL["routed_scaling_factor"] == m["routed_scaling"]
    assert FULL["scoring_func"] == m["router_scoring"]
    assert m["pattern"] == ["mla"] * FULL["first_k_dense_replace"] + \
        ["mla_moe"] * (48 - FULL["first_k_dense_replace"])
    assert FULL["q_lora_rank"] is None and FULL["rope_scaling"] is None


def test_the_counts_by_hand():
    m = FULL["model"]
    d, h, r, dn, dr, dv = 2048, 32, 512, 128, 64, 128
    attn = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    assert counts.attn_params(m) == attn
    moe = d * 128 + 6 * 3 * d * 768 + 3 * d * 1536
    assert counts.token_flops(m) == 2 * (48 * attn + 3 * d * 6144 + 47 * moe)
    assert (counts.dense_layers(m), counts.moe_layers(m)) == (1, 47)
    head = 2 * d * 128256
    assert counts.prefill_flops(m, 3) == 3 * counts.token_flops(m) \
        + 48 * 2 * h * (dn + dr + dv) * 6 + head
    assert counts.decode_flops(m, 99) == counts.token_flops(m) \
        + 48 * 2 * h * (2 * r + dr) * 100 + head
    assert counts.kv_bytes_per_slot(m) == 48 * 576 * 2
    experts = [20] * 47
    one = counts.decode_step_bytes(m, [100], experts)
    assert one == (48 * (attn * 2 + r * 4 + 2 * d * 4) + 3 * d * 6144 * 2
                   + 47 * ((d + 1) * 128 * 4 + 3 * d * 1536 * 2)
                   + 20 * 47 * 3 * d * 768 * 2 + d * 128256 * 2 + d * 4
                   + d * 2 + 48 * 576 * 2 * 101)
    two = counts.decode_step_bytes(m, [100, 200], experts)
    assert two - one == d * 2 + 48 * 576 * 2 * 201
    with pytest.raises(ValueError):
        counts.decode_step_bytes(m, [100])
    nbytes, ops = counts.prefill_attention_bytes_ops(m, 4, 8192)
    assert ops == 48 * 2 * 4 * h * (192 + 128) * 8192 * 8193 // 2
    assert nbytes == 48 * 4 * 8192 * h * (2 * 192 + 2 * 128) * 2
    nbytes, ops = counts.decode_attention_bytes_ops(m, [99, 8300], 8256)
    live = 100 + 8256
    assert ops == 48 * 2 * h * (2 * r + dr) * live
    assert nbytes == 48 * (live * 576 * 2 + 2 * h * (576 + 512) * 2 + 2 * 4)


def test_decode_state_mb_equals_the_programs_cache_bytes():
    """At full width on the meta device, the count a decode call of full
    slots reads is every leaf of the engine's latent cache, and the new
    positions' latents written; the port's ``cache_bytes`` agrees."""
    from bench.metrics import decode_state_mb as reader
    from repro_torch.models import cache_bytes
    cfg = harness.model_config(FULL["model"])
    mix = json.loads((testkit.BENCH / "traffic" /
                      "long-docs-4.json").read_text())
    run = harness.RunData(FULL["model"], mix, counts, H100, 0.0, 0.0, 10.0,
                          [], None)
    caches = init_cache(cfg, 4, run.max_len, device="meta")
    whole = sum(leaf.numel() * leaf.element_size()
                for e in caches["groups"] for leaf in e.values())
    assert whole == 48 * 4 * run.max_len * 576 * 2
    lens = [run.max_len] * 4
    run.calls = [Call("decode", 0.0, lens=np.asarray(lens, np.int32))]
    new = 4 * counts.kv_bytes_per_slot(FULL["model"])
    assert reader.read(run) == pytest.approx((whole + new) / 1e6)
    assert cache_bytes(cfg, lens, 1) == whole + new


def _tiny_root(tmp_path):
    testkit.TINY.setdefault("tiny-kanana", TINY)
    return testkit.make_root(tmp_path, configs=("tiny-kanana",))


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_serves_correctly_through_the_harness(tmp_path, trace):
    """The whole run: the layout's weights, the engine's slot refills and
    absorbed decode steps, the reference's check, and with ``trace`` the
    state reader over this family's counts."""
    root = _tiny_root(tmp_path)
    result, lines = harness.run(root, "tiny-kanana", SEED, testkit.SECONDS,
                                trace, CPU, 0.0)
    assert result["correct"], lines
    assert result["checks"]["logit_gap"]["value"] <= testkit.LIMIT
    if trace:
        assert result["metrics"]["decode_state_mb"]["value"] > 0


def test_the_reference_imports_nothing_of_the_program():
    for kind in ("reference", "layouts", "counts"):
        src = (testkit.BENCH / kind / "mla_moe.py").read_text()
        names = {n.module.split(".")[0] if isinstance(n, ast.ImportFrom)
                 else a.name.split(".")[0]
                 for n in ast.walk(ast.parse(src))
                 if isinstance(n, (ast.Import, ast.ImportFrom))
                 for a in n.names}
        assert not names & {"repro_torch", "repro", "jax", "jaxlib"}, kind
    assert harness.forbidden_modules(["bench.reference.mla_moe"]) == []
    assert importlib.import_module("bench.reference.mla_moe") is ref
    assert ref.decode_drops_nothing(FULL["model"], 4)
    assert ref.capacity(4 * 8192, FULL["model"]) == 1920
