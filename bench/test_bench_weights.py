"""CPU tests of the weights the harness draws: the program's parameter tree
for any layer stack, each block's leaves from the family's layout; for the
configurations the benchmark runs, the same leaves in the same order from
the same seed as the one-kind drawing the layouts replaced (a frozen copy
below); and the prefill attention's work counted by the family."""

from __future__ import annotations

import importlib
import json
import math

import numpy as np
import pytest
import torch

from bench import harness, peaks, testkit, weights
from bench.layouts import dense as dense_layout
from bench.trace import Trace
from bench.window import Call

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
CONFIGS = {n: json.loads((testkit.BENCH / "configs" / f"{n}.json")
                         .read_text())["model"]
           for n in ("chatglm3-6b", "qwen3-moe-30b-a3b")}
H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


# The one-kind drawing, frozen: every leaf of the pattern's single kind
# stacked under ("groups", 0), then the final norm and an untied LM head.
def frozen_leaf_shapes(m: dict) -> dict:
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    h, kh, dt = m["num_heads"], m["num_kv_heads"], m["dtype"]
    attn = {"wq": ((d, h * hd), d ** -0.5, dt),
            "wk": ((d, kh * hd), d ** -0.5, dt),
            "wv": ((d, kh * hd), d ** -0.5, dt),
            "wo": ((h * hd, d), (h * hd) ** -0.5, dt)}
    out = {"norm1": ((d,), 0.1, "float32"),
           "norm2": ((d,), 0.1, "float32"), "attn": attn}
    if m.get("num_experts", 0):
        e = m["num_experts"]
        out["moe"] = {"w_router": ((d, e), d ** -0.5, "float32"),
                      "w_gate": ((e, d, f), d ** -0.5, dt),
                      "w_in": ((e, d, f), d ** -0.5, dt),
                      "w_out": ((e, f, d), f ** -0.5, dt)}
    else:
        out["mlp"] = {"w_in": ((d, f), d ** -0.5, dt),
                      "w_gate": ((d, f), d ** -0.5, dt),
                      "w_out": ((f, d), f ** -0.5, dt)}
    return out


def frozen_specs(m: dict) -> list:
    n, d = m["num_layers"], m["d_model"]
    q = m.get("vocab_pad_to", 1)
    vp = -(-m["vocab_size"] // q) * q
    out = [(("embed",), (vp, d), 0.02, m["dtype"])]

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out.append((path + (k,), (n, *v[0]), v[1], v[2]))

    walk(frozen_leaf_shapes(m), ("groups", 0))
    out.append((("final_norm",), (d,), 0.1, "float32"))
    out.append((("lm_head",), (d, vp), d ** -0.5, m["dtype"]))
    return out


def frozen_draw(m: dict, seed: int) -> dict:
    tree = {"groups": ({},), "tail": ()}
    specs = frozen_specs(m)
    for path, shape, _, dt in specs:
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, dtype=weights.DTYPES[dt])
    gen = torch.Generator().manual_seed(seed)
    for path, _, std, _ in specs:
        leaf = tree
        for k in path:
            leaf = leaf[k]
        leaf.normal_(0.0, std, generator=gen)
    return tree


def frozen_least_s(model: dict, batch: int, length: int, pk: dict) -> float:
    """The prefill-attention reader's least time before it asked the
    family's counts: every layer one causal attention."""
    h, kh, d = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    ops = 4 * batch * h * d * length * (length + 1) // 2
    nbytes = batch * length * (2 * h + 2 * kh) * d * \
        {"bfloat16": 2, "float16": 2, "float32": 4}[model["dtype"]]
    return model["num_layers"] * max(ops / pk["bf16_flops"],
                                     nbytes / pk["hbm_bytes_s"])


def leaves(tree, path=()):
    """(path, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in leaves(v, path + (k,))]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_published_configurations_keep_their_leaves(name):
    """Path, shape, std, dtype and drawing order, entry by entry."""
    m = CONFIGS[name]
    assert weights.specs(m, testkit.layout(m)) == frozen_specs(m)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_tiny_draws_are_bit_equal_to_the_one_kind_drawing(name):
    m = testkit.TINY[name]
    got = leaves(weights.draw(m, SEED, CPU, testkit.layout(m)))
    want = leaves(frozen_draw(m, SEED))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch,length", [(4, 2048), (4, 512), (8, 256),
                                          (8, 64), (1, 1), (3, 1537)])
def test_prefill_attention_is_counted_by_the_family(name, batch, length):
    m = CONFIGS[name]
    counts = importlib.import_module(f"bench.counts.{m['family']}")
    nbytes, ops = counts.prefill_attention_bytes_ops(m, batch, length)
    least = max(nbytes / H100["hbm_bytes_s"], ops / H100["bf16_flops"])
    assert least == pytest.approx(frozen_least_s(m, batch, length, H100),
                                  rel=1e-12)


def test_prefill_attention_roofline_reads_the_family_counts():
    """Two traced prefill calls, the kernel 4 and 1 ms of each; a decode
    call and other kernels are not read.  The same where the profile's
    clock puts the first call's kernel in the next call.  Without the
    kernel: None."""
    from bench.metrics import prefill_attention_roofline as reader
    m = CONFIGS["chatglm3-6b"]
    counts = importlib.import_module(f"bench.counts.{m['family']}")
    calls, device = [], []
    for i, (kind, length, ms) in enumerate([("prefill", 2048, 4.0),
                                            ("decode", 0, 0.0),
                                            ("prefill", 512, 1.0)]):
        c = Call(kind, i * 0.1, i * 0.1 + 0.05, traced=True)
        if kind == "prefill":
            c.tokens = np.zeros((4, length), np.int64)
            device.append(("prefill_attention_fwd<128>", c.t0 + 0.001,
                           c.t0 + 0.001 + ms / 1e3))
        device.append(("nvjet_gemm", c.t0 + 0.02, c.t0 + 0.03))
        calls.append(c)
    spans = [(c.kind, c.t0, c.t1) for c in calls]

    def trace(device):
        return Trace(spans, device, [[e for e in device if c.t0 <= e[1] < c.t1]
                                     for c in calls])

    run = harness.RunData(m, testkit.MIX, counts, H100, 0.0, 0.0, 0.3,
                          calls, None, trace(device))
    want = 100 * (frozen_least_s(m, 4, 2048, H100)
                  + frozen_least_s(m, 4, 512, H100)) / 5e-3
    assert reader.read(run) == pytest.approx(want, rel=1e-9)
    late = [(n, a + 0.1, b + 0.1) if n.startswith("prefill") and a < 0.1
            else (n, a, b) for n, a, b in device]
    run.trace = trace(late)
    assert reader.read(run) == pytest.approx(want, rel=1e-9)
    run.trace = trace([e for e in device if "prefill_attention" not in e[0]])
    assert reader.read(run) is None


def _program_leaves(m: dict) -> dict:
    from repro_torch.models import init_params
    tree = init_params(harness.model_config(m), seed=0, device="meta")
    return {p: (tuple(t.shape), t.dtype) for p, t in leaves(tree)}


@pytest.mark.parametrize("name", ["tiny-mixed", "tiny-mixed-tied"])
def test_a_mixed_stack_is_drawn_in_the_programs_layout(name):
    """Two groups of (local, local, attn) and a one-block tail: the paths,
    shapes and dtypes of the program's own ``init_params``."""
    m = testkit.TINY[name]
    tree = weights.draw(m, SEED, CPU, testkit.layout(m))
    got = {p: (tuple(t.shape), t.dtype) for p, t in leaves(tree)}
    assert got == _program_leaves(m)
    assert len(tree["groups"]) == 3 and len(tree["tail"]) == 1
    assert ("lm_head" in tree) == (not m.get("tie_embeddings", False))
    assert weights.param_count(m, testkit.layout(m)) == sum(
        math.prod(s) for s, _ in got.values())


class SharedLayout:
    """The dense family's blocks, with ``shared_attn`` positions invoking
    one shared ``attn`` block, as the program's hybrid stack has them."""
    SHARED = "attn"

    @staticmethod
    def block(m, kind):
        return {} if kind == "shared_attn" else dense_layout.block(m, kind)


def test_a_shared_block_is_drawn_once():
    m = dict(testkit.TINY["tiny-dense"], num_layers=5,
             pattern=["attn", "shared_attn"])
    tree = weights.draw(m, SEED, CPU, SharedLayout)
    got = {p: (tuple(t.shape), t.dtype) for p, t in leaves(tree)}
    assert got == _program_leaves(m)
    assert tree["groups"][1] == {} and "attn" in tree["shared"]


@pytest.mark.parametrize("name", ["tiny-mixed", "tiny-mixed-tied"])
def test_a_mixed_stack_serves(tmp_path, name):
    """The engine takes the drawn tree and serves tokens from it through
    the window, every finished request's tokens its calls' own."""
    root = testkit.make_root(tmp_path, configs=(name,), limit=None)
    cell = harness.Cell.load(root, name)
    tree = weights.draw(cell.model, SEED, CPU, cell.family("layouts"))
    engine = harness.build_engine(cell, tree, CPU)
    reqs = harness.requests_for(cell.mix, SEED, cell.model["vocab_size"])
    timed, batcher, _ = harness.serve_window(engine, reqs, 1.0)
    served, _, finished, problems = harness.audit(
        timed.calls, reqs, cell.mix["slots"], batcher.metrics)
    assert problems == [] and finished
    assert batcher.metrics.tokens_generated > 0


def test_a_family_without_a_layout_fails_at_set_up(tmp_path):
    root = testkit.make_root(tmp_path, configs=("tiny-dense",))
    path = root / "bench" / "configs" / "tiny-dense.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["family"] = cfg["family"] = "nolayout"
    path.write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match="bench/layouts/nolayout.py"):
        harness.run(root, "tiny-dense", SEED, 1.0, False, CPU, 0.0)
