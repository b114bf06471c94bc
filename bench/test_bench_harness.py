"""CPU tests of the benchmark's harness: discovery by name, seeded traffic,
the result line, the counts, and what the harness imports."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, testkit, traffic
from bench.counts import dense as dense_counts, moe as moe_counts

CPU = torch.device("cpu")
REPO = testkit.REPO
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def run(root, name, trace=False, seconds=testkit.SECONDS, seed=2 ** 31 + 7, **kw):
    return harness.run(root, name, seed, seconds, trace, CPU, 0.0, **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testkit.make_root(tmp_path_factory.mktemp("bench"))


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = REPO / "bench"
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (bench / "layouts" / f"{cfg['family']}.py").is_file()
        assert (bench / "reference" / f"{cfg['family']}.py").is_file()
        assert (bench / "counts" / f"{cfg['family']}.py").is_file()
    for w in spec["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


def test_a_cell_added_as_files_and_entries_is_found(tmp_path):
    """A new configuration, traffic mix, metric and cell: new files and
    new entries only, and the run reports the new metric."""
    r = testkit.make_root(tmp_path, configs=("tiny-dense",))
    cfg = dict(testkit.TINY["tiny-dense"], name="tiny-dense-3l",
               num_layers=3)
    (r / "bench/configs/tiny-dense-3l.json").write_text(json.dumps(
        {"name": "tiny-dense-3l", "family": "dense", "reduced": [],
         "model": cfg}))
    mix = dict(testkit.MIX, slots=3, prompt_lens=[12], gen_lens=[5],
               requests=5000)
    (r / "bench/traffic/tiny-3.json").write_text(json.dumps(mix))
    (r / "bench/metrics/decode_calls.py").write_text(
        "def read(run):\n"
        "    return sum(c.kind == 'decode' for c in run.calls)\n")
    (r / "bench/limits/new-cell.json").write_text(json.dumps(
        {"logit_gap": {"limit": testkit.LIMIT},
         "mismatch_share": {"limit": testkit.SHARE}}))
    spec = json.loads((r / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dense-3l", "source": "test",
                            "file": "bench/configs/tiny-dense-3l.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "new-cell", "config": "tiny-dense-3l",
                              "traffic": "tiny-3", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "decode_calls", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["new-cell"]})
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = run(r, "new-cell")
    assert result["correct"], result["checks"]
    assert result["metrics"]["decode_calls"]["value"] > 0
    other, _ = run(r, "tiny-dense")
    assert "decode_calls" not in other["metrics"]
    # The per-layer metrics that list no cells read the new cell too.
    traced, _ = run(r, "new-cell", trace=True)
    assert {"batcher_host_ms", "prefill_job_ms", "decode_step_ms"} <= \
        set(traced["metrics"])


def test_a_per_layer_metric_follows_what_it_moves(tmp_path):
    """A per-layer metric without a ``workloads`` list is read in every
    cell that reports the end-to-end metric it moves, and in no other."""
    r = testkit.make_root(tmp_path, configs=("tiny-dense", "tiny-moe"))
    spec = json.loads((r / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "only_moe", "unit": "s",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-moe"]})
    spec["per_layer"].append({"name": "moves_only_moe", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "x", "moves": "only_moe"})
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    names = {c: [m["name"] for m in harness.Cell.load(r, c).metrics(True)]
             for c in ("tiny-dense", "tiny-moe")}
    assert "moves_only_moe" in names["tiny-moe"]
    assert "moves_only_moe" not in names["tiny-dense"]
    every = [m["name"] for m in spec["per_layer"][:-1]]
    assert all(n in names["tiny-dense"] for n in every)


def test_device_idle_is_carried_over_from_the_traced_calls():
    """The traced calls give device seconds per call kind (a prefill's per
    FLOP) and between calls; the untraced calls and gaps, at the host's
    own pace, take them over."""
    from bench.metrics import device_idle_pct
    from bench.trace import Trace
    from bench.window import Call
    m = testkit.TINY["tiny-dense"]
    calls, t = [], 0.0

    def add(kind, wall, gap, traced=False, length=8):
        nonlocal t
        c = Call(kind, t + gap, t + gap + wall, traced=traced)
        if kind == "prefill":
            c.tokens = np.zeros((2, length), np.int64)
        calls.append(c)
        t = c.t1

    for _ in range(4):                    # untraced: 10 ms calls, 1 ms gaps
        add("prefill", 0.010, 0.001, length=16)
        add("decode", 0.010, 0.001)
    for _ in range(3):                    # traced: the profiler's 20 ms
        add("prefill", 0.020, 0.001, traced=True)
        add("decode", 0.020, 0.001, traced=True)
    for _ in range(4):
        add("prefill", 0.010, 0.001, length=16)
        add("decode", 0.010, 0.001)
    spans = [(c.kind, c.t0, c.t1) for c in calls if c.traced]
    device = []
    for kind, a, b in spans:             # prefill of 8: 4 ms, decode 6 ms
        device.append(("k", a + 0.001, a + (0.005 if kind == "prefill"
                                            else 0.007)))
    for (_, _, b), (_, a, _) in zip(spans, spans[1:]):
        device.append(("copy", b, a))    # the whole 1 ms gap busy
    trace = Trace(spans, device, [[e] for e in device[:len(spans)]])
    run_data = harness.RunData(m, testkit.MIX, dense_counts, None, 0.0, 0.0,
                               t, calls, None, trace)
    calls_u, gaps, seconds = run_data.clean()
    assert len(calls_u) == 16
    per_prefill = 0.004 / dense_counts.prefill_flops(m, 8) \
        * dense_counts.prefill_flops(m, 16)
    busy = 8 * per_prefill + 8 * 0.006 + len(gaps) * 0.001
    assert device_idle_pct.read(run_data) == pytest.approx(
        100 * (1 - busy / seconds))
    assert device_idle_pct.read(dataclasses.replace(
        run_data, trace=Trace(spans, [], [[] for _ in spans]))) is None


def test_traffic_is_the_same_from_the_same_seed():
    """The seed draws the prompts; every seed serves the same sizes in the
    same order, in rounds holding every (prompt, output) pair once."""
    mix = traffic.load("long-prompts-4")
    a = traffic.draw(mix, 2 ** 33 + 5, 65024)
    b = traffic.draw(mix, 2 ** 33 + 5, 65024)
    c = traffic.draw(mix, 2 ** 33 + 6, 65024)
    assert len(a) == mix["requests"]
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    assert [(p, g) for p, g, _ in a] == [(p, g) for p, g, _ in c]
    assert not any(np.array_equal(x[2], y[2]) for x, y in zip(a, c))
    n = len(mix["prompt_lens"]) * len(mix["gen_lens"])
    pairs = sorted((p, g) for p in mix["prompt_lens"] for g in mix["gen_lens"])
    for i in range(0, len(a) - n + 1, n):
        assert sorted((p, g) for p, g, _ in a[i:i + n]) == pairs


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(root, name, trace):
    result, lines = run(root, name, trace=trace)
    keys = RESULT_KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = json.loads((root / "BENCHMARK.json").read_text())
    want = [m["name"] for m in spec["per_layer" if trace else "end_to_end"]]
    # The CPU has no device trace and no peaks: those readers are silent.
    cpu_silent = {"decode_step_bw_pct", "decode_attention_roofline",
                  "device_idle_pct", "serve_mfu_pct",
                  "prefill_attention_roofline"}
    assert set(result["metrics"]) == set(want) - cpu_silent
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    # The compared numbers beside their limits are the last lines.
    assert list(result["checks"]) == ["logit_gap", "mismatch_share",
                                      "tokens_compared", "audit_problems"]
    tail = lines[-len(result["checks"]):]
    assert all(line.startswith(f"check {k}: {v['value']} (limit "
                               f"{v['limit']}, ")
               for line, (k, v) in zip(tail, result["checks"].items()))
    json.dumps(result)


def test_run_py_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench" / "run.py"), "--workload",
         "glm3-6b.prefill-heavy", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_py_imports_neither_jax_nor_the_jax_package():
    """Everything the harness imports, the program's serving stack with it:
    no top-level module is ``jax`` or ``repro`` (``repro_torch`` is not)."""
    code = (
        "import sys; sys.path[:0] = [{src!r}, {repo!r}]\n"
        "import bench.run, bench.harness, bench.control, bench.check\n"
        "import bench.reference.dense, bench.reference.moe\n"
        "import repro_torch.serve.batcher, repro_torch.serve.calibrator\n"
        "import repro_torch.serve.scheduler, repro_torch.serve.fabric\n"
        "import repro_torch.kernels._build\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(src=str(REPO / "src"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    tops = set(json.loads(out.strip().replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serve", "reproduce", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["repro.serve", "jax.numpy", "flax", "jaxlib.xla"]) == \
        ["flax", "jax", "jaxlib", "repro"]


GLM = json.loads((REPO / "bench/configs/chatglm3-6b.json").read_text())["model"]
QWEN = json.loads(
    (REPO / "bench/configs/qwen3-moe-30b-a3b.json").read_text())["model"]


def test_configurations_hold_the_published_parameter_counts():
    from bench.weights import param_count
    assert param_count(GLM, testkit.layout(GLM)) == 6_243_454_976
    # 152,064 padded rows
    assert param_count(QWEN, testkit.layout(QWEN)) == 30_532_634_624


def test_dense_counts_by_hand():
    # chatglm3-6b: per layer q 4096x4096, k and v 4096x256, o 4096x4096,
    # MLP 3 x 4096x13696; 28 layers; head 4096 x 65024.
    per_layer = 4096 * 4096 * 2 + 4096 * 256 * 2 + 3 * 4096 * 13696
    head = 4096 * 65024
    assert dense_counts.token_flops(GLM) == 2 * 28 * per_layer
    # A decode token at position 99 attends 100 keys: 4 * 32 heads * 128.
    assert dense_counts.decode_flops(GLM, 99) == \
        2 * 28 * per_layer + 28 * 4 * 32 * 128 * 100 + 2 * head
    # A 3-token prompt: keys 1 + 2 + 3.
    assert dense_counts.prefill_flops(GLM, 3) == \
        3 * 2 * 28 * per_layer + 28 * 4 * 32 * 128 * 6 + 2 * head
    # Two rows at positions 10 and 20: weights once (bf16), f32 norms,
    # 2 embedding rows, the live cache (30 slots) and 2 new slots.
    slot = 28 * 2 * 2 * 128 * 2
    assert dense_counts.decode_step_bytes(GLM, [10, 20]) == \
        (28 * per_layer * 2 + 28 * 2 * 4096 * 4 + head * 2 + 4096 * 4
         + 2 * 4096 * 2 + slot * 32)
    # Attention kernel: lens 5 and 7 in 64 slots; K=2, D=128, H=32, W=32.
    nbytes, ops = dense_counts.decode_attention_bytes_ops(GLM, [5, 7], 64)
    live = 6 + 8
    assert ops == 28 * 4 * 32 * 128 * live
    assert nbytes == 28 * (live * 2 * 2 * 128 * 2 + 2 * 2 * 2 * 128 * 2
                           + 2 * 32 * 128 * 2 * 2 + 2 * 2 * 128 * 2 * 2
                           + 2 * (2 * 32 * 4 + 4))


def test_moe_counts_by_hand():
    attn = 2048 * 128 * 32 * 2 + 2048 * 128 * 4 * 2
    per_token = attn + 2048 * 128 + 8 * 3 * 2048 * 768
    assert moe_counts.token_flops(QWEN) == 2 * 48 * per_token
    experts = [50] * 48
    head = 2048 * 151936
    slot = 48 * 2 * 4 * 128 * 2
    assert moe_counts.decode_step_bytes(QWEN, [100], experts) == \
        (48 * (attn * 2 + 2 * 2048 * 4) + 48 * 2048 * 128 * 4
         + 50 * 48 * 3 * 2048 * 768 * 2 + head * 2 + 2048 * 4 + 2048 * 2
         + slot * 101)
    with pytest.raises(ValueError):
        moe_counts.decode_step_bytes(QWEN, [100])


def test_replay_follows_the_slots(root):
    """The harness's own count of served tokens equals the program's, and
    every finished request's output is the tokens its calls returned."""
    cell = harness.Cell.load(root, "tiny-dense")
    from bench.weights import draw
    weights = draw(cell.model, 3, CPU, cell.family("layouts"))
    engine = harness.build_engine(cell, weights, CPU)
    reqs = harness.requests_for(cell.mix, 3, cell.model["vocab_size"])
    timed, batcher, drained = harness.serve_window(engine, reqs,
                                                   testkit.SECONDS)
    assert not drained
    served, prefill_of, finished, problems = harness.audit(
        timed.calls, reqs, cell.mix["slots"], batcher.metrics)
    assert problems == [] and finished
    assert sum(map(len, served.values())) == batcher.metrics.tokens_generated
    decodes = [c for c in timed.calls if c.kind == "decode"]
    assert all(len(c.rows) <= cell.mix["slots"] for c in decodes)
    assert set(prefill_of) == set(served)
