"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The checks are chip_smoke.py's own (the decode-attention kernels' cuda
tests on the reference's cases are in tests/test_torch_decode_kernel.py):
  * daxpy: bit-exact, on tests/test_kernels.py's shapes and dtypes, every
    length 1..5000 and unaligned views, and at n = 2^24;
  * fused AdamW: m and v bit-exact, p within one ULP, on
    tests/test_kernels.py's cases;
  * decode attention: the serving shape with the new token on the first or
    last slot of a chunk of the kernels' split, the cases that take the
    kernels' scalar-load build (rows that are no multiple of 16 bytes,
    caches off a 16-byte boundary), and chatglm3-6b's, qwen3-moe's and
    zamba2's streaming shapes and the G = 64 shape on both builds (tensor
    cores, the default for bf16, and ``cuda_core_build()``): caches
    bit-exact, out within chip_smoke.py's ``TOL``; a captured call
    replayed twice, out and caches bit-equal across the calls;
  * the decode kernels' slot-shard form over P = 1, 2, 4 and 16 blocks of
    one cache (chip_smoke.py's ``SHARD_CASES``: the streaming shape with
    the new token on a block's edges, int8 and a ring, decode_32k's
    per-device shape) and over an empty last block: caches bit-exact
    against the plain version, out within ``TOL``, one block bit-equal to
    the whole-cache call;
  * the MoE router's expert-slot kernel: dst and keep bit-equal to
    ``expert_slots_plain`` at chip_smoke.py's ``MOE_ROUTE_CASES``
    (granite-4.0-h-small's 4096 refill and decode call, qwen3-moe-30b-a3b's
    8 x 512 refill and decode call, capacity factor 0.25, two routing
    groups, one tile of copies less one, one, one more, a ragged last
    tile, kanana-2-30b-a3b's 4 x 8192 refill and decode call); a captured
    call replayed twice, bit-equal, one launch counted
    per replay; what it does not take raises;
  * the MoE's expert-FFN kernel: within chip_smoke.py's
    ``experts_tolerance`` of ``expert_ffn_plain`` at qwen3-moe-30b-a3b's,
    granite-4.0-h-small's and kanana-2-30b-a3b's (C = 6) decode calls
    under the cell's routing, one
    kept copy, every expert full, one expert holding C copies and two
    routing groups, dead experts' rows exactly 0; a captured call replayed
    twice bit-equal, one launch per replay, and replayed under other
    routings equal to the eager call under each; what it does not take
    raises;
  * the serving engine queues a prefill-into-slots step and decode steps
    with no host sync (``torch.cuda.set_sync_debug_mode("error")``): graph
    replays, each adding its captured decode-kernel launches and, on the
    MoE, one router-kernel launch per MoE layer;
  * the engine's compiled steps (CUDA graphs) give the token streams of the
    same calls under ``disable_compile()`` (chatglm3-6b fused and unfused,
    qwen3-moe-30b-a3b, mamba2-370m, 2 layers at full width, f32), count
    the decode kernel per replay and the router kernel once per MoE layer
    per replay, and a capture that fails raises;
  * the compiled train step (``launch.train.build``, chatglm3-6b at full
    width, 2 layers, f32): its replays, queued under
    ``set_sync_debug_mode("error")``, give the losses, grad norms and
    params of ``disable_compile()`` bit for bit, with the fused AdamW
    launches re-added per replay; a supervised run with a NaN batch rolls
    back into the leaves the graph holds.

This file imports neither jax nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Every test needs a card and skips itself where there is none.
"""

import contextlib
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import fused_adamw as FA
from repro_torch.kernels import moe_experts as ME
from repro_torch.kernels import moe_route as MR
from repro_torch.kernels._build import LAUNCHES

# The package's ``daxpy`` is the exported function (as in the
# reference); the module holds the kernel's launcher.
DX = importlib.import_module("repro_torch.kernels.daxpy")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_daxpy_kernel_matches_plain_version(card):
    before = LAUNCHES["daxpy"]
    assert SMOKE.check_daxpy(card)["max_abs_err"] == 0.0
    assert LAUNCHES["daxpy"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_daxpy_kernel_bit_exact_at_2_24(card, dt):
    x, y = SMOKE._daxpy_inputs(2 ** 24, card)
    x, y = x.to(SMOKE._dtype(dt)), y.to(SMOKE._dtype(dt))
    assert torch.equal(DX.daxpy(-1.75, x, y), DX.daxpy_plain(-1.75, x, y))


DECODE_CASES = [(c, 0) for c in SMOKE.EDGE_CASES] + SMOKE.SCALAR_LOAD_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case,offset", DECODE_CASES,
                         ids=[c[0] for c, _ in DECODE_CASES])
def test_decode_attention_kernels_match_plain_version(card, case, offset):
    before = LAUNCHES["decode_attention"]
    SMOKE.check_case(case, 0, card, offset)
    # One count per call, two or three launches.
    assert LAUNCHES["decode_attention"] == before + 1


SHARD_PARAMS = [(c, p) for c in SMOKE.SHARD_CASES for p in SMOKE.SHARD_COUNTS]
SHARD_PARAMS += [(("shard-empty-block", "granite-3-8b", 2, 6, 4, 2, 8, "f32",
                   [5, 2], False, False, 0), 4),
                 (("shard-ragged-q8", "chatglm3-6b", 3, 37, 8, 2, 16, "bf16",
                   [36, 12, 25], True, False, 0), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,shards", SHARD_PARAMS,
                         ids=[f"{c[0]}-P{p}" for c, p in SHARD_PARAMS])
def test_decode_attention_shard_form_matches_plain_version(card, case,
                                                           shards):
    before = LAUNCHES["decode_attention_shard"]
    SMOKE.check_shard_case(case, shards, card)
    # One count per block whose kernels launched; an empty block, none.
    assert LAUNCHES["decode_attention_shard"] == before + sum(
        1 for _, size in DA.slot_blocks(case[3], shards) if size)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE.ADAMW_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in SMOKE.ADAMW_CASES])
def test_fused_adamw_kernel_matches_plain_version(card, case):
    shape, dt, step = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    g = torch.Generator().manual_seed(1)
    p = torch.randn(shape, generator=g).to(dtype).to(card)
    gr = (torch.randn(shape, generator=g) * 0.1).to(dtype).to(card)
    m = (torch.randn(shape, generator=g) * 0.01).to(card)
    v = (torch.randn(shape, generator=g).abs() * 0.001).to(card)
    hp = FA.pack_hparams(**SMOKE.ADAMW_HPS, step=step, device=card)
    before = LAUNCHES["fused_adamw"]
    res = SMOKE.check_adamw_tensors(str(case), p, gr, m, v, hp)
    assert res["p_max_ulps"] <= 1 and LAUNCHES["fused_adamw"] == before + 1


@pytest.mark.cuda
def test_fused_adamw_kernel_rejects_what_it_does_not_take(card):
    hp = FA.pack_hparams(**SMOKE.ADAMW_HPS, step=1, device=card)
    p = torch.zeros(256, device=card)
    with pytest.raises(TypeError):       # f32 p with bf16 g
        FA.fused_adamw(p, p.bfloat16(), p.clone(), p.clone(), hp)
    with pytest.raises(ValueError):      # moments on the CPU
        FA.fused_adamw(p, p.clone(), p.cpu(), p.cpu(), hp)
    with pytest.raises(ValueError):      # a strided view
        q = torch.zeros(256, 2, device=card)[:, 0]
        FA.fused_adamw(q, q.clone(), p.clone(), p.clone(), hp)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [SMOKE.MOE_ARCH, SMOKE.HYBRID_ARCH])
def test_decode_attention_at_the_moe_and_hybrid_streaming_shapes(card, arch):
    """qwen3-moe's G=8, D=128 and zamba2's G=1, D=64 at S=1040."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for case in SMOKE.stream_cases(sms, arch):
        SMOKE.check_case(case, 0, card)


# The streaming shapes of three archs, and chip_smoke.py's G = 64 shape.
BUILD_SHAPES = [SMOKE.ARCH, SMOKE.MOE_ARCH, SMOKE.HYBRID_ARCH, "g64"]


def _shape_cases(card, shape):
    if shape == "g64":
        return [SMOKE.BIG_SMEM_CASE]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return SMOKE.stream_cases(sms, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BUILD_SHAPES)
@pytest.mark.parametrize("build", ["tensor-cores", "cuda-cores"])
def test_decode_attention_on_both_builds(card, build, shape):
    """bf16 calls run on the tensor-core build unless
    ``cuda_core_build()`` asks for the other; both against the plain
    version at each shape, one count per call."""
    with (DA.cuda_core_build() if build == "cuda-cores"
          else contextlib.nullcontext()):
        for case in _shape_cases(card, shape):
            before = LAUNCHES["decode_attention"]
            SMOKE.check_case(case, 0, card)
            assert LAUNCHES["decode_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SMOKE.ARCH, "g64"])
def test_captured_decode_replays_are_bit_equal(card, shape):
    """A captured call (chatglm3-6b's streaming shape, lens drawn; the
    G = 64 shape) replayed twice from the same caches: out and caches
    bit-equal to the first call's and the plain version's caches."""
    case = _shape_cases(card, shape)[-1]
    res = SMOKE.check_captured_kernel(card, case)
    assert res["capture_s"] > 0


# --------------------------------------------------------------------------- #
# The MoE router's expert-slot kernel
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE.MOE_ROUTE_CASES,
                         ids=[c[0] for c in SMOKE.MOE_ROUTE_CASES])
def test_moe_route_kernel_bit_equal_to_plain_version(card, case):
    res = SMOKE.check_moe_route(case, card)
    if case[0] == "overflow-cf0.25":
        assert 0 < res["dropped"] < res["groups"] * res["copies"]


ROUTE_CAPTURED = [SMOKE.MOE_ROUTE_CASES[0], SMOKE.MOE_ROUTE_CASES[3]]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROUTE_CAPTURED,
                         ids=[c[0] for c in ROUTE_CAPTURED])
def test_captured_moe_route_replays_are_bit_equal(card, case):
    """A refill's two passes and a decode call's one, captured in a graph
    and replayed twice: bit-equal to the plain version, one launch counted
    per replay."""
    assert SMOKE.check_moe_route_captured(card, case)["capture_s"] > 0


@pytest.mark.cuda
def test_moe_route_rejects_what_it_does_not_take(card):
    ids = torch.zeros(1, 16, dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        MR.expert_slots(ids.int(), 8, 4)
    with pytest.raises(ValueError):
        MR.expert_slots(ids, 100_000, 4)
    with pytest.raises(ValueError):
        MR.expert_slots(ids, 8, -1)


# --------------------------------------------------------------------------- #
# The MoE's expert-FFN kernel
# --------------------------------------------------------------------------- #
EXPERT_PARAMS = [(sh, r) for sh in SMOKE.MOE_EXPERTS_SHAPES
                 for r in SMOKE.MOE_EXPERTS_ROUTINGS]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,routing", EXPERT_PARAMS,
                         ids=[f"{sh}-{r}" for sh, r in EXPERT_PARAMS])
def test_moe_experts_kernel_matches_plain_version(card, shape, routing):
    """Within chip_smoke.py's ``experts_tolerance`` (2^-7 of
    sum_f |h_f||w_out|: the kernel sums in another order than cuBLAS, so a
    bf16 output of either GEMM may round one step the other way), dead
    experts' rows exactly 0, one launch counted."""
    res = SMOKE.check_moe_experts(shape, routing, card)
    assert res["max_err_over_tol"] <= 1
    if routing in ("one-copy", "one-full"):
        assert res["live"] == [1]
    if routing == "all-live":
        assert res["live"] == [SMOKE.MOE_EXPERTS_SHAPES[shape][1]]
    if routing == "two-groups":
        assert res["groups"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SMOKE.MOE_EXPERTS_SHAPES))
def test_captured_moe_experts_follow_the_routing_of_each_replay(card, shape):
    """Two replays of a captured call bit-equal, one launch per replay; a
    graph captured under the cell's routing and replayed under another
    gives the eager result under that routing."""
    res = SMOKE.check_moe_experts_captured(card, shape)
    assert [r["live"] for r in res["replayed_under"]][:2] == [1, 1]


@pytest.mark.cuda
def test_moe_experts_rejects_what_it_does_not_take(card):
    g, e, c, d, f = 1, 8, 4, 128, 64
    buf = torch.zeros(g, e, c, d, dtype=torch.bfloat16, device=card)
    wg = torch.zeros(e, d, f, dtype=torch.bfloat16, device=card)
    wo = torch.zeros(e, f, d, dtype=torch.bfloat16, device=card)
    dst = torch.zeros(g, 8, dtype=torch.int64, device=card)
    keep = torch.ones(g, 8, dtype=torch.bool, device=card)
    assert ME.expert_ffn(buf, wg, wg, wo, dst, keep, "silu").shape == buf.shape
    with pytest.raises(TypeError):                    # dtype
        ME.expert_ffn(buf.float(), wg, wg, wo, dst, keep, "silu")
    with pytest.raises(ValueError):                   # a weight's layout
        ME.expert_ffn(buf, wg.transpose(1, 2).contiguous().transpose(1, 2),
                      wg, wo, dst, keep, "silu")
    with pytest.raises(ValueError):                   # buf's rows
        ME.expert_ffn(buf.transpose(1, 2).contiguous().transpose(1, 2), wg,
                      wg, wo, dst, keep, "silu")
    big = torch.zeros(g, e, 17, d, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):                   # C > 16
        ME.expert_ffn(big, wg, wg, wo, dst, keep, "silu")
    with pytest.raises(ValueError):                   # D not a multiple of 64
        ME.expert_ffn(buf[..., :96].contiguous(), wg[:, :96].contiguous(),
                      wg[:, :96].contiguous(), wo[..., :96].contiguous(),
                      dst, keep, "silu")
    with pytest.raises(ValueError):                   # fewer experts than buf's
        ME.expert_ffn(buf, wg[:4], wg[:4], wo[:4], dst, keep, "silu")
    with pytest.raises(ValueError):                   # no kernel for gelu
        ME.expert_ffn(buf, wg, wg, wo, dst, keep, "gelu")
    assert not ME.takes(big, wg, wg, wo, "silu")
    assert not ME.takes(buf.float(), wg, wg, wo, "silu")


@pytest.mark.cuda
def test_engine_queues_steps_without_a_host_sync(card):
    """prefill_into_slots_async and decode_async under
    set_sync_debug_mode("error") (dense, MoE and hybrid, reduced)."""
    res = SMOKE.check_no_sync(card)
    assert set(res) == set(SMOKE.NO_SYNC_ARCHS)


# --------------------------------------------------------------------------- #
# The serving engine's compiled steps (CUDA graphs)
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("arch", [SMOKE.ARCH, SMOKE.MOE_ARCH, SMOKE.SSM_ARCH])
def test_compiled_engine_gives_the_eager_tokens(card, arch):
    """The stream trace at full width, 2 layers, f32: the engine's replayed
    graphs give the token streams and decode-kernel launches of the same
    calls under disable_compile(), fused and unfused."""
    res = SMOKE.phase_stream_fused_vs_unfused(card, arch, 2)
    assert set(res["compiled"]) == {"fused-compiled", "unfused-compiled"}
    assert all(rep["replays"] > 0 for rep in res["compiled"].values())


@pytest.mark.cuda
def test_decode_launches_are_counted_per_replay(card):
    import numpy as np
    from repro_torch.serve import ServingEngine

    eng = ServingEngine(SMOKE.ARCH, max_batch=4, max_len=48,
                        fused_decode=True, device=card)
    n_attn = SMOKE.attention_layers(eng.cfg)
    tok, caches, _ = eng.prefill(np.zeros((4, 16), np.int32))
    LAUNCHES["decode_attention"] = 0
    tok, caches, _ = eng.decode(tok[:, None], caches, 16)   # eager + capture
    assert LAUNCHES["decode_attention"] == n_attn
    for i in range(2):                                      # replays
        tok, caches, _ = eng.decode(tok[:, None], caches, 17 + i)
    assert LAUNCHES["decode_attention"] == 3 * n_attn
    [st] = eng._dec_jit.stats()
    assert st["captured"] and st["calls"] == 3
    assert st["launches_per_replay"] == {"decode_attention": n_attn}


@pytest.mark.cuda
def test_decode_kernel_captured_at_a_large_shared_memory_shape(card):
    res = SMOKE.check_captured_kernel(card)
    assert res["capture_s"] > 0


@pytest.mark.cuda
def test_a_capture_that_fails_raises(card):
    """A step that syncs the host cannot be captured: the call raises."""
    from repro_torch.launch.compile import CompiledStep

    step = CompiledStep(lambda x: {"y": x * float(x.sum().item())},
                        device=card)
    with pytest.raises(RuntimeError):
        step(torch.ones(4, device=card))
    assert step.keys() == []


# --------------------------------------------------------------------------- #
# The compiled train step
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_compiled_train_step_equals_eager(card):
    cfg = SMOKE.train_cfg(2, "float32")
    comp = SMOKE.train_steps(card, cfg)        # steps 1.. under "error"
    [st] = comp["stats"]
    n = sum(p.ndim >= 1 and p.numel() >= 128 for p in comp["params"])
    assert st["captured"] and st["calls"] == SMOKE.TRAIN_CHECK_STEPS
    assert st["launches_per_replay"] == {"fused_adamw": n}
    assert comp["launches"] == n * SMOKE.TRAIN_CHECK_STEPS
    eager = SMOKE.train_steps(card, cfg, compiled=False)
    assert comp["losses"] == eager["losses"]
    assert comp["grad_norms"] == eager["grad_norms"]
    assert all(torch.equal(a, b) for a, b in zip(comp["params"],
                                                   eager["params"]))


@pytest.mark.cuda
def test_train_rollback_restores_into_the_captured_leaves(card):
    res = SMOKE.check_train_rollback(card)
    assert res["steps_done"] == SMOKE.ROLLBACK_NAN_AT + SMOKE.TRAIN_CHECK_STEPS
    assert [g["calls"] for g in res["graphs"]] == [res["steps_done"], 1]
