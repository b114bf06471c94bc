"""The port's dry run (``repro_torch.launch.dryrun``): a step run once on a
fake process group under ``FakeTensorMode``, with a census of per-device
memory, FLOPs and collectives.  The counterparts of
``tests/test_dryrun.py``'s miniature cell and int8-KV decode bundle, plus:

  * both miniature cells held against the reference's dry run of the same
    config on the same mesh (compiled in a subprocess on 8 forced host
    devices, as ``tests/test_dryrun.py`` compiles them): argument bytes
    equal, peak bytes and FLOPs within the ratios stated beside the tests;
  * a production cell through the CLI (chatglm3-6b x decode_32k on the
    16x16 mesh) writes a record with the reference's keys, whose argument
    bytes are exactly the local shards its specs give each device, whose
    FLOPs are ``cell_cost``'s (within the reference's own 20 %), whose
    collectives ``CommDebugMode`` counts the same, and whose decode moves
    no cache-sized collective: three all-reduces per attention layer over
    the model axis, of (B_local, H) and (B_local, H, D) elements;
  * an inapplicable cell is written as the reference writes it, and a cell
    that fails is written ``ok: false`` with its error and traceback;
  * the census's totals follow the reference's ring model of effective
    bytes.
"""

from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.configs.shapes import input_specs
from repro_torch.launch import dryrun
from repro_torch.models import init_cache, scaled_down

RECORD_KEYS = {"arch", "shape", "mesh", "devices", "ok", "lower_s",
               "compile_s", "memory", "cost_analysis", "collectives",
               "full_groups", "moe_groups"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes"}
COLLECTIVE_KEYS = {"per_device_bytes_by_kind", "per_device_bytes_total",
                   "effective_bytes_by_kind", "effective_bytes_total",
                   "num_ops", "ops_summary"}


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


# The miniature cells of tests/test_dryrun.py: (arch, shape, mesh, config
# changes); the train batch is (8, 32) tokens, the decode batch 4 rows of a
# 64-slot int8 cache.
CELLS = {
    "train": ("qwen3-moe-30b-a3b", "train_4k", (4, 2),
              {"num_heads": 4, "num_kv_heads": 2, "moe_groups": 8}),
    "decode": ("granite-3-8b", "decode_32k", (2, 4),
               {"kv_quant": True, "num_heads": 4, "num_kv_heads": 2}),
    # One layer: the reference's decode step scans its layers even when
    # asked to unroll, and XLA's cost analysis counts a loop body once
    # (EXPERIMENTS.md), so its FLOPs are whole only for one layer.
    "decode_1layer": ("granite-3-8b", "decode_32k", (2, 4),
                      {"kv_quant": True, "num_heads": 4, "num_kv_heads": 2,
                       "num_layers": 1}),
    # The decode cell with a cache of 256 slots, not 64 (SLOTS).
    "decode_256": ("granite-3-8b", "decode_32k", (2, 4),
                   {"kv_quant": True, "num_heads": 4, "num_kv_heads": 2}),
}
# Cache slots of a decode cell (64 but where given).
SLOTS = {"decode_256": 256}


def _cell_cfg(name):
    arch, _, _, changes = CELLS[name]
    return dataclasses.replace(scaled_down(get_config(arch)), **changes)


def _port_record(name):
    cfg = _cell_cfg(name)
    _, shape, mesh, _ = CELLS[name]
    if shape == "train_4k":
        specs = {"tokens": _meta((8, 32))}
    else:
        specs = {"tokens": _meta((4, 1)),
                 "caches": init_cache(cfg, 4, max_len=SLOTS.get(name, 64),
                                      device="meta"),
                 "cache_len": _meta(())}
    return dryrun.run_step(cfg, shape, specs, mesh)


@pytest.fixture(scope="module")
def port_records():
    return {name: _port_record(name) for name in CELLS}


REF_CELLS = """
import dataclasses, json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.dryrun import cost_analysis_dict
from repro.launch.mesh import make_mesh
from repro.launch.steps import bundle_for
from repro.models import init_cache, scaled_down

CELLS = %r
SLOTS = %r
out = {}
for name, (arch, shape, mesh_shape, changes) in CELLS.items():
    cfg = dataclasses.replace(scaled_down(get_config(arch)), **changes)
    if shape == "train_4k":
        specs = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
    else:
        specs = {"tokens": jax.ShapeDtypeStruct((4, 1), jnp.int32),
                 "caches": jax.eval_shape(
                     lambda: init_cache(cfg, 4,
                                        max_len=SLOTS.get(name, 64))),
                 "cache_len": jax.ShapeDtypeStruct((), jnp.int32)}
    mesh = make_mesh(mesh_shape, ("data", "model"))
    # As the reference's dry run compiles it, and unrolled for its FLOPs.
    for unroll in (False, True):
        b = bundle_for(cfg, mesh, shape, specs, unroll_groups=unroll)
        with mesh:
            c = jax.jit(b.fn, in_shardings=b.in_shardings,
                        out_shardings=b.out_shardings,
                        donate_argnums=b.donate_argnums
                        ).lower(*b.abstract_args).compile()
        ma = c.memory_analysis()
        out[name + ("_unrolled" if unroll else "")] = {
            "argument_bytes": ma.argument_size_in_bytes,
            "output_bytes": ma.output_size_in_bytes,
            "temp_bytes": ma.temp_size_in_bytes,
            "alias_bytes": ma.alias_size_in_bytes,
            "flops": cost_analysis_dict(c).get("flops")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_records():
    from conftest import run_py
    r = run_py(REF_CELLS % (CELLS, SLOTS), devices=8)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["train", "decode", "decode_1layer"])
def test_argument_bytes_equal_the_reference(name, port_records,
                                            ref_records):
    # Every argument's local shard, byte for byte: the same specs place
    # the same params, moments, batch and caches on each device.
    assert port_records[name]["memory"]["argument_bytes"] == \
        ref_records[name]["argument_bytes"]


# The port's peak (arguments + the census's peak of live temporaries)
# against the reference's standard decomposition (arguments + outputs +
# temporaries - aliased, ``peak_memory_bytes`` on older jaxlib; the CPU
# backend's own peak field counts the arguments alone) of the build its
# dry run compiles.  Both hold the same arguments; the temporaries differ
# by what XLA fuses away (fewer: elementwise chains live in registers) and
# what its buffer assignment and schedule keep (more: the layer scan's
# stacked residuals, weight all-gathers issued ahead of their use).  25 %
# either way holds both effects (train measured 1.10).
#
# The decode cells' reference peak leaves out what XLA's schedule adds to
# its live set and the port's does not: the reference issues the data-axis
# all-gathers of the MLP's three weights (w_gate, w_in, w_out, each a
# (d_model, d_ff / model) shard) before their dots and keeps a transposed
# copy of w_out, four such buffers live at once, where the port holds one
# (its compiled HLO, ``Compiled.as_text()``: all-gather.61-63 and copy.12
# ahead of dot.53).  The decode cell is held at 64 and 256 slots against
# the reference less three of those buffers, and by the growth of the
# peak from 64 to 256 slots, which a device that gathers the cache
# multiplies by the model axis (4 here).  Measured, port over that
# bound: 0.90 at 64 slots, 0.96 at 256 (over the reference itself 0.73
# and 0.83); growth 1.09.
PEAK_RATIO = 0.25


def _held_weight_gathers(name) -> int:
    """Bytes of the MLP weight gathers the reference keeps live beyond the
    port's one: three (d_model, d_ff / model) shards."""
    cfg = _cell_cfg(name)
    model = CELLS[name][2][1]
    size = torch.empty(0, dtype=getattr(torch, cfg.dtype)).element_size()
    return 3 * cfg.d_model * (cfg.d_ff // model) * size


def _ref_peak(rec) -> int:
    return (rec["argument_bytes"] + rec["output_bytes"] + rec["temp_bytes"]
            - rec["alias_bytes"])


@pytest.mark.parametrize("name", ["train", "decode"])
def test_peak_bytes_within_the_reference(name, port_records, ref_records):
    def peak(n):
        return port_records[n]["memory"]["peak_bytes"], \
            _ref_peak(ref_records[n])

    if name == "train":
        pairs = [peak("train")]
    else:
        (p64, r64), (p256, r256) = peak("decode"), peak("decode_256")
        pairs = [(p64, r64 - _held_weight_gathers("decode")),
                 (p256, r256 - _held_weight_gathers("decode_256")),
                 (p256 - p64, r256 - r64)]
    for got, want in pairs:
        assert abs(got / want - 1) <= PEAK_RATIO, (got, want)


# The port counts matmul-class ops (``FlopCounterMode``'s formulas), XLA
# also counts elementwise ops; the reference's own test holds XLA's count
# to the matmul count within 20 % (tests/test_analytics.py).  Both split
# the decode cell's attention over the slots on the model axis, so the
# counts are compared as they are.
FLOPS_RTOL = 0.20


@pytest.mark.parametrize("name", ["train", "decode_1layer"])
def test_flops_match_the_reference(name, port_records, ref_records):
    got = port_records[name]["cost_analysis"]["flops_per_device"]
    want = ref_records[name + "_unrolled"]["flops"]
    assert got == pytest.approx(want, rel=FLOPS_RTOL)


def test_miniature_train_cell_end_to_end(port_records):
    rec = port_records["train"]
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    # Params and moments are updated in place.
    assert rec["memory"]["alias_bytes"] > 0
    colls = rec["collectives"]
    assert COLLECTIVE_KEYS <= set(colls)
    assert colls["per_device_bytes_total"] > 0
    kinds = {k for k, v in colls["per_device_bytes_by_kind"].items() if v}
    # FSDP gathers the weights; the grads' reduction scatters them back.
    assert {"all-gather", "reduce-scatter"} <= kinds
    assert rec["cost_analysis"]["flops"] == \
        8 * rec["cost_analysis"]["flops_per_device"] > 0


def test_decode_bundle_with_kv_quant(port_records):
    rec = port_records["decode"]
    assert rec["memory"]["peak_bytes"] > 0
    # The int8 caches and their scales are updated in place.
    cfg = _cell_cfg("decode")
    caches = sum(x.numel() * x.element_size() for x in pytree.tree_leaves(
        init_cache(cfg, 4, max_len=64, device="meta")))
    assert rec["memory"]["alias_bytes"] == caches // 8


def _local_bytes(tree, spec_tree, mesh_shape, axes) -> int:
    """Bytes of each leaf's local shard under its spec (even shards)."""
    from repro_torch.runtime.sharding import P
    sizes = dict(zip(axes, mesh_shape))
    specs = pytree.tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for x, spec in zip(pytree.tree_leaves(tree), specs):
        n = x.numel()
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            n //= math.prod(sizes[a] for a in names if a is not None)
        total += n * x.element_size()
    return total


def test_cli_production_cell_and_inapplicable_cell(tmp_path):
    from repro_torch.configs.shapes import config_for_shape
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import init_params
    from repro_torch.runtime.analytics import cell_cost
    from repro_torch.runtime.sharding import (batch_specs, cache_specs,
                                              param_specs)
    dryrun.main(["--arch", "chatglm3-6b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(tmp_path)])
    dryrun.main(["--arch", "chatglm3-6b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    rec = json.loads(
        (tmp_path / "chatglm3-6b__decode_32k__single.json").read_text())
    assert rec["ok"] and set(rec) == RECORD_KEYS
    assert (rec["mesh"], rec["devices"]) == ("16x16", 256)
    assert set(rec["memory"]) == MEMORY_KEYS

    shape, axes = (16, 16), ("data", "model")
    mesh = AbstractMesh(shape, axes)
    cfg = config_for_shape(get_config("chatglm3-6b"), "decode_32k", 256)
    specs = input_specs(cfg, "decode_32k")
    params = init_params(cfg, device="meta")
    want = (_local_bytes(params, param_specs(params, cfg, mesh), shape, axes)
            + _local_bytes(specs["caches"],
                           cache_specs(specs["caches"], cfg, mesh),
                           shape, axes)
            + _local_bytes(specs["tokens"],
                           batch_specs(specs["tokens"], mesh), shape, axes)
            + 4)   # cache_len
    assert rec["memory"]["argument_bytes"] == want
    # Each model-axis device attends its rows over its own slots, so the
    # job's FLOPs are the cell's own, within the 20 % the reference holds
    # its own FLOP count to (tests/test_analytics.py).
    want = cell_cost(cfg, "decode_32k").flops
    assert rec["cost_analysis"]["flops"] == pytest.approx(want, rel=0.20)
    colls = rec["collectives"]
    counts = {}
    for op in colls["ops_summary"]:
        counts[op["kind"]] = counts.get(op["kind"], 0) + op["count"]
    debug = {k.split(".")[-1]: v
             for k, v in colls["comm_debug_counts"].items()}
    assert counts.get("all-gather", 0) == \
        debug.get("all_gather_into_tensor", 0)
    assert counts.get("all-reduce", 0) == debug.get("all_reduce", 0)
    # Flash-decoding: no device gathers the cache.  Every all-gather moves
    # less than one layer's local block of the k cache (B/16 rows, S/16
    # slots), and the attention all-reduces three tensors per layer.
    rows, slots = specs["caches"]["groups"][0]["k"].shape[1:3]
    block = (rows // 16) * (slots // 16) * cfg.num_kv_heads * \
        cfg.qk_head_dim * 2
    assert 0 < colls["largest_op_bytes_by_kind"]["all-gather"] < block
    assert counts["all-reduce"] >= 3 * cfg.num_layers
    assert dryrun.report(tmp_path) == {"records": 3, "ran": 1, "n/a": 2,
                                       "failed": 0, "above_80GiB": []}

    for mesh_name in ("single", "multi"):
        na = json.loads((tmp_path / f"chatglm3-6b__long_500k__{mesh_name}"
                         ".json").read_text())
        assert na["ok"] is False and na["skipped"] is True
        assert "full-attention" in na["reason"]


def test_failed_cell_is_recorded_with_its_error(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                 "--mesh", "multi", "--out", str(tmp_path)])
    rec = json.loads(
        (tmp_path / "mamba2-370m__decode_32k__multi.json").read_text())
    assert rec["ok"] is False and rec["mesh"] == "2x16x16"
    assert rec["error"] == "RuntimeError: no strategy"
    assert "Traceback" in rec["traceback"]


def test_ring_model_of_effective_bytes():
    ops = [{"kind": "all-reduce", "operand_bytes": 256, "group_size": 2,
            "multiplier": 1, "effective_bytes": int(2 * 256 * 1 / 2)},
           {"kind": "all-gather", "operand_bytes": 32, "group_size": 8,
            "multiplier": 1, "effective_bytes": int(32 * 8 * 7 / 8)}]
    out = dryrun._collective_totals(ops)
    assert out["per_device_bytes_by_kind"]["all-reduce"] == 256
    assert out["effective_bytes_by_kind"] == {"all-reduce": 256,
                                              "all-gather": 224}
    assert out["num_ops"] == 2
    assert out["ops_summary"] == [
        {"kind": "all-gather", "group_size": 8, "count": 1, "bytes": 32},
        {"kind": "all-reduce", "group_size": 2, "count": 1, "bytes": 256}]


def test_fake_group_is_torn_down():
    import torch.distributed as dist
    with dryrun.fake_group(8):
        assert dist.get_world_size() == 8
        with pytest.raises(RuntimeError, match="already"):
            with dryrun.fake_group(2):
                pass
    assert not dist.is_initialized()
