"""The port's analysis layers against the reference: input shapes
(``configs/shapes.py``), the roofline planner (``core/planner.py``) and the
analytic cell costs (``runtime/analytics.py``).

  * ``SHAPES``, ``shape_applicable``, ``pick_moe_groups``,
    ``config_for_shape``, ``cell_table`` and ``input_specs`` give the
    reference's values, shapes and dtypes for every arch x shape (the
    port's specs are meta tensors, the reference's ShapeDtypeStructs);
  * ``cell_cost`` and ``forward_flops`` equal the reference's exactly (the
    same float arithmetic on the same config fields);
  * ``FlopCounterMode`` over the port's forward on the meta device agrees
    with ``forward_flops`` within the tolerances of
    ``tests/test_analytics.py`` (20 % dense, 30 % mamba: the analytic count
    is matmuls only);
  * ``roofline``, ``step_time``, ``choose_extent`` and ``mfu`` equal the
    reference's on a grid, for ``TPU_V5E`` and for the port's ``H100_SXM``.
"""

from __future__ import annotations

import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.core import planner as ref_planner
from repro.runtime import analytics as ref_analytics
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.configs import shapes
from repro_torch.core import planner
from repro_torch.models import ModelConfig, forward, init_params
from repro_torch.runtime import analytics

CELLS = [(a, s) for a in ARCH_IDS for s in shapes.SHAPE_NAMES]


def test_shape_table_is_the_reference():
    assert shapes.SHAPES == ref_shapes.SHAPES
    assert shapes.SHAPE_NAMES == ref_shapes.SHAPE_NAMES
    ref_cfgs = {a: ref_get_config(a) for a in ARCH_IDS}
    assert shapes.cell_table(all_configs()) == ref_shapes.cell_table(ref_cfgs)
    for arch in ARCH_IDS:
        cfg, ref = get_config(arch), ref_get_config(arch)
        for tokens in (1, 7, 128, 4096, 1 << 20):
            for parts in (1, 8, 256, 512):
                assert shapes.pick_moe_groups(cfg, tokens, parts) == \
                    ref_shapes.pick_moe_groups(ref, tokens, parts)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_cell_costs_match_reference(arch, shape):
    cfg, ref = get_config(arch), ref_get_config(arch)
    ok, why = shapes.shape_applicable(cfg, shape)
    assert (ok, why) == ref_shapes.shape_applicable(ref, shape)
    n = 256 if shape != "long_500k" else 512
    got_cfg = shapes.config_for_shape(cfg, shape, num_shards=n)
    want_cfg = ref_shapes.config_for_shape(ref, shape, num_shards=n)
    ref_fields = dataclasses.asdict(want_cfg)  # the port's own: defaults
    assert {k: v for k, v in dataclasses.asdict(got_cfg).items()
            if k in ref_fields} == ref_fields

    for kw in ({}, {"remat": False}, {"block_skip": True},
               {"kv_cache_bytes_per_elem": 1}):
        assert dataclasses.asdict(analytics.cell_cost(cfg, shape, **kw)) \
            == dataclasses.asdict(ref_analytics.cell_cost(ref, shape, **kw))
    spec = shapes.SHAPES[shape]
    for kw in ({}, {"decode": True, "cache_len": spec["seq"]},
               {"block_skip": True}):
        assert analytics.forward_flops(cfg, spec["batch"], 64, **kw) == \
            ref_analytics.forward_flops(ref, spec["batch"], 64, **kw)

    if not ok:
        with pytest.raises(ValueError) as exc:
            shapes.input_specs(cfg, shape)
        with pytest.raises(ValueError) as ref_exc:
            ref_shapes.input_specs(ref, shape)
        assert str(exc.value) == str(ref_exc.value)
        return
    got = shapes.input_specs(cfg, shape)
    want = ref_shapes.input_specs(ref, shape)
    tree = torch.utils._pytree
    got = {tree.keystr(p): x for p, x in tree.tree_flatten_with_path(got)[0]}
    want = {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(want[path].shape), path
        assert str(g.dtype).removeprefix("torch.") == str(want[path].dtype)


FLOP_CASES = [
    # (config, tolerance of tests/test_analytics.py)
    (ModelConfig(name="dense-v", family="dense", num_layers=4, d_model=128,
                 d_ff=512, vocab_size=512, num_heads=8, num_kv_heads=4,
                 head_dim=16, dtype="float32"), 0.20),
    (ModelConfig(name="m-v", family="ssm", num_layers=4, d_model=128,
                 d_ff=0, vocab_size=256, pattern=("mamba",), ssm_state=32,
                 ssm_head_dim=32, ssm_chunk=32, dtype="float32"), 0.30),
]


@pytest.mark.parametrize("cfg,rel", FLOP_CASES, ids=["dense", "mamba"])
def test_flop_counter_on_meta_matches_forward_flops(cfg, rel):
    from torch.utils.flop_counter import FlopCounterMode
    b, s = 2, 256
    params = init_params(cfg, device="meta")
    tokens = torch.zeros((b, s), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(params, cfg, tokens=tokens)
    got = counter.get_total_flops()
    want = analytics.forward_flops(cfg, b, s)
    assert got == pytest.approx(want, rel=rel), (got, want)


def _stats(mod, flops, hbm, host_in, coll):
    return mod.JobStats(name="job", flops=flops, hbm_bytes=hbm,
                        host_in_bytes=host_in,
                        coll_bytes=(lambda m: coll * (m - 1) / m)
                        if coll else None)


@pytest.mark.parametrize("chip", ["tpu", "h100"])
def test_planner_matches_reference_on_a_grid(chip):
    ref_chip = ref_planner.TPU_V5E
    got_chip = planner.TPU_V5E
    if chip == "h100":
        # The reference has no H100 spec: hand it the port's numbers.
        got_chip = planner.H100_SXM
        ref_chip = ref_planner.ChipSpec(**dataclasses.asdict(got_chip))
    else:
        assert dataclasses.asdict(got_chip) == dataclasses.asdict(ref_chip)
    ms = (1, 2, 4, 8, 16, 256)
    for flops in (0.0, 1e9, 3.5e12, 2.6e17):
        for hbm in (1e6, 1.3e10, 9e12):
            for host_in, coll in ((0.0, 0.0), (4e6, 1e9)):
                s = _stats(planner, flops, hbm, host_in, coll)
                r = _stats(ref_planner, flops, hbm, host_in, coll)
                for m in ms:
                    got = planner.roofline(s, m, got_chip)
                    want = ref_planner.roofline(r, m, ref_chip)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)
                    for kw in ({}, {"multicast": False}, {"overlap": False}):
                        assert planner.step_time(s, m, got_chip, **kw) == \
                            ref_planner.step_time(r, m, ref_chip, **kw)
                    if flops:
                        assert planner.mfu(s, m, 0.5, got_chip) == \
                            ref_planner.mfu(r, m, 0.5, ref_chip)
                for deadline in (None, 1e-4, 1e-2, 10.0):
                    assert planner.choose_extent(
                        s, ms, got_chip, deadline_s=deadline) == \
                        ref_planner.choose_extent(r, ms, ref_chip,
                                                  deadline_s=deadline)
    with pytest.raises(ValueError):
        planner.choose_extent(_stats(planner, 1, 1, 0, 0), [], got_chip)


def test_h100_spec_is_the_data_sheet():
    h = planner.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.hbm_bytes, h.tdp_w) == \
        (989.4e12, 3.35e12, 450e9, 80 * 2**30, 700.0)
    assert h.host_ingest_bw == 64e9
    assert 0 < h.step_launch_s < 1e-2 and 0 < h.per_device_dispatch_s < 1e-2
    # The TPU default is untouched.
    assert planner.ChipSpec() == planner.TPU_V5E
    assert planner.TPU_V5E.name == "tpu-v5e"
