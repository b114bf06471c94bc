"""The port's kernel ops (daxpy, fused AdamW, the registry) against the
reference's.

The same numpy inputs, made from a seed, go through the reference's public
ops (``repro.kernels.ops.daxpy`` / ``adamw_update`` with
``interpret=True``, as tests/test_kernels.py runs the Pallas kernels on the
CPU) and through the port: its ``kernels.ops`` wrappers, which run each
kernel's plain version for CPU tensors, and the plain versions themselves.

Tolerances are tests/test_kernels.py's own:
  * daxpy output: f32 ``rtol=atol=1e-6``; bf16 ``rtol=atol=2e-2``;
  * AdamW p: the same per dtype; m and v: ``rtol=1e-5, atol=1e-7``.

The CUDA kernels are held against their plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.fused_adamw import pack_hparams as ref_pack_hparams
from repro_torch.kernels import fused_adamw as FA
from repro_torch.kernels import ops
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models.convert import params_from_numpy

# The package's ``daxpy`` is the exported function (as in the
# reference); the module holds the plain version.
DX = importlib.import_module("repro_torch.kernels.daxpy")

SHAPES = [(5,), (128,), (1000,), (8, 128), (3, 7, 11), (256, 256), (1, 1)]
DTYPES = ["f32", "bf16"]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
ADAMW_SHAPES = [(130,), (4, 128), (1000,), (16, 16, 16)]
HPS = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)


def tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else \
        dict(rtol=1e-6, atol=1e-6)


def _t(x):
    """A reference array (or numpy array) -> a CPU tensor, bit for bit."""
    return params_from_numpy(np.asarray(x), "cpu")


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


# --------------------------------------------------------------------------- #
# daxpy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_daxpy_matches_reference(shape, dt):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape), JDT[dt])
    y = jnp.asarray(rng.standard_normal(shape), JDT[dt])
    want = rops.daxpy(2.5, x, y, interpret=True)
    for got in (ops.daxpy(2.5, _t(x), _t(y)),
                DX.daxpy_plain(2.5, _t(x), _t(y))):
        assert tuple(got.shape) == shape and got.dtype == _t(want).dtype
        np.testing.assert_allclose(_np32(got), np.asarray(want, np.float32),
                                   **tol(dt))


@pytest.mark.parametrize("n,a", [(1, 0.0), (7, -3.25), (129, 9.5),
                                 (1000, -0.1), (4097, 7.75)])
def test_daxpy_any_length(n, a):
    x = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    y = jnp.linspace(3.0, -3.0, n, dtype=jnp.float32)
    want = rops.daxpy(a, x, y, interpret=True)
    got = ops.daxpy(a, _t(x), _t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_daxpy_rounds_a_to_x_dtype():
    x = torch.ones(4, dtype=torch.bfloat16)
    y = torch.zeros(4, dtype=torch.bfloat16)
    a = 1.0 + 2.0 ** -10                     # not a bf16 value: rounds to 1
    assert torch.equal(DX.daxpy_plain(a, x, y), x)


# --------------------------------------------------------------------------- #
# fused AdamW
# --------------------------------------------------------------------------- #
def _adamw_inputs(shape, dt, seed=1):
    rng = np.random.default_rng(seed)
    p = jnp.asarray(rng.standard_normal(shape), JDT[dt])
    g = jnp.asarray(rng.standard_normal(shape) * 0.1, JDT[dt])
    m = jnp.asarray(rng.standard_normal(shape) * 0.01, jnp.float32)
    v = jnp.asarray(np.abs(rng.standard_normal(shape)) * 0.001, jnp.float32)
    return p, g, m, v


@pytest.mark.parametrize("shape", ADAMW_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("step", [1, 100])
def test_adamw_matches_reference(shape, dt, step):
    p, g, m, v = _adamw_inputs(shape, dt)
    hp = ref_pack_hparams(**HPS, step=step)
    pr, mr, vr = rops.adamw_update(p, g, m, v, hp, interpret=True)
    # The plain version, functional.
    got_plain = FA.adamw_plain(_t(p), _t(g), _t(m), _t(v), _t(hp))
    # The ops wrapper, in place.
    pt, mt, vt = _t(p), _t(m), _t(v)
    got_ops = ops.adamw_update(pt, _t(g), mt, vt, _t(hp))
    assert got_ops[0] is pt and got_ops[1] is mt and got_ops[2] is vt
    for po, mo, vo in (got_plain, got_ops):
        assert po.dtype == _t(p).dtype and mo.dtype == torch.float32
        np.testing.assert_allclose(_np32(po), np.asarray(pr, np.float32),
                                   **tol(dt))
        np.testing.assert_allclose(mo.numpy(), np.asarray(mr), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(vo.numpy(), np.asarray(vr), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("step", [1, 7, 100])
def test_pack_hparams_matches_reference(step):
    got = FA.pack_hparams(**HPS, step=step, device="cpu")
    want = np.asarray(ref_pack_hparams(**HPS, step=step))
    assert got.shape == (1, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_adamw_multi_step_tracks_reference():
    """Ten chained updates, each from the previous step's outputs."""
    p, g0, m, v = _adamw_inputs((3, 130), "f32", seed=4)
    pt, mt, vt = _t(p), _t(m), _t(v)
    rng = np.random.default_rng(5)
    for step in range(1, 11):
        g = jnp.asarray(rng.standard_normal(p.shape) * 0.1, jnp.float32)
        hp = ref_pack_hparams(**HPS, step=step)
        p, m, v = rops.adamw_update(p, g, m, v, hp, interpret=True)
        ops.adamw_update(pt, _t(g), mt, vt, _t(hp))
    np.testing.assert_allclose(pt.numpy(), np.asarray(p), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mt.numpy(), np.asarray(m), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(vt.numpy(), np.asarray(v), rtol=1e-5,
                               atol=1e-7)


def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    before = (LAUNCHES["daxpy"], LAUNCHES["fused_adamw"])
    x = torch.randn(300)
    ops.daxpy(1.5, x, x)
    p = torch.randn(300)
    ops.adamw_update(p, torch.randn(300), torch.zeros(300), torch.zeros(300),
                     FA.pack_hparams(**HPS, step=1, device="cpu"))
    assert (LAUNCHES["daxpy"], LAUNCHES["fused_adamw"]) == before


def _fake_entry(monkeypatch, rc: int) -> list:
    """Route ``_build.launch`` to a fake C entry that returns ``rc``; the
    card's device guard and stream are faked too.  Returns the calls."""
    from contextlib import nullcontext
    from types import SimpleNamespace

    from repro_torch.kernels import _build
    calls = []
    monkeypatch.setattr(_build, "entry", lambda name, symbol, argtypes: (
        lambda *a: calls.append((name, symbol, a)) or rc))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=7))
    return calls


def test_a_failed_launch_raises_with_the_kernels_name_and_counts_nothing(
        monkeypatch):
    from repro_torch.kernels import _build
    calls = _fake_entry(monkeypatch, rc=700)
    monkeypatch.setitem(LAUNCHES, "daxpy", 5)
    with pytest.raises(RuntimeError, match="daxpy kernel daxpy_f32 failed: "
                                            "cudaError 700"):
        _build.launch("daxpy", "daxpy_f32", (), torch.device("cpu"), 1.0, 2,
                      count="daxpy")
    assert calls == [("daxpy", "daxpy_f32", (1.0, 2, 7))]
    assert LAUNCHES["daxpy"] == 5


def test_a_launch_counts_once_under_its_key(monkeypatch):
    from repro_torch.kernels import _build
    calls = _fake_entry(monkeypatch, rc=0)
    monkeypatch.setitem(LAUNCHES, "decode_attention_shard", 2)
    monkeypatch.setitem(LAUNCHES, "decode_attention", 3)
    dev = torch.device("cpu")
    _build.launch("decode_attention", "decode_attention_shard_sum", (), dev,
                  count=None)
    assert LAUNCHES["decode_attention_shard"] == 2
    _build.launch("decode_attention", "decode_attention_bf16_shard_pv", (),
                  dev, 4, count="decode_attention_shard")
    assert LAUNCHES["decode_attention_shard"] == 3
    assert LAUNCHES["decode_attention"] == 3
    assert [c[2] for c in calls] == [(7,), (4, 7)]


def test_value_errors():
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        ops.daxpy(1.0, x, torch.zeros(5))
    hp = FA.pack_hparams(**HPS, step=1, device="cpu")
    z = torch.zeros(4)
    with pytest.raises(ValueError):
        ops.adamw_update(z, z, z, torch.zeros(2, 2), hp)
    with pytest.raises(ValueError):
        ops.adamw_update(z, z, z, z, hp.reshape(8))
    with pytest.raises(ValueError):
        ops.adamw_update(z, z, z, z, torch.zeros(1, 7))


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
def test_kernel_registry_equals_reference():
    assert ops.kernel_names() == rops.kernel_names()
    for name in rops.kernel_names():
        assert dataclasses.asdict(ops.get_kernel(name)) == \
            dataclasses.asdict(rops.get_kernel(name)), name


@pytest.mark.parametrize("kw", [{}, dict(head_dim=128, num_heads=32,
                                         kv_heads=2, cache_len=160),
                                dict(quant=True, cache_len=64)])
def test_decode_attention_spec_equals_reference(kw):
    assert dataclasses.asdict(ops.decode_attention_spec(**kw)) == \
        dataclasses.asdict(rops.decode_attention_spec(**kw))


def test_registry_lookup_and_registration():
    with pytest.raises(KeyError):
        ops.get_kernel("no-such-kernel")
    spec = dataclasses.replace(ops.get_kernel("memcpy"), name="memcpy2")
    try:
        assert ops.register_kernel(spec) is spec
        assert "memcpy2" in ops.kernel_names()
        with pytest.raises(ValueError):
            ops.register_kernel(spec)
        ops.register_kernel(spec, overwrite=True)
    finally:
        ops.KERNELS.pop("memcpy2", None)
