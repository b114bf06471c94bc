"""The port's fused decode-attention step against the reference kernel.

The same numpy inputs, made from a seed, go through the reference Pallas
kernel (``repro.kernels.decode_attention.fused_decode_attention`` in
interpret mode, as its own tests run it off-TPU) and the port's plain
version (``repro_torch.kernels.decode_attention``), which is what the
port's wrapper runs for CPU tensors.

Numerics contract (the reference's own, from tests/test_pallas_decode.py):
  * v-cache: bit-exact (a pure copy; for int8 caches the v codes and
    scales involve no rope, so they are exact too);
  * f32 k-cache and attention out: ``rtol=3e-6, atol=1e-6`` — XLA may
    contract the rope's ``x1*cos - x2*sin`` into an FMA, PyTorch's eager
    ops round each product, and the two sum the score/p@V dots in
    different orders;
  * bf16 k-cache and out: within one bf16 ULP (the same f32 differences,
    then one rounding to bf16);
  * int8 k codes: at most one step apart (a roped value on a rounding
    boundary may flip); with int8 caches the out tolerance's ``atol``
    scales with the largest dequantised value.

The last test holds the CUDA kernel against the plain version on the card
and is skipped where there is none.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.decode_attention import (
    fused_decode_attention as ref_fused)
from repro.models import layers as RL
from repro.models.config import ModelConfig as RefModelConfig
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import caches_from_numpy

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}

# (name, arch, B, S, H, K, D, dtype, lens, quant, is_ring, window): the six
# EXACT_CASES of tests/test_pallas_decode.py (mixed per-slot lens).
CASES = [
    ("plain-half-rope", "chatglm3-6b", 3, 64, 8, 2, 16, "f32",
     [5, 0, 63], False, False, 0),
    ("plain-std-rope-bf16", "granite-3-8b", 2, 32, 4, 4, 8, "bf16",
     [7, 31], False, False, 0),
    ("quant", "chatglm3-6b", 3, 64, 8, 2, 16, "f32",
     [5, 0, 63], True, False, 0),
    ("ring", "chatglm3-6b", 3, 32, 8, 2, 16, "f32",
     [100, 3, 32], False, True, 32),
    ("window-nonring", "granite-3-8b", 2, 64, 4, 4, 8, "f32",
     [40, 10], False, False, 16),
    ("quant-ring", "chatglm3-6b", 2, 32, 4, 2, 16, "f32",
     [70, 1], True, True, 32),
]
MULTI_CHUNK = ("multi-chunk", "chatglm3-6b", 4, 128, 8, 2, 32, "f32",
               [0, 17, 65, 127], False, False, 0)


def _to_torch(tree):
    return caches_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


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
    return x


def _run_both(case, seed=0):
    """(reference outputs, port outputs) as torch trees on the CPU."""
    *_, quant, is_ring, window = case
    x = _inputs(case, seed)
    args = [x[n] for n in ("q", "k", "v", "kc", "vc", "idx", "cos", "sin",
                           "ks", "vs")]
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    ref = ref_fused(*args, interpret=True, **kw)
    got = DA.decode_attention_plain(*_to_torch(args), **kw)
    names = ("out", "kc", "vc", "ks", "vs") if quant else ("out", "kc", "vc")
    return dict(zip(names, _to_torch(tuple(ref)))), dict(zip(names, got))


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ULPs between two bf16 tensors."""
    def key(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


def _assert_contract(ref, got, name=""):
    assert torch.equal(got["vc"], ref["vc"]), f"{name}: v-cache not exact"
    atol = 1e-6
    if "vs" in ref:
        assert torch.equal(got["vs"], ref["vs"]), f"{name}: v-scale"
        torch.testing.assert_close(got["ks"], ref["ks"], rtol=3e-6, atol=0)
        diff = (got["kc"].int() - ref["kc"].int()).abs()
        assert int(diff.max()) <= 1, f"{name}: int8 k codes"
        keys = ("out",)
        # Dequantised values reach +-12.7 here, not O(1): the absolute
        # slack of a few f32 ULP scales with them.
        atol *= float((got["vc"].float() * got["vs"]).abs().max())
    else:
        keys = ("out", "kc")
    for nm in keys:
        g, r = got[nm], ref[nm]
        assert g.dtype == r.dtype and g.shape == r.shape, nm
        if g.dtype == torch.bfloat16:
            assert _bf16_ulps(g, r) <= 1, f"{name}/{nm}"
        else:
            torch.testing.assert_close(g, r, rtol=3e-6, atol=atol,
                                       msg=f"{name}/{nm}")


@pytest.mark.parametrize("case", CASES + [MULTI_CHUNK],
                         ids=[c[0] for c in CASES + [MULTI_CHUNK]])
def test_plain_version_matches_reference_kernel(case):
    ref, got = _run_both(case)
    _assert_contract(ref, got, case[0])


@pytest.mark.parametrize("seed", range(5))
def test_plain_version_property_sweep(seed):
    """Seeded random (B, G, D) and per-slot lens on a multi-chunk cache."""
    rng = np.random.default_rng(1000 + seed)
    b, g, d = int(rng.integers(1, 4)), int(rng.integers(1, 5)), \
        int(rng.choice([8, 16]))
    kh, s = 2, 128
    lens = rng.integers(0, s, size=b).tolist()
    case = ("sweep", "granite-3-8b", b, s, kh * g, kh, d, "f32", lens,
            False, False, 0)
    ref, got = _run_both(case, seed=seed)
    _assert_contract(ref, got, f"B={b} G={g} D={d}")


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    case = CASES[0]
    x = _to_torch([_inputs(case)[n] for n in
                   ("q", "k", "v", "kc", "vc", "idx", "cos", "sin")])
    before = LAUNCHES["decode_attention"]
    out, kc, vc = DA.fused_decode_attention(*x)
    assert LAUNCHES["decode_attention"] == before
    assert kc is x[3] and vc is x[4]        # caches updated in place
    assert out.shape == x[0].shape and torch.isfinite(out).all()


def test_pick_chunk_matches_reference():
    from repro.kernels.decode_attention import pick_chunk as ref_pick
    for slots in (512, 160, 64, 48, 7, 1):
        assert DA.pick_chunk(slots) == ref_pick(slots)


# --------------------------------------------------------------------------- #
# Block level: attention_block(fused=True) vs fused=False, and vs reference
# --------------------------------------------------------------------------- #
def _tiny(cls, h, kh, d, **kw):
    return cls(name="tiny", family="dense", num_layers=1, d_model=h * d,
               d_ff=4 * h * d, vocab_size=64, num_heads=h, num_kv_heads=kh,
               head_dim=d, rope_variant="half", **kw)


@pytest.mark.parametrize("quant,window,slots", [
    (False, 0, 32),       # plain causal
    (False, 32, 32),      # ring buffer (slots == window)
    (True, 0, 32),        # int8 KV quant
], ids=["plain", "ring", "quant"])
def test_attention_block_fused_flag_equivalence(quant, window, slots):
    h, kh, d, b = 4, 2, 16, 3
    rcfg = _tiny(RefModelConfig, h, kh, d, sliding_window=window)
    cfg = _tiny(ModelConfig, h, kh, d, sliding_window=window)
    ref_fields = dataclasses.asdict(rcfg)      # the port's own: defaults
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in ref_fields} == ref_fields
    dm = cfg.d_model
    rng = np.random.default_rng(3)
    p = {n: jnp.asarray(rng.standard_normal(shape) * 0.1, jnp.float32)
         for n, shape in (("wq", (dm, h * d)), ("wk", (dm, kh * d)),
                          ("wv", (dm, kh * d)), ("wo", (h * d, dm)))}
    x = jnp.asarray(rng.standard_normal((b, 1, dm)), jnp.float32)
    idx = jnp.asarray([1, 7, slots - 1], jnp.int32)
    base = rng.standard_normal((b, slots, kh, d))
    cdt = jnp.int8 if quant else jnp.float32
    cache = {"k": jnp.asarray(base).astype(cdt),
             "v": jnp.asarray(base).astype(cdt), "len": idx}
    if quant:
        cache["k_scale"] = jnp.full((b, slots, kh, 1), 0.02, jnp.float32)
        cache["v_scale"] = jnp.full((b, slots, kh, 1), 0.02, jnp.float32)
    y_ref, c_ref = RL.attention_block(x, p, rcfg, RL.NO_SHARD,
                                      positions=idx[:, None], window=window,
                                      cache=cache)
    y_ref, c_ref = _to_torch((y_ref, c_ref))

    def port(fused):
        tp, tx, tc = _to_torch((p, x, cache))
        y, c = TL.attention_block(tx, tp, cfg, positions=tc["len"][:, None],
                                  window=window, cache=tc, fused=fused)
        return y, c

    (y_u, c_u), (y_f, c_f) = port(False), port(True)
    for y in (y_u, y_f):
        torch.testing.assert_close(y, y_ref, rtol=3e-6, atol=1e-6)
    assert torch.equal(c_f["len"], c_u["len"])
    assert torch.equal(c_f["len"], c_ref["len"])
    for nm in c_ref:
        if nm == "len":
            continue
        for c in (c_u, c_f):
            got, ref = c[nm], c_ref[nm]
            if got.dtype == torch.int8:
                diff = (got.int() - ref.int()).abs()
                assert int(diff.max()) <= 1 and \
                    float((diff != 0).float().mean()) < 0.01, nm
            else:
                torch.testing.assert_close(got, ref, rtol=3e-6, atol=1e-6,
                                           msg=nm)


# --------------------------------------------------------------------------- #
# On the card: the CUDA kernel against the plain version (chip_smoke.py's
# checks: caches bit-exact, out within the tolerances stated in PERF.md)
# --------------------------------------------------------------------------- #
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
GPU_CASES = SMOKE.CASES + [SMOKE.FULL_CASE]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = LAUNCHES["decode_attention"]
    SMOKE.check_case(case, 0, torch.device("cuda", 0))
    assert LAUNCHES["decode_attention"] == before + 1
