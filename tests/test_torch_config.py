"""The port's configs, its reference-weight bridge, and its import hygiene.

  * every ``ARCH_IDS`` config, full and ``scaled_down``, equals the
    reference's on every field the reference has, and holds the port's
    own fields (granite-4.0-h's) at their neutral defaults;
  * the bridge (``repro_torch.models.convert``) carries f32 and bf16
    leaves across bit for bit and keeps the tree's nesting;
  * importing every ``repro_torch`` module loads neither ``jax`` nor
    ``repro`` (checked in a fresh process).
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.models import init_cache, init_params, scaled_down
from repro_torch.models.config import BLOCK_KINDS
from repro_torch.models.convert import caches_from_numpy, params_from_numpy


def test_arch_ids_match_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert set(all_configs()) == set(ARCH_IDS)


def _on_reference_fields(got, ref) -> dict:
    """``got``'s fields that the reference's config has; the port's own
    must hold their defaults."""
    mine = dataclasses.asdict(got)
    theirs = dataclasses.asdict(ref)
    own = {f.name: f.default for f in dataclasses.fields(got)
           if f.name not in theirs}
    assert {k: mine[k] for k in own} == own
    return {k: mine[k] for k in theirs}


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_asdict_equal_full_and_scaled_down(arch):
    ref, got = ref_get_config(arch), get_config(arch)
    assert _on_reference_fields(got, ref) == dataclasses.asdict(ref)
    small, ref_small = scaled_down(got), ref_scaled_down(ref)
    assert _on_reference_fields(small, ref_small) == \
        dataclasses.asdict(ref_small)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()


def test_config_validation_and_block_kinds_match_reference():
    from repro.models.config import BLOCK_KINDS as REF_KINDS
    assert BLOCK_KINDS[:len(REF_KINDS)] == REF_KINDS
    assert BLOCK_KINDS[len(REF_KINDS):] == ("mamba_moe", "mla", "mla_moe")
    cfg = get_config("chatglm3-6b")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, pattern=("nope",))
    assert cfg.param_count() == 6_243_454_976


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_bit_exact(dtype):
    """Reference params (f32 or bf16 leaves, f32 norms) cross leaf by leaf."""
    cfg = ref_scaled_down(ref_get_config("chatglm3-6b"), dtype=dtype)
    ref = jax.tree.map(np.asarray, ref_init_params(jax.random.key(0), cfg))
    got = params_from_numpy(ref, "cpu")
    ref_leaves, ref_def = jax.tree.flatten(ref)
    got_leaves, got_def = jax.tree.flatten(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert got_def == ref_def                    # same nesting
    assert isinstance(got["groups"], tuple)
    assert got["groups"][0]["attn"]["wq"].shape[0] == cfg.full_groups
    for a, t in zip(ref_leaves, got_leaves):
        assert t.shape == a.shape
        np.testing.assert_array_equal(_bits(t), _ref_bits(a))
    if dtype == "bfloat16":
        assert got["embed"].dtype == torch.bfloat16
        assert got["final_norm"].dtype == torch.float32


def test_bridge_caches_match_port_layout():
    cfg = ref_scaled_down(ref_get_config("gemma3-12b"), kv_quant=True)
    ref = jax.tree.map(np.asarray, ref_init_cache(cfg, 2, max_len=16))
    got = caches_from_numpy(ref, "cpu")
    mine = init_cache(scaled_down(get_config("gemma3-12b"), kv_quant=True),
                      2, 16, device="cpu")
    flat_got = jax.tree.flatten(got, is_leaf=torch.is_tensor)
    flat_mine = jax.tree.flatten(mine, is_leaf=torch.is_tensor)
    assert flat_got[1] == flat_mine[1]
    for a, b in zip(flat_got[0], flat_mine[0]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_port_params_have_reference_layout():
    """The port's own init draws a tree of the reference's shapes/dtypes."""
    for dtype in ("float32", "bfloat16"):
        rcfg = ref_scaled_down(ref_get_config("granite-3-8b"), dtype=dtype)
        ref = jax.eval_shape(lambda c=rcfg: ref_init_params(
            jax.random.key(0), c))
        got = init_params(scaled_down(get_config("granite-3-8b"),
                                      dtype=dtype), seed=0, device="cpu")
        r_leaves, r_def = jax.tree.flatten(ref)
        g_leaves, g_def = jax.tree.flatten(got, is_leaf=torch.is_tensor)
        assert g_def == r_def
        for r, g in zip(r_leaves, g_leaves):
            assert tuple(g.shape) == r.shape
            assert str(g.dtype).removeprefix("torch.") == str(r.dtype)
        # Same scales: std of each weight within 10% of the reference's.
        want = float(jnp.std(ref_init_params(jax.random.key(0), rcfg)[
            "groups"][0]["mlp"]["w_in"].astype(jnp.float32)))
        have = float(got["groups"][0]["mlp"]["w_in"].float().std())
        assert abs(have / want - 1) < 0.1


def test_init_is_seeded():
    cfg = scaled_down(get_config("chatglm3-6b"))
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


def test_import_loads_no_jax_and_no_reference(repo_root):
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = {"PYTHONPATH": str(repo_root / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_import_neither_jax_nor_reference(repo_root):
    """No ``import`` of jax or repro in the port or chip_smoke.py."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)
    files = sorted((repo_root / "src" / "repro_torch").rglob("*.py"))
    files.append(repo_root / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch.device import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        init_params(scaled_down(get_config("chatglm3-6b")))
    assert resolve_device("cpu").type == "cpu"
