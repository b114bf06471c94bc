"""The prefill-attention kernel (``kernels/prefill_attention.py``), its
plain version and its route.

On the CPU:
  * the wrapper's plain path is ``models.layers.chunked_attention``, bit for
    bit, causal and windowed, GQA and not;
  * ``attention_block``'s prefill takes the kernel for what it takes (a
    CUDA tensor, bf16, a built head dim, one device) and the plain path for
    a CPU tensor, f32, an unbuilt head dim, the train step (no cache) and
    an active mesh: the card is faked and the kernel's entry counted;
  * the wrapper refuses what the kernel does not take.

On the card (skipped without one; no jax import, so the file runs there):
  * the kernel against the plain version at chatglm3-6b's (H 32, K 2) and
    qwen3-moe-30b-a3b's (H 32, K 4) heads, B = 4, L from 2 to 2048, with
    a sliding window, and at head dims 64 and 256, within chip_smoke.py's
    ``prefill_tolerance`` (its docstring gives the reason); and at
    kanana-2-30b-a3b's refills (multi-head latent attention: q and k 192
    wide, v 128, 32 heads each with its own key and value, B = 4, L to
    8192) with the (192, 128) instantiation;
  * a prefill launches the kernel once per layer (28 for chatglm3-6b's
    depth, 48 for qwen3-moe's and for kanana's MLA layers) and calls
    ``chunked_attention`` never; the
    train step's forward calls ``chunked_attention`` once per layer and
    launches nothing;
  * a captured call replayed twice gives the eager call's output, bit for
    bit.

    PYTHONPATH=src python -m pytest tests/test_torch_prefill_attention.py -m cuda
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.kanana_2_30b_a3b import CONFIG as KANANA
from repro_torch.kernels import prefill_attention as PA
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models import layers
from repro_torch.models.config import scaled_down
from repro_torch.models.model import forward, init_cache, init_params, prefill


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def _qkv(b, length, h, kh, d, dtype, device="cpu", seed=0, spread=2.0):
    """q, k, v drawn on the CPU (the same numbers on any device); q scaled
    by ``spread`` so the softmax is peaked as well as flat."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, length, h, d, generator=gen) * spread
    k = torch.randn(b, length, kh, d, generator=gen)
    v = torch.randn(b, length, kh, d, generator=gen)
    return tuple(t.to(dtype).to(device) for t in (q, k, v))


# --------------------------------------------------------------------------- #
# CPU: the plain path and the route
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,h,kh,d,window", [
    (2, 37, 4, 2, 16, 0), (1, 70, 4, 4, 8, 0), (2, 50, 6, 2, 16, 9),
    (1, 1100, 2, 1, 8, 0), (1, 1100, 4, 2, 8, 300)])
def test_plain_path_is_chunked_attention_bit_for_bit(b, length, h, kh, d,
                                                     window, dtype):
    assert layers.chunked_attention is PA.prefill_attention_plain
    q, k, v = _qkv(b, length, h, kh, d, dtype)
    got = PA.prefill_attention(q, k, v, window=window)
    want = layers.chunked_attention(q, k, v, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)


def _block_inputs(cfg, s, cache: bool):
    hd, dt = cfg.qk_head_dim, getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(1)

    def w(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).to(dt)

    p = {"wq": w(cfg.d_model, cfg.num_heads * hd),
         "wk": w(cfg.d_model, cfg.num_kv_heads * hd),
         "wv": w(cfg.d_model, cfg.num_kv_heads * hd),
         "wo": w(cfg.num_heads * hd, cfg.d_model)}
    x = w(2, s, cfg.d_model) * 10
    kv = (2, s, cfg.num_kv_heads, hd)
    c = ({"k": torch.zeros(kv, dtype=dt), "v": torch.zeros(kv, dtype=dt),
          "len": 0} if cache else None)
    return x, p, c


ROUTES = {"kernel": ("bfloat16", 64, True, True, 1),
          "cpu-tensor": ("bfloat16", 64, True, False, 0),
          "f32": ("float32", 64, True, True, 0),
          "unbuilt-head-dim": ("bfloat16", 96, True, True, 0),
          "train-step": ("bfloat16", 64, False, True, 0)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_prefill_route_takes_the_kernel_only_where_it_should(route,
                                                             monkeypatch):
    """The card is faked (``_on_card``) and the kernel's entry replaced by
    a counter that runs the plain version; ``chunked_attention`` counted."""
    dtype, hd, cache, on_card, want = ROUTES[route]
    if on_card:
        monkeypatch.setattr(PA, "_on_card", lambda t: True)
    entered, plain = [], []
    monkeypatch.setattr(layers, "prefill_attention", lambda q, k, v, window:
                        (entered.append(q.shape),
                         PA.prefill_attention_plain(q, k, v,
                                                    window=window))[1])
    attend = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention", lambda q, k, v, **kw:
                        (plain.append(q.shape), attend(q, k, v, **kw))[1])
    cfg = scaled_down(get_config("chatglm3-6b"), head_dim=hd, dtype=dtype)
    x, p, c = _block_inputs(cfg, 24, cache)
    pos = torch.arange(24)[None].expand(2, 24)
    y, new_cache = layers.attention_block(x, p, cfg, positions=pos, cache=c)
    assert len(entered) == want and len(plain) == 1 - want
    assert y.shape == x.shape and (new_cache is None) == (not cache)
    # The route changes nothing but the function that attends.
    monkeypatch.setattr(PA, "_on_card", lambda t: False)
    x, p, c = _block_inputs(cfg, 24, cache)
    y_plain, _ = layers.attention_block(x, p, cfg, positions=pos, cache=c)
    assert torch.equal(y, y_plain)


def test_prefill_route_keeps_a_mesh_on_the_plain_path(monkeypatch):
    monkeypatch.setattr(PA, "_on_card", lambda t: True)
    q, k, v = _qkv(1, 8, 4, 2, 128, torch.bfloat16)
    assert layers._prefill_kernel(q, k, v, layers.NO_SHARD)
    assert not layers._prefill_kernel(q, k, v,
                                      layers.ShardCtx(tp="model",
                                                      active=True))


@pytest.mark.parametrize("change,error", [
    (lambda q, k, v: (q.float(), k.float(), v.float()), TypeError),
    (lambda q, k, v: (q, k.float(), v), TypeError),
    (lambda q, k, v: (q[..., :96], k[..., :96], v[..., :96]), ValueError),
    (lambda q, k, v: (q[:, :, :3], k, v), ValueError),
    (lambda q, k, v: (q, k[:, :5], v[:, :5]), ValueError),
    (lambda q, k, v: (q, k, v[..., :64]), ValueError)],
    ids=["f32", "mixed-dtypes", "head-dim-96", "heads-not-a-multiple",
         "kv-length", "v-shape"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    q, k, v = change(*_qkv(1, 8, 4, 2, 128, torch.bfloat16))
    with pytest.raises(error):
        PA._check(q, k, v, 0)
    PA._check(*_qkv(1, 8, 4, 2, 128, torch.bfloat16), 0)
    with pytest.raises(ValueError):
        PA._check(*_qkv(1, 8, 4, 2, 128, torch.bfloat16), -1)


# --------------------------------------------------------------------------- #
# Card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


PREFILL_CASES = [(4, length, 32, kh, 128, 0) for kh in (2, 4)
                 for length in (2, 17, 100, 512, 1536, 2048)]
PREFILL_CASES += [(4, 2048, 32, 4, 128, 1024), (2, 700, 16, 2, 128, 100),
                  (3, 333, 8, 1, 64, 0), (2, 260, 8, 2, 64, 64),
                  (2, 300, 4, 4, 256, 0), (1, 200, 8, 2, 256, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,h,kh,d,window", PREFILL_CASES,
                         ids=[f"B{c[0]}-L{c[1]}-H{c[2]}-K{c[3]}-D{c[4]}-w{c[5]}"
                              for c in PREFILL_CASES])
def test_kernel_matches_plain_version(card, b, length, h, kh, d, window):
    """Within chip_smoke.py's ``prefill_tolerance``: p rounds to bf16
    under a running max of another tile width (64 keys, not 1024)."""
    before = LAUNCHES["prefill_attention"]
    res = SMOKE.check_prefill(("case", b, length, h, kh, d, window), card,
                              seed=length)
    assert LAUNCHES["prefill_attention"] == before + 1 and res["share_of_tolerance"] <= 1


MLA_CASES = [(2, 17), (2, 300), (4, 2048), (4, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,length", MLA_CASES,
                         ids=[f"B{b}-L{n}" for b, n in MLA_CASES])
def test_kernel_matches_plain_version_at_mla_widths(card, b, length):
    """q and k 192 wide, v 128, K = H = 32: the (192, 128) instantiation,
    within the same tolerance, one launch."""
    before = LAUNCHES["prefill_attention"]
    res = SMOKE.check_prefill(("mla", b, length, 32, 32, 192, 0, 128), card,
                              seed=length)
    assert LAUNCHES["prefill_attention"] == before + 1
    assert res["share_of_tolerance"] <= 1


ARCHS = {"chatglm3-6b": 28, "qwen3-moe-30b-a3b": 48}


@pytest.mark.cuda
def test_an_mla_prefill_launches_the_kernel_once_per_layer(card,
                                                           monkeypatch):
    """kanana-2-30b-a3b's 48 MLA layers at their published head widths in
    a narrow model: one launch a layer, ``chunked_attention`` never."""
    cfg = dataclasses.replace(KANANA, d_model=256, d_ff=64, dense_d_ff=128,
                              num_experts=8, shared_expert_ff=64,
                              vocab_size=512, vocab_pad_to=1)
    params = init_params(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (4, 300), device=card)
    plain = []
    attend = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention", lambda q, k, v, **kw:
                        (plain.append(q.shape), attend(q, k, v, **kw))[1])
    before = LAUNCHES["prefill_attention"]
    logits, _ = prefill(params, cfg, caches=init_cache(cfg, 4, 320,
                                                       device=card),
                        tokens=tokens)
    torch.cuda.synchronize()
    assert LAUNCHES["prefill_attention"] - before == 48 and plain == []
    assert bool(torch.isfinite(logits.float()).all())


def _narrow(arch):
    """The arch's depth, heads and head dim, in bf16, narrow elsewhere."""
    cfg = get_config(arch)
    return scaled_down(cfg, num_layers=cfg.num_layers,
                       num_heads=cfg.num_heads,
                       num_kv_heads=cfg.num_kv_heads,
                       head_dim=cfg.head_dim, d_model=256, dtype="bfloat16",
                       max_seq_len=4096)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_prefill_launches_the_kernel_once_per_layer(card, arch,
                                                      monkeypatch):
    cfg = _narrow(arch)
    assert cfg.num_layers == ARCHS[arch]
    params = init_params(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (4, 300), device=card)
    plain = []
    attend = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention", lambda q, k, v, **kw:
                        (plain.append(q.shape), attend(q, k, v, **kw))[1])
    before = LAUNCHES["prefill_attention"]
    caches = init_cache(cfg, 4, 320, device=card)
    logits, _ = prefill(params, cfg, caches=caches, tokens=tokens)
    torch.cuda.synchronize()
    assert LAUNCHES["prefill_attention"] - before == cfg.num_layers and plain == []
    assert bool(torch.isfinite(logits.float()).all())
    # The train step's forward (no cache) keeps the plain version.
    before = LAUNCHES["prefill_attention"]
    forward(params, cfg, tokens=tokens)
    torch.cuda.synchronize()
    assert LAUNCHES["prefill_attention"] == before and len(plain) == cfg.num_layers


@pytest.mark.cuda
def test_captured_prefill_attention_replays_are_bit_equal(card):
    q, k, v = _qkv(4, 1536, 32, 2, 128, torch.bfloat16, card)
    eager = PA.prefill_attention(q, k, v)       # sets the shared-memory size
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["prefill_attention"]
    with torch.cuda.graph(graph):
        out = PA.prefill_attention(q, k, v)
    assert LAUNCHES["prefill_attention"] == before + 1
    outs = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], eager)


def test_narrow_configs_keep_the_archs_attention():
    """The card tests' narrow configs keep what the route reads."""
    for arch, depth in ARCHS.items():
        cfg, full = _narrow(arch), get_config(arch)
        assert cfg.num_layers == depth
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
            full.num_heads, full.num_kv_heads, full.head_dim)
        assert cfg.head_dim in PA.HEAD_DIMS and cfg.dtype == "bfloat16"
