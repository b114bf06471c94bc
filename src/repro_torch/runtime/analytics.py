"""Analytic FLOP/byte accounting per (arch x shape) cell.

A copy of ``repro/runtime/analytics.py`` (it imports no JAX) over the
port's ``ModelConfig`` and ``SHAPES``.  The reference's words below about
XLA and HLO describe the reference; the port's dry run
(``repro_torch.launch.dryrun``) counts FLOPs with ``FlopCounterMode`` and
collectives with ``CommDebugMode`` instead.

Why analytic: XLA's ``cost_analysis`` counts a ``while`` body once regardless
of trip count, and this framework deliberately scans over layer groups (and
over KV/SSD chunks) to keep HLO small — so compiled cost numbers undercount
by the trip counts. The roofline's compute/memory magnitudes are therefore
derived analytically from the model configuration (exact: we own the model
code), and *validated* against ``cost_analysis`` on unrolled variants (see
tests/test_analytics.py and EXPERIMENTS.md §Dry-run methodology). Collective
bytes ARE taken from the compiled HLO (they appear at top level / in the
group-scan body, multiplied by the statically-known trip count — see
launch/dryrun.py).

All numbers are GLOBAL (whole job, all chips); the roofline divides by chips.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.shapes import SHAPES
from repro_torch.models import ModelConfig


@dataclass(frozen=True)
class CellCost:
    flops: float            # executed FLOPs (incl. remat recompute, padding)
    hbm_bytes: float        # HBM traffic (params, states, caches, acts)
    model_flops: float      # useful FLOPs: 6*N_active*D (train) / 2*N*D fwd
    param_bytes: float
    notes: str = ""


def _attn_flops(cfg: ModelConfig, tokens: int, ctx_len: float,
                kinds: dict[str, int], *, local_ctx: float | None = None,
                ) -> float:
    """Projection + score/PV FLOPs for all attention-bearing layers.

    ``local_ctx``: executed context for sliding-window layers (None => same
    as global, i.e. no chunk skipping)."""
    hd = cfg.qk_head_dim
    d = cfg.d_model
    proj = 2 * tokens * d * (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd) \
        + 2 * tokens * cfg.num_heads * hd * d
    total = 0.0
    for kind, n_layers in kinds.items():
        if kind in ("attn", "attn_moe", "shared_attn"):
            ctx = ctx_len
        elif kind == "local":
            ctx = local_ctx if local_ctx is not None else ctx_len
        else:
            continue
        sdp = 2 * 2 * tokens * ctx * cfg.num_heads * hd
        total += n_layers * (proj + sdp)
    return total


def _layer_census(cfg: ModelConfig) -> dict[str, int]:
    kinds: dict[str, int] = {}
    for k in cfg.pattern:
        kinds[k] = kinds.get(k, 0) + cfg.full_groups
    for k in cfg.tail:
        kinds[k] = kinds.get(k, 0) + 1
    return kinds


def _ffn_flops(cfg: ModelConfig, tokens: int, kinds: dict[str, int]) -> float:
    d, f = cfg.d_model, cfg.d_ff
    per_tok_dense = 2 * d * f * (3 if cfg.gated_mlp else 2)
    n_dense = sum(n for k, n in kinds.items()
                  if k in ("attn", "local", "shared_attn"))
    total = tokens * per_tok_dense * n_dense
    n_moe = kinds.get("attn_moe", 0)
    if n_moe:
        eff_k = cfg.num_experts_per_tok * cfg.capacity_factor  # padded slots
        per_tok_moe = 2 * d * cfg.num_experts  # router
        per_tok_moe += eff_k * 2 * d * f * (3 if cfg.gated_mlp else 2)
        total += tokens * per_tok_moe * n_moe
    return total


def _mamba_flops(cfg: ModelConfig, tokens: int, kinds: dict[str, int],
                 *, decode: bool) -> float:
    n_m = kinds.get("mamba", 0)
    if not n_m:
        return 0.0
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_num_heads
    q = 1 if decode else cfg.ssm_chunk
    proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d
    conv = 2 * cfg.conv_width * (di + 2 * n)
    ssd = 2 * (q * n + q * di + 2 * n * di)   # intra CB/Lx + state in/out
    return tokens * n_m * (proj + conv + ssd)


def _head_flops(cfg: ModelConfig, tokens: int) -> float:
    return 2 * tokens * cfg.d_model * cfg.vocab_size


def forward_flops(cfg: ModelConfig, batch: int, seq: int, *,
                  decode: bool = False, cache_len: int = 0,
                  block_skip: bool = False) -> float:
    """Executed forward FLOPs.

    ``block_skip=False`` (the baseline implementation) computes scores for
    every KV chunk and masks — executed attention context is the FULL
    sequence. ``block_skip=True`` models the §Perf optimization that skips
    fully-masked chunks (causal => ~S/2 average context; local => window).
    """
    tokens = batch * seq
    kinds = _layer_census(cfg)
    if decode:
        ctx = float(cache_len)
        local_ctx = float(min(cfg.sliding_window or cache_len, cache_len))
    elif block_skip:
        ctx = seq / 2.0  # causal average context after chunk skipping
        local_ctx = float(min(cfg.sliding_window or seq, seq))
    else:
        ctx = float(seq)  # masked but executed
        local_ctx = float(seq)
    return (_attn_flops(cfg, tokens, ctx, kinds, local_ctx=local_ctx)
            + _ffn_flops(cfg, tokens, kinds)
            + _mamba_flops(cfg, tokens, kinds, decode=decode)
            + _head_flops(cfg, tokens))


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    kinds = _layer_census(cfg)
    total = 0.0
    for k, n in kinds.items():
        if k in ("attn", "attn_moe", "shared_attn"):
            total += n * 2 * batch * seq * cfg.num_kv_heads * cfg.qk_head_dim * 2
        elif k == "local":
            w = min(cfg.sliding_window or seq, seq)
            total += n * 2 * batch * w * cfg.num_kv_heads * cfg.qk_head_dim * 2
        elif k == "mamba":
            h = cfg.ssm_num_heads
            total += n * batch * (h * (cfg.d_inner // h) * cfg.ssm_state * 4
                                  + (cfg.conv_width - 1)
                                  * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
    return total


def cell_cost(cfg: ModelConfig, shape_name: str, *,
              remat: bool = True, block_skip: bool = False,
              kv_cache_bytes_per_elem: int = 2) -> CellCost:
    spec = SHAPES[shape_name]
    b, s = spec["batch"], spec["seq"]
    p = cfg.param_count()
    p_active = cfg.active_param_count()
    pb = p * 2.0  # bf16

    if spec["kind"] == "train":
        fwd = forward_flops(cfg, b, s, block_skip=block_skip)
        mult = 4.0 if remat else 3.0   # fwd + 2x bwd (+1x remat recompute)
        flops = fwd * mult
        tokens = b * s
        model_flops = 6.0 * p_active * tokens
        # params: read fwd+bwd (+remat) at 2B; grad 2B w; opt m/v f32 r+w;
        # master-update write 2B; activations at group boundaries.
        hbm = p * ((3 if remat else 2) * 2 + 2 + 16 + 2)
        hbm += cfg.num_layers * tokens * cfg.d_model * 2 * 4  # saved acts
        return CellCost(flops, hbm, model_flops, pb)

    if spec["kind"] == "prefill":
        fwd = forward_flops(cfg, b, s, block_skip=block_skip)
        tokens = b * s
        model_flops = 2.0 * p_active * tokens
        hbm = pb + _cache_bytes(cfg, b, s) + \
            cfg.num_layers * tokens * cfg.d_model * 2 * 2
        return CellCost(fwd, hbm, model_flops, pb)

    # decode: one token against a cache of length s.
    fwd = forward_flops(cfg, b, 1, decode=True, cache_len=s)
    model_flops = 2.0 * p_active * b
    cache = _cache_bytes(cfg, b, s) * kv_cache_bytes_per_elem / 2
    hbm = pb + cache  # read params + read cache (+ small writes)
    return CellCost(fwd, hbm, model_flops, pb,
                    notes="decode is weight+cache bandwidth bound")
