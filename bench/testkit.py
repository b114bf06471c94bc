"""Tiny cells for the harness's CPU tests: a checkout-like root in a
temporary directory, with a copy of ``bench/`` and a ``BENCHMARK.json`` of
its own, whose configurations are narrow versions of the two families."""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent

TINY = {
    "tiny-dense": {"name": "tiny-dense", "family": "dense", "num_layers": 2,
                   "d_model": 64, "d_ff": 128, "vocab_size": 128,
                   "vocab_pad_to": 1, "num_heads": 4, "num_kv_heads": 2,
                   "head_dim": 16, "rope_variant": "half",
                   "rope_theta": 10000.0, "pattern": ["attn"],
                   "norm_eps": 1e-5, "dtype": "float32"},
    "tiny-moe": {"name": "tiny-moe", "family": "moe", "num_layers": 2,
                 "d_model": 64, "d_ff": 32, "vocab_size": 120,
                 "vocab_pad_to": 16, "num_heads": 4, "num_kv_heads": 2,
                 "head_dim": 16, "rope_variant": "full",
                 "rope_theta": 1e6, "pattern": ["attn_moe"],
                 "num_experts": 8, "num_experts_per_tok": 2, "moe_groups": 1,
                 "capacity_factor": 1.25, "norm_eps": 1e-6,
                 "dtype": "float32"},
}
# The control's test: a vocabulary wide enough that float8 moves the best
# token at some position of every seed's sample.
TINY["tiny-dense-v1024"] = dict(TINY["tiny-dense"], name="tiny-dense-v1024",
                                vocab_size=1024)
# A mixed layer stack: two groups of (local, local, attn) and a tail of one
# local block; and the same with the embedding tied to the LM head.
TINY["tiny-mixed"] = dict(TINY["tiny-dense"], name="tiny-mixed", num_layers=7,
                          pattern=["local", "local", "attn"],
                          sliding_window=8)
TINY["tiny-mixed-tied"] = dict(TINY["tiny-mixed"], name="tiny-mixed-tied",
                               tie_embeddings=True)
MIX = {"why": "test", "slots": 2, "prompt_lens": [8, 16], "gen_lens": [4, 8],
       "requests": 400, "arrival": "backlog"}
LIMIT = 1e-3       # float32 program against the float32 reference: the
SHARE = 0.05       # widest gap, and the share of tokens off at near-ties
SECONDS = 3.0      # a tiny cell's window: tens of finished requests


def layout(m: dict):
    """The layout module of configuration ``m``'s family."""
    return importlib.import_module(f"bench.layouts.{m['family']}")


def make_root(tmp: Path, configs=("tiny-dense", "tiny-moe"), dtype=None,
              limit: float | None = LIMIT, requests: int | None = None
              ) -> Path:
    """A root holding ``bench/`` and a BENCHMARK.json with one cell per
    configuration, named after it."""
    shutil.copytree(BENCH, tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    (tmp / "bench" / "limits").mkdir(exist_ok=True)
    for name in configs:
        model = dict(TINY[name], **({"dtype": dtype} if dtype else {}))
        path = tmp / "bench" / "configs" / f"{name}.json"
        path.write_text(json.dumps({"name": name, "family": model["family"],
                                    "reduced": [], "model": model}))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"bench/configs/{name}.json",
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": "tiny", "chips": 1,
                                  "why": "test"})
        if limit is not None:
            (tmp / "bench" / "limits" / f"{name}.json").write_text(
                json.dumps({"logit_gap": {"limit": limit},
                            "mismatch_share": {"limit": SHARE}}))
    mix = dict(MIX, **({"requests": requests} if requests else {}))
    (tmp / "bench" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
