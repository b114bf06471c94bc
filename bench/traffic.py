"""The one traffic generator: a mix file of parameters -> requests.

A mix (``bench/traffic/<name>.json``) gives the engine's ``slots``, the
``prompt_lens`` and ``gen_lens`` to draw from, the number of ``requests``
and their ``arrival`` (``"backlog"``: all queued when the window opens).
Requests come in rounds, each holding every (prompt, output) pair once in
a shuffled order.  The order is the mix's own, the same for every seed:
which requests a window reaches and which of them share a prefill depends
on it, and a seeded order moved the prefill-heavy cell's tokens per second
by 9 % between seeds where one seed's two runs agreed within 0.3 %.  The
seed draws the prompt tokens, and with them every served token.  Requests
carry no deadline.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARRIVALS = ("backlog",)


def load(name: str, root: Path = ROOT) -> dict:
    mix = json.loads((root / "bench" / "traffic" / f"{name}.json").read_text())
    if mix["arrival"] not in ARRIVALS:
        raise ValueError(f"unknown arrival {mix['arrival']!r}")
    return mix


def max_len(mix: dict) -> int:
    return max(mix["prompt_lens"]) + max(mix["gen_lens"])


def draw(mix: dict, seed: int, vocab: int) -> list[tuple[int, int, np.ndarray]]:
    """(prompt_len, gen_len, prompt tokens) of each request, in queue
    order."""
    shuffle = np.random.default_rng(np.random.SeedSequence([0x0DE5]))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7AFF1C]))
    pairs = [(p, g) for p in mix["prompt_lens"] for g in mix["gen_lens"]]
    order: list[int] = []
    while len(order) < mix["requests"]:
        order.extend(shuffle.permutation(len(pairs)).tolist())
    out = []
    for i in order[:mix["requests"]]:
        p, g = pairs[i]
        out.append((p, g, rng.integers(0, vocab, size=p, dtype=np.int32)))
    return out
