"""Seeded weights, drawn on the device in the dtype they are served in.

The tree has the layout the program's ``ServingEngine(params=)`` takes:
under ``"groups"`` one entry per position of the configuration's pattern,
its layers stacked along a leading axis; under ``"tail"`` one unstacked
entry per layer left over; ``"shared"``, the one block that the pattern's
empty entries invoke; the embedding, the final norm, and an LM head unless
the embedding is tied.  The leaves of each block kind come from the
family's layout (``bench/layouts/<family>.py``).  Each leaf is one
``normal_`` call of a device ``torch.Generator`` seeded with ``--seed``:
the same seed gives the same weights on the same card.  Scales follow the
usual fan-in rule, norm scales (applied as ``1 + w``) are drawn small, and
the router is kept in float32.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
NORM_STD = 0.1


def padded_vocab(m: dict) -> int:
    q = m.get("vocab_pad_to", 1)
    return -(-m["vocab_size"] // q) * q


def stack(m: dict) -> tuple[list[str], int, list[str]]:
    """The pattern's kinds, its number of whole groups, the tail's kinds."""
    pattern = list(m.get("pattern", ["attn"]))
    groups, rest = divmod(m["num_layers"], len(pattern))
    return pattern, groups, pattern[:rest]


def specs(m: dict, layout) -> list[tuple[tuple, tuple, float, str]]:
    """(path, shape, std, dtype name) of every leaf, in drawing order:
    the embedding, the groups by position, the tail, the shared block, the
    final norm, the LM head."""
    d, vp = m["d_model"], padded_vocab(m)
    pattern, groups, tail = stack(m)
    out = [(("embed",), (vp, d), 0.02, m["dtype"])]

    def walk(tree, path, lead):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,), lead)
            else:
                out.append((path + (k,), (*lead, *v[0]), v[1], v[2]))

    blocks = [layout.block(m, kind) for kind in pattern]
    for i, tree in enumerate(blocks):
        walk(tree, ("groups", i), (groups,))
    for i, tree in enumerate(blocks[:len(tail)]):
        walk(tree, ("tail", i), ())
    if {} in blocks:
        walk(layout.block(m, layout.SHARED), ("shared",), ())
    out.append((("final_norm",), (d,), NORM_STD, "float32"))
    if not m.get("tie_embeddings", False):
        out.append((("lm_head",), (d, vp), d ** -0.5, m["dtype"]))
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def fill(tree: dict, m: dict, seed: int, layout) -> dict:
    """Draw every leaf of ``tree`` anew from ``seed``, in place: the same
    values ``draw(m, seed, device, layout)`` gives."""
    dev = tree["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for path, _, std, _ in specs(m, layout):
        _leaf(tree, path).normal_(0.0, std, generator=gen)
    return tree


def draw(m: dict, seed: int, device, layout) -> dict:
    """The weight tree of configuration ``m`` from ``seed``."""
    pattern, _, tail = stack(m)
    tree = {"groups": tuple({} for _ in pattern),
            "tail": tuple({} for _ in tail)}
    for path, shape, _, dt in specs(m, layout):
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, dtype=DTYPES[dt], device=device)
    return fill(tree, m, seed, layout)


def param_count(m: dict, layout) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in specs(m, layout))
