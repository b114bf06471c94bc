"""Seeded weights, drawn on the device in the dtype they are served in.

The tree has the layout the program's ``ServingEngine(params=)`` takes: the
layers of the configuration's one-kind pattern stacked along a leading axis
under ``"groups"``, the embedding, the final norm and an untied LM head.
Each leaf is one ``normal_`` call of a device ``torch.Generator`` seeded
with ``--seed``: the same seed gives the same weights on the same card.
Scales follow the usual fan-in rule, norm scales (applied as ``1 + w``)
are drawn small, and the router is kept in float32.
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


def leaf_shapes(m: dict) -> dict:
    """(shape, std, dtype name) of every leaf of one stacked layer."""
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    h, kh, dt = m["num_heads"], m["num_kv_heads"], m["dtype"]
    attn = {"wq": ((d, h * hd), d ** -0.5, dt),
            "wk": ((d, kh * hd), d ** -0.5, dt),
            "wv": ((d, kh * hd), d ** -0.5, dt),
            "wo": ((h * hd, d), (h * hd) ** -0.5, dt)}
    out = {"norm1": ((d,), NORM_STD, "float32"),
           "norm2": ((d,), NORM_STD, "float32"), "attn": attn}
    if m.get("num_experts", 0):
        e = m["num_experts"]
        out["moe"] = {"w_router": ((d, e), d ** -0.5, "float32"),
                      "w_gate": ((e, d, f), d ** -0.5, dt),
                      "w_in": ((e, d, f), d ** -0.5, dt),
                      "w_out": ((e, f, d), f ** -0.5, dt)}
    else:
        out["mlp"] = {"w_in": ((d, f), d ** -0.5, dt),
                      "w_gate": ((d, f), d ** -0.5, dt),
                      "w_out": ((f, d), f ** -0.5, dt)}
    return out


def specs(m: dict) -> list[tuple[tuple, tuple, float, str]]:
    """(path, shape, std, dtype name) of every leaf, in drawing order."""
    if len(m.get("pattern", ["attn"])) != 1:
        raise ValueError("bench.weights handles one-kind patterns only")
    n, d, vp = m["num_layers"], m["d_model"], padded_vocab(m)
    out = [(("embed",), (vp, d), 0.02, m["dtype"])]

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out.append((path + (k,), (n, *v[0]), v[1], v[2]))

    walk(leaf_shapes(m), ("groups", 0))
    out.append((("final_norm",), (d,), NORM_STD, "float32"))
    out.append((("lm_head",), (d, vp), d ** -0.5, m["dtype"]))
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def fill(tree: dict, m: dict, seed: int) -> dict:
    """Draw every leaf of ``tree`` anew from ``seed``, in place: the same
    values ``draw(m, seed)`` gives."""
    dev = tree["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for path, _, std, _ in specs(m):
        _leaf(tree, path).normal_(0.0, std, generator=gen)
    return tree


def draw(m: dict, seed: int, device) -> dict:
    """The weight tree of configuration ``m`` from ``seed``."""
    tree = {"groups": ({},), "tail": ()}
    for path, shape, _, dt in specs(m):
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, dtype=DTYPES[dt], device=device)
    return fill(tree, m, seed)


def param_count(m: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in specs(m))
