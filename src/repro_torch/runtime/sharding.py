"""Sharding rules: parameter, optimizer, batch and cache partition specs.

The port of ``repro/runtime/sharding.py``.  The name-based rules are the
reference's, entry for entry; they produce the port's own
``PartitionSpec`` (a tuple whose entries are an axis name, a tuple of axis
names, or ``None``), so a spec tree compares with the reference's ``P``s.
``to_placements`` turns a spec into DTensor placements on a
``DeviceMesh`` and ``to_shardings`` distributes a tree of tensors by a
spec tree.

Layout (DESIGN.md §4):
  * tensor parallelism over the ``model`` axis: attention heads / FFN hidden /
    experts / vocab;
  * FSDP-style sharding of the other matrix dimension over the data axes
    (``data``, plus ``pod`` when multi-pod) — ZeRO-3 equivalent: DTensor
    gathers a weight where an op needs it whole;
  * small 1-D tensors (norms, SSM scalars) are replicated;
  * KV caches: batch over data, cache slots over model;
  * SSM states: batch over data, heads over model.

Rules are name-based over the tree paths; leaves under "groups" carry a
leading stacked-group axis (spec gets a None prepended).  The mesh is an
argument of every rule: the reference reads the kv-head divisibility rule
through a module global, the port passes the mesh down.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import ModelConfig, ShardCtx
from repro_torch.runtime.flags import baseline_mode


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None.

    A tuple subclass, so torch's pytree treats it as a leaf of a spec tree
    and ``tuple(spec)`` compares with the reference's ``P(...)``.
    """

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _key_names(path) -> list[str]:
    names = []
    for k in path:
        if hasattr(k, "key"):
            names.append(str(k.key))
        elif hasattr(k, "idx"):
            names.append(str(k.idx))
    return names


def axis_size(mesh, axis) -> int:
    """Devices along ``axis``: a name, a tuple of names, or None (1)."""
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _rule(names: list[str], leaf, cfg: ModelConfig, fsdp, tp, mesh) -> P:
    name = names[-1]
    d = {n: True for n in names}
    # 1-D / tiny tensors: replicate.
    if leaf.ndim <= 1 or name in ("a_log", "dt_bias", "d_skip", "w_norm",
                                  "norm1", "norm2", "final_norm"):
        return P()
    if name == "embed":
        # (V, d): vocab on model; d replicated — sharding d over data makes
        # the lookup/head products gather full activations (§Perf iter. 4).
        return P(tp, fsdp) if baseline_mode() else P(tp, None)
    if name == "lm_head":
        return P(fsdp, tp) if baseline_mode() else P(None, tp)
    if name == "w_router":
        return P()                             # (d, E): tiny — replicate
    if "moe" in d:
        if name in ("w_gate", "w_in"):
            return P(tp, fsdp, None)           # (E, d, f): experts on model
        if name == "w_out":
            return P(tp, None, fsdp)           # (E, f, d)
    if "mamba" in d:
        if name in ("w_z", "w_x"):
            return P(fsdp, tp)                 # (d, d_inner)
        if name in ("w_bc", "w_dt"):
            return P(fsdp, None)               # small projections
        if name == "w_conv":
            return P(None, None)               # (W, channels): tiny
        if name == "w_out":
            return P(tp, fsdp)                 # (di, d)
    if name in ("wq",):
        return P(fsdp, tp)                     # (d, H*hd): heads on model
    if name in ("wk", "wv"):
        # KV heads shard only when divisible by |model| (else replicate cols;
        # the grouped attention re-expands to the sharded H layout at use).
        div = cfg.num_kv_heads % axis_size(mesh, tp) == 0
        return P(fsdp, tp if div else None)
    if name == "wo":
        return P(tp, fsdp)                     # (H*hd, d)
    if name in ("w_in", "w_gate"):
        return P(fsdp, tp)                     # (d, f)
    if name == "w_out":
        return P(tp, fsdp)                     # (f, d)
    return P()


def _axes(mesh) -> tuple[tuple[str, ...] | str | None, str | None]:
    names = mesh.mesh_dim_names
    fsdp = tuple(n for n in names if n in ("pod", "data"))
    fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    tp = "model" if "model" in names else None
    return fsdp, tp


def param_specs(params_shape: Any, cfg: ModelConfig, mesh) -> Any:
    """PartitionSpec tree for a param(-shaped) tree."""
    fsdp, tp = _axes(mesh)

    def spec(path, leaf):
        names = _key_names(path)
        s = _rule(names, leaf, cfg, fsdp, tp, mesh)
        if names and names[0] == "groups":
            s = P(None, *s)                    # stacked-group leading axis
        return s

    return pytree.tree_map_with_path(spec, params_shape)


def opt_specs(param_spec_tree: Any) -> dict:
    """Optimizer state mirrors parameter sharding; step is replicated."""
    return {
        "m": param_spec_tree,
        "v": param_spec_tree,
        "step": P(),
    }


def _fsdp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in mesh.mesh_dim_names
                     if a in ("pod", "data"))


def data_spec_for(dim: int, mesh):
    """Data axes if the dim divides them, else replicate (e.g. batch=1)."""
    fsdp, _ = _axes(mesh)
    return fsdp if dim % _fsdp_size(mesh) == 0 else None


def batch_specs(batch_shape: Any, mesh) -> Any:
    """Token/embedding batches: batch dim over all data axes (if divisible)."""

    def spec(leaf):
        if leaf.ndim >= 1:
            return P(data_spec_for(leaf.shape[0], mesh),
                     *(None,) * (leaf.ndim - 1))
        return P()

    return pytree.tree_map(spec, batch_shape)


def cache_specs(cache_shape: Any, cfg: ModelConfig, mesh) -> Any:
    """Decode caches.

    Attention k/v: (groups?, B, slots, K, hd) — batch over data, slots over
    model. SSM state: (groups?, B, H, P, N) — batch over data, heads over
    model. Conv state: (groups?, B, W-1, C) — batch over data, channels
    replicated.
    """
    fsdp, tp = _axes(mesh)

    def spec(path, leaf):
        names = _key_names(path)
        stacked = bool(names) and names[0] == "groups"
        kind = names[-1]
        lead = (None,) if stacked else ()
        bdim = leaf.shape[1] if stacked else leaf.shape[0]
        dp = fsdp if bdim % _fsdp_size(mesh) == 0 else None
        if kind in ("k", "v", "k_scale", "v_scale"):
            s = (*lead, dp, tp, None, None)    # slots over model
        elif kind == "ssm":
            heads = leaf.shape[2] if stacked else leaf.shape[1]
            tp_ok = tp if heads % axis_size(mesh, tp) == 0 else None
            s = (*lead, dp, tp_ok, None, None)
        elif kind == "conv":
            s = (*lead, dp, None, None)
        else:
            s = (*lead,) + (None,) * (leaf.ndim - len(lead))
        return P(*s)

    return pytree.tree_map_with_path(spec, cache_shape)


def make_shard_ctx(mesh) -> ShardCtx:
    fsdp, tp = _axes(mesh)
    dp = fsdp if isinstance(fsdp, tuple) else ((fsdp,) if fsdp else ())
    return ShardCtx(dp=dp, tp=tp, active=True, mesh=mesh)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim, for a partition spec.

    Mesh dim ``n`` gets ``Shard(d)`` when the spec names it at tensor dim
    ``d`` and ``Replicate()`` otherwise.  A tuple entry shards one tensor
    dim over several mesh dims, major to minor; DTensor splits a dim
    sharded on several mesh dims in mesh order, which gives that layout
    when the tuple lists its axes in mesh order (every rule here does).
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    owner: dict[str, int] = {}
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        unknown = set(axes) - set(names)
        if unknown:
            raise ValueError(f"spec {spec!r} names axes {sorted(unknown)} "
                             f"that the mesh {names} lacks")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec!r} lists axes {axes} out of the "
                             f"mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec!r} uses axis {a!r} twice")
            owner[a] = dim
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in names)


def distribute(x: torch.Tensor, spec, mesh):
    """``x``, whole on every rank, as a DTensor placed by ``spec``.

    Every rank keeps its own shard of its own copy: nothing is sent.  On a
    mesh of one device the shard is ``x`` itself (``distribute_tensor``
    would copy it).
    """
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, mesh)
    if mesh.size() == 1:
        return DTensor.from_local(x, mesh, placements, run_check=False)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def to_shardings(tree: Any, spec_tree: Any, mesh) -> Any:
    """Distribute a tree of tensors onto ``mesh`` by a spec tree.

    The port's counterpart of the reference's ``to_shardings`` plus its
    ``device_put``: the spec tree's structure leads (its ``PartitionSpec``
    leaves match the tensor tree's leaves).  A leaf that is already a
    DTensor is taken as it is.
    """
    from torch.distributed.tensor import DTensor
    return pytree.tree_map(
        lambda s, x: x if isinstance(x, DTensor) else distribute(x, s, mesh),
        spec_tree, tree, is_leaf=_is_spec)
