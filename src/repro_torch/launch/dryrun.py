"""Multi-pod dry run: run every (arch x shape x mesh) cell's step once on a
fake process group, with fake tensors, and record what each device would
hold, compute and send.

The port of ``repro/launch/dryrun.py``.  For each cell:
  * a fake process group of 256 (16x16) or 512 (2x16x16) ranks and the
    production ``DeviceMesh`` over it (``launch.mesh``);
  * ``config_for_shape`` and ``input_specs`` (meta tensors), and the step
    from ``launch.steps.bundle_for`` with its spec trees;
  * under ``FakeTensorMode`` — no storage anywhere — each argument becomes
    a DTensor placed by the bundle's specs, and the step runs once, as rank
    0 of the mesh, through DTensor's sharding propagation and the fake
    group's collectives.

What is recorded, under the reference's keys:
  * ``memory``: per-device bytes.  ``argument_bytes`` are the local shards
    of the step's arguments (params, optimizer state, batch, caches);
    ``output_bytes`` the local shards of its results that are not its
    arguments (caches are updated in place: ``alias_bytes``);
    ``temp_bytes`` the peak, over the step, of the local storage of every
    tensor an op made that is still alive (a census of storages, freed when
    the last tensor on one dies; views share their base's storage);
    ``peak_bytes`` = arguments + that peak.  No fusion or allocator
    rounding is modelled.
  * ``cost_analysis``: ``flops_per_device`` counts, with
    ``FlopCounterMode``'s per-op formulas
    (``torch.utils.flop_counter.flop_registry``), every op this device runs
    on its local shards, forward and backward; ``flops`` is that times the
    device count: the job's executed FLOPs, work that several devices
    repeat (attention replicated over the model axis, say) counted on each.
    ``bytes_accessed`` sums the local operands and results of every op (no
    fusion: an upper bound).
  * ``collectives``: every functional collective the step issues, with its
    kind, per-device operand bytes and group size, and the reference's
    ring model of effective bytes (all-reduce 2x its operand, all-gather
    its result, the others their operand, times (g-1)/g), and the largest
    single operand of each kind.  Eager PyTorch runs each layer's ops, so
    there are no loop trip counts to recover.
  * ``lower_s``: building the step and placing its fake arguments;
    ``compile_s``: running it (PyTorch compiles nothing here).

The reference's ``_shape_bytes`` and ``parse_collectives`` read XLA's HLO
text and have no counterpart: the census above takes their place.

Usage:
  python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape decode_32k \\
      --mesh single --out /tmp/dry
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
  python -m repro_torch.launch.dryrun --report results/dryrun

``--report`` reads the records in a directory and prints how many cells
ran, were n/a or failed, and which ran above the card's 80 GiB per device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (SHAPE_NAMES, config_for_shape,
                                        input_specs, shape_applicable)
from repro_torch.launch.mesh import make_mesh

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "broadcast": "collective-permute", "broadcast_": "collective-permute"}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


_PROPAGATION = frozenset({"gen_fake_args", "_propagate_tensor_meta",
                          "_propagate_tensor_meta_non_cached"})


def _in_sharding_propagation() -> bool:
    """Whether DTensor is running an op on global-shape stand-ins to learn
    its output's shape (``ShardingPropagator``), not on a device's shards."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name in _PROPAGATION:
            return True
        frame = frame.f_back
    return False


class _Census(TorchDispatchMode):
    """Live local storage, bytes touched, local FLOPs and collectives.

    A DTensor op is handed on (``NotImplemented``, as ``CommDebugMode``
    does), so the census sees the local ops and collectives DTensor runs
    on this device's shards.
    """

    def __init__(self):
        super().__init__()
        self.live: dict[int, list[int]] = {}     # storage -> [bytes, refs]
        self.held: set[int] = set()              # the arguments' storages
        self.temp = self.temp_peak = 0
        self.bytes_accessed = 0
        self.flops = 0
        self.ops: list[dict] = []

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def hold(self, tree) -> None:
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self.held.add(self._key(_local(t)))

    def _track(self, t: torch.Tensor) -> None:
        key = self._key(t)
        if key in self.held:
            return
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.temp += entry[0]
            self.temp_peak = max(self.temp_peak, self.temp)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.temp -= entry[0]
            del self.live[key]

    def _collective(self, func, args, out) -> None:
        name = func._opname
        kind = _KIND.get(name)
        if kind is None:
            return
        operand = _nbytes(args[0])
        group = args[-1]
        g = _group_size(group) if isinstance(group, str) else 1
        if kind == "all-reduce":
            eff = 2 * operand
        elif kind == "all-gather":
            eff = operand * g
        else:
            eff = operand
        self.ops.append({"kind": kind, "computation": str(func),
                         "operand_bytes": operand, "group_size": g,
                         "multiplier": 1,
                         "effective_bytes": int(eff * max(g - 1, 0)
                                                / max(g, 1))})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if _in_sharding_propagation():
            return out   # stand-ins at global shape, not a device's data
        if func.namespace == "_c10d_functional":
            self._collective(func, args, out)
        elif func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for o in outs:
            self._track(o)
        return out


def _summarize(ops):
    agg = {}
    for o in ops:
        key = (o["kind"], o["group_size"])
        a = agg.setdefault(key, {"count": 0, "bytes": 0})
        a["count"] += 1
        a["bytes"] += o["operand_bytes"] * o["multiplier"]
    return [{"kind": k, "group_size": g, **v}
            for (k, g), v in sorted(agg.items())]


def _collective_totals(ops) -> dict:
    totals = {k: 0.0 for k in COLLECTIVES}
    eff: dict[str, float] = {}
    largest: dict[str, int] = {}
    for o in ops:
        totals[o["kind"]] += o["operand_bytes"] * o["multiplier"]
        eff[o["kind"]] = eff.get(o["kind"], 0) \
            + o["effective_bytes"] * o["multiplier"]
        largest[o["kind"]] = max(largest.get(o["kind"], 0),
                                 o["operand_bytes"])
    return {"per_device_bytes_by_kind": totals,
            "per_device_bytes_total": sum(totals.values()),
            "effective_bytes_by_kind": eff,
            "effective_bytes_total": sum(eff.values()),
            "largest_op_bytes_by_kind": largest,
            "num_ops": len(ops), "ops_summary": _summarize(ops)}


def _fake_args(bundle, mesh):
    """The bundle's meta arguments as fake CPU tensors placed by its specs."""
    from repro_torch.runtime.sharding import P, to_shardings

    def fake(m):
        return torch.zeros(m.shape, dtype=m.dtype, device="cpu")

    args = []
    for arg, spec in zip(bundle.abstract_args, bundle.in_shardings):
        arg = pytree.tree_map(fake, arg)
        if isinstance(spec, P) and not isinstance(arg, torch.Tensor):
            raise TypeError("a spec leaf must face a tensor")
        args.append(to_shardings(arg, spec, mesh))
    return args


def run_bundle(bundle, mesh) -> dict:
    """Run ``bundle.fn`` once on fake arguments placed over ``mesh``; the
    record's ``memory``, ``cost_analysis`` and ``collectives`` entries."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode

    t0 = time.time()
    with FakeTensorMode():
        args = _fake_args(bundle, mesh)
        arg_bytes = sum(_nbytes(_local(t)) for t in pytree.tree_leaves(args)
                        if isinstance(t, torch.Tensor))
        t_lower = time.time() - t0
        census = _Census()
        census.hold(args)
        with CommDebugMode() as comm, census:
            out = bundle.fn(*args)
        t_run = time.time() - t0 - t_lower
        arg_keys = {census._key(_local(t)) for t in pytree.tree_leaves(args)
                    if isinstance(t, torch.Tensor)}
        outs = [_local(t) for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        alias = sum(_nbytes(t) for t in outs if census._key(t) in arg_keys)
        out_bytes = sum(_nbytes(t) for t in outs) - alias
    colls = _collective_totals(census.ops)
    colls["comm_debug_counts"] = {str(k): v for k, v in
                                  comm.get_comm_counts().items()}
    return {
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_run, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": census.temp_peak, "alias_bytes": alias,
                   "peak_bytes": arg_bytes + census.temp_peak},
        "cost_analysis": {"flops": census.flops * mesh.size(),
                          "flops_per_device": census.flops,
                          "bytes_accessed": census.bytes_accessed},
        "collectives": colls,
    }


def run_cell(arch: str, shape: str, *, multi_pod: bool) -> dict:
    """One production cell: its mesh over a fake group, its step, its
    record (the reference's keys)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import bundle_for
    n_dev = 512 if multi_pod else 256
    with fake_group(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cfg = config_for_shape(get_config(arch), shape, num_shards=n_dev)
        specs = input_specs(cfg, shape)
        t0 = time.time()
        bundle = bundle_for(cfg, mesh, shape, specs)
        t_build = time.time() - t0
        rec = run_bundle(bundle, mesh)
    rec["lower_s"] = round(rec["lower_s"] + t_build, 1)
    return {"arch": arch, "shape": shape,
            "mesh": "2x16x16" if multi_pod else "16x16", "devices": n_dev,
            "ok": True, **rec, "full_groups": cfg.full_groups,
            "moe_groups": cfg.moe_groups}


def run_step(cfg, kind_shape: str, specs: dict, mesh_shape, axes=None,
             **bundle_kw) -> dict:
    """A step of any config and inputs on a fake ``mesh_shape`` mesh (the
    tests' miniature cells, the card's 1x1 streaming decode step)."""
    from repro_torch.launch.steps import bundle_for
    axes = axes or (("pod", "data", "model") if len(mesh_shape) == 3
                    else ("data", "model"))
    with fake_group(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, axes)
        return run_bundle(bundle_for(cfg, mesh, kind_shape, specs,
                                     **bundle_kw), mesh)


def report(directory) -> dict:
    """The records in ``directory``: cells that ran, were n/a or failed,
    and those whose per-device peak exceeds one H100's 80 GiB."""
    from repro_torch.core.planner import H100_SXM
    recs = [json.loads(p.read_text())
            for p in sorted(Path(directory).glob("*__*__*.json"))]
    ran = [r for r in recs if r.get("ok")]
    over = sorted(f"{r['arch']} x {r['shape']} on {r['mesh']}: "
                  f"{r['memory']['peak_bytes'] / 2**30:.2f} GiB"
                  for r in ran
                  if r["memory"]["peak_bytes"] > H100_SXM.hbm_bytes)
    out = {"records": len(recs), "ran": len(ran),
           "n/a": sum(bool(r.get("skipped")) for r in recs),
           "failed": sum(not r.get("ok") and not r.get("skipped")
                         for r in recs),
           "above_80GiB": over}
    print(f"[report] {out['records']} records: {out['ran']} ran, "
          f"{out['n/a']} n/a, {out['failed']} failed; {len(over)} of the "
          f"{out['ran']} above 80 GiB per device")
    for line in over:
        print(f"[report]   {line}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="summarise the records in DIR and exit")
    args = ap.parse_args(argv)
    if args.report:
        report(args.report)
        return

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_NAMES if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, why = shape_applicable(cfg, shape)
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = out / f"{tag}.json"
                if args.skip_existing and path.exists():
                    print(f"[skip] {tag}")
                    continue
                if not ok:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "ok": False, "skipped": True, "reason": why}
                    path.write_text(json.dumps(rec, indent=1))
                    print(f"[n/a ] {tag}: {why}")
                    continue
                print(f"[run ] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=mp)
                    coll = rec["collectives"]["per_device_bytes_total"]
                    print(f"[ ok ] {tag}: run={rec['compile_s']}s "
                          f"peak={rec['memory']['peak_bytes']/2**30:.2f}GiB "
                          f"coll={coll/2**20:.1f}MiB", flush=True)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                path.write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
