"""Self-contained checkpointing, in the reference's on-disk format.

The port of ``repro/ckpt/checkpoint.py``; each package restores what the
other wrote:
  * every leaf is written as one ``.npy`` file under a per-step directory,
    named ``leaf_<i>.npy`` in the reference's leaf order (dict keys sorted,
    ``None`` holding no leaf);
  * a JSON manifest records each leaf's tree path (``"0/groups/1/attn/wq"``),
    shape and dtype, plus the step and caller metadata;
  * writes go to ``<dir>/tmp.<step>`` and are atomically renamed to
    ``<dir>/step_<step>`` — a crashed save never corrupts the latest
    checkpoint;
  * ``CheckpointManager`` saves asynchronously (device tensors are copied
    to the host first, so training proceeds while the write happens) and
    keeps the last N checkpoints.

A tree of DTensors (placed over a ``DeviceMesh``) is saved whole: each
leaf is gathered on every rank and rank 0 writes the files.  A restore in
a process group first meets every rank at a barrier (so rank 0's writes
have ended) and reads the step rank 0 chose, so every rank restores the
same checkpoint.  Restoring with ``mesh=`` places each leaf by a spec
tree on that mesh, whatever mesh the tree was saved from (the reference's
elastic restore).

A restore copies into the tensors of the tree it is given, where the
reference builds new arrays: the supervisor's rollback then leaves the
parameters and moments at the addresses a compiled train step holds.

bf16 leaves are written as the reference writes them: numpy has no
bfloat16, so the file holds the raw 2-byte values with the ``'<V2'`` descr
and the manifest says ``"bfloat16"``.  On restore the manifest's dtype
decides: a ``"bfloat16"`` leaf is read as uint16 bits and viewed as
``torch.bfloat16``, whichever package wrote it.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's (JAX pytree) leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = []
        for k in sorted(tree):
            items += _flatten(tree[k], f"{prefix}{k}{_SEP}")
        return items
    if isinstance(tree, (tuple, list)):
        items = []
        for i, v in enumerate(tree):
            items += _flatten(v, f"{prefix}{i}{_SEP}")
        return items
    return [(prefix[:-len(_SEP)], tree)]


def _unflatten(tree: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}{_SEP}")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}{i}{_SEP}")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-len(_SEP)]]


class _HostLeaf:
    """A leaf copied to the host: its numpy array and manifest dtype name."""

    __slots__ = ("arr", "dtype")

    def __init__(self, leaf: Any):
        if isinstance(leaf, _HostLeaf):
            self.arr, self.dtype = leaf.arr, leaf.dtype
            return
        if isinstance(leaf, torch.Tensor):
            from torch.distributed.tensor import DTensor
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()   # a collective: every rank
            # A copy even for CPU tensors: the caller may update the leaf in
            # place while the background thread writes it.
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                self.arr = t.view(torch.int16).numpy().view(np.uint16)
                self.dtype = "bfloat16"
                return
            self.arr = t.numpy()
        else:
            self.arr = np.asarray(leaf)
        self.dtype = str(self.arr.dtype)

    def save(self, path: Path) -> None:
        if self.dtype != "bfloat16":
            np.save(path, self.arr)
            return
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": self.arr.shape})
            f.write(np.ascontiguousarray(self.arr).tobytes())


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _group_size() -> int:
    """The process group's world size; 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _writer() -> bool:
    """Whether this process writes files: rank 0 of a process group."""
    return _group_size() == 1 or dist.get_rank() == 0


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    extra: dict | None = None) -> Path:
    """Synchronous atomic save of one tree of tensors (or numpy arrays).

    In a process group every rank calls it (DTensor leaves are gathered)
    and rank 0 alone writes; ``restore_checkpoint`` waits for it.
    """
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    if not _writer():
        for _, leaf in _flatten(tree):
            _HostLeaf(leaf)
        return final
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "format": 1}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        host = _HostLeaf(leaf)
        fname = f"leaf_{i:05d}.npy"
        host.save(tmp / fname)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": list(host.arr.shape),
                                   "dtype": host.dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def list_steps(directory: str | Path) -> list[int]:
    """All retained checkpoint steps, ascending (empty if none/missing)."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_"))


def latest_step(directory: str | Path) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _agreed_step(directory: Path, step: int | None) -> int:
    """``step``, or the latest one; in a process group of several ranks,
    rank 0's choice, made after every rank (rank 0's writes done) met at a
    barrier."""
    if _group_size() > 1:
        dist.barrier()
        box = [step if step is not None or dist.get_rank() != 0
               else latest_step(directory)]
        dist.broadcast_object_list(box, src=0)
        step = box[0]
    elif step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def _in_place(ref: Any, mesh) -> bool:
    """Whether the restore copies into ``ref`` itself: a tensor that holds
    data (not on the meta device), a DTensor when restoring onto a mesh
    and a plain tensor otherwise."""
    if not isinstance(ref, torch.Tensor) or ref.device.type == "meta":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(ref, DTensor) == (mesh is not None)


def restore_checkpoint(directory: str | Path, tree_like: Any,
                       step: int | None = None, *,
                       shardings: Any = None,
                       mesh=None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like``; returns (tree, step,
    extra).

    A tensor leaf of ``tree_like`` that holds data is restored in place:
    the saved values are copied into it and the returned tree holds that
    very tensor, so whatever holds the leaf at its address (a compiled
    train step) goes on with the restored values.  Its shape and dtype
    must be the saved ones; every leaf is read and checked before any is
    written.  Any other leaf is a shape reference and comes back as a new
    tensor: a meta tensor or an array is checked against the manifest, a
    shapeless placeholder (e.g. ``0``) matches by name only.
    ``shardings`` — the port's counterpart of the reference's placement
    argument — is the ``torch.device`` of the new leaves (None: the CPU).
    With a ``DeviceMesh`` as ``mesh``, ``shardings`` is a spec tree (of
    ``runtime.sharding.PartitionSpec``) with ``tree_like``'s structure:
    every leaf is placed by its spec on ``mesh``, a DTensor leaf of
    ``tree_like`` (which must have those placements) is restored in place,
    and any other comes back a new DTensor — a restore onto another mesh
    (the reference's elastic restore).

    In a process group every rank calls it, after its own writes ended
    (``CheckpointManager.restore_latest`` waits for them), and every rank
    restores the step rank 0 chooses.
    """
    directory = Path(directory)
    step = _agreed_step(directory, step)
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {m["name"]: m for m in manifest["leaves"]}
    refs = _flatten(tree_like)
    leaves = {}
    for name, ref in refs:
        m = by_name.get(name)
        if m is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        t = _load_leaf(d / m["file"], m["dtype"])
        want_shape = tuple(getattr(ref, "shape", t.shape))
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"expected {want_shape}")
        if _in_place(ref, mesh) and ref.dtype != t.dtype:
            raise ValueError(f"{name}: checkpoint dtype {t.dtype} != the "
                             f"leaf's {ref.dtype}")
        leaves[name] = t
    if mesh is not None:
        from repro_torch.runtime.sharding import to_shardings
        dev = torch.device(mesh.device_type)
        placed = to_shardings(_unflatten(tree_like, {
            n: t.to(dev) for n, t in leaves.items()}), shardings, mesh)
        leaves = dict(_flatten(placed))
    elif shardings is not None:
        leaves = {n: t.to(shardings) for n, t in leaves.items()}
    for name, ref in refs:
        if _in_place(ref, mesh):
            with torch.no_grad():
                ref.copy_(leaves[name])
            leaves[name] = ref
    return _unflatten(tree_like, leaves), step, manifest["extra"]


class CheckpointManager:
    """Async saves + retention. ``save`` returns immediately; ``wait`` joins."""

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None,
             *, blocking: bool = False) -> None:
        # Host copies first (one device sync), so the caller may go on
        # updating its tensors in place while the files are written.
        host = {name: _HostLeaf(leaf) for name, leaf in _flatten(tree)}
        host_tree = _unflatten(tree, host)
        self.wait()

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like: Any, *, shardings: Any = None,
                       mesh=None):
        """``restore_checkpoint`` of the latest step, into ``tree_like``'s
        tensors, once this manager's writes have ended."""
        self.wait()
        return restore_checkpoint(self.directory, tree_like,
                                  shardings=shardings, mesh=mesh)

    def _gc(self) -> None:
        if not _writer():
            return
        steps = sorted(p for p in self.directory.iterdir()
                       if p.is_dir() and p.name.startswith("step_"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p)
