"""Declarative hardware/software design space for the offload path.

The port of ``repro/dse/space.py``, copied with its imports renamed: the
same results as the reference's on the same inputs.

A :class:`DesignSpace` names the axes the explorer may vary (DESIGN.md §3):

  * any field of :class:`repro_torch.core.simulator.HWParams` (bus width, wakeup
    latency, cores per cluster, ...), given as ``{"field": [values, ...]}``;
  * the dispatch axis (``"unicast"`` | ``"multicast"``);
  * the completion-sync axis (``"poll"`` | ``"credit"``);
  * the job-descriptor buffering axis (``"single"`` | ``"double"`` —
    DESIGN.md §7: double-buffered descriptors let the host dispatch job k+1
    while job k executes, so the design is scored on its *steady-state*
    pipelined runtimes);
  * the kernel, by registry name (``repro_torch.kernels.ops.KERNELS``).

``grid()`` enumerates the full cross product; ``sample(k, seed)`` draws a
uniform random subset of the same product for spaces too large to sweep
exhaustively.  Each concrete combination is a :class:`DesignPoint` — a frozen,
picklable value the parallel sweep runner farms out to worker processes.

One level up, :class:`repro_torch.dse.fleet.FleetSpace` is the fleet-composition
axis (DESIGN.md §8.3): instead of varying one fabric's parameters, it
partitions a fixed cluster budget into several fabrics and scores each
composition on served (throughput, p99, cost).
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from dataclasses import dataclass, field
from typing import Iterator, Mapping, Sequence

from repro_torch.core.engine import BUFFERING_MODES
from repro_torch.core.simulator import DISPATCH_MODES, SYNC_MODES, HWParams

_HW_FIELDS = {f.name for f in dataclasses.fields(HWParams)}


@dataclass(frozen=True)
class DesignPoint:
    """One concrete hardware/software co-design to simulate."""

    dispatch: str
    sync: str
    kernel_name: str = "daxpy"
    hw: HWParams = HWParams()
    #: Job-descriptor buffering depth (DESIGN.md §7).  ``"double"`` designs
    #: are scored on steady-state pipelined runtimes (repro_torch.core.engine);
    #: ``"single"`` keeps the closed-form isolated-job scoring.
    buffering: str = "single"
    #: (field, value) pairs where ``hw`` differs from the default HWParams —
    #: derived, so the point's name always matches what it simulates.
    hw_overrides: tuple[tuple[str, object], ...] = dataclasses.field(
        init=False)

    def __post_init__(self):
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch must be one of {DISPATCH_MODES}")
        if self.sync not in SYNC_MODES:
            raise ValueError(f"sync must be one of {SYNC_MODES}")
        if self.buffering not in BUFFERING_MODES:
            raise ValueError(f"buffering must be one of {BUFFERING_MODES}")
        object.__setattr__(self, "hw_overrides", tuple(
            (f.name, getattr(self.hw, f.name))
            for f in dataclasses.fields(HWParams)
            if getattr(self.hw, f.name) != f.default))

    @property
    def name(self) -> str:
        tags = [self.kernel_name, f"{self.dispatch}+{self.sync}"]
        if self.buffering != "single":
            tags.append(f"buf={self.buffering}")
        tags += [f"{k}={v}" for k, v in self.hw_overrides]
        return " ".join(tags)

    @property
    def is_paper_baseline(self) -> bool:
        """The paper's baseline design point: sequential dispatch + polling."""
        return (self.dispatch, self.sync) == ("unicast", "poll")

    @property
    def is_paper_extended(self) -> bool:
        """The paper's extended design point: multicast + credit counter."""
        return (self.dispatch, self.sync) == ("multicast", "credit")

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "dispatch": self.dispatch,
            "sync": self.sync,
            "buffering": self.buffering,
            "kernel": self.kernel_name,
            "hw_overrides": dict(self.hw_overrides),
        }


@dataclass(frozen=True)
class DesignSpace:
    """The axes of a sweep; ``grid()``/``sample()`` yield DesignPoints."""

    hw_axes: Mapping[str, Sequence] = field(default_factory=dict)
    dispatch: Sequence[str] = DISPATCH_MODES
    sync: Sequence[str] = SYNC_MODES
    #: Descriptor-buffering axis; the default sweeps only the paper's
    #: single-buffered protocol so legacy spaces keep their size.
    buffering: Sequence[str] = ("single",)
    kernels: Sequence[str] = ("daxpy",)
    base_hw: HWParams = HWParams()

    def __post_init__(self):
        unknown = set(self.hw_axes) - _HW_FIELDS
        if unknown:
            raise ValueError(f"unknown HWParams field(s) {sorted(unknown)}; "
                             f"valid: {sorted(_HW_FIELDS)}")
        bad_d = set(self.dispatch) - set(DISPATCH_MODES)
        bad_s = set(self.sync) - set(SYNC_MODES)
        if bad_d or bad_s:
            raise ValueError(f"invalid dispatch {sorted(bad_d)} / "
                             f"sync {sorted(bad_s)} modes")
        bad_b = set(self.buffering) - set(BUFFERING_MODES)
        if bad_b:
            raise ValueError(f"invalid buffering modes {sorted(bad_b)}")
        if not self.kernels:
            raise ValueError("need at least one kernel")
        # Normalize every axis to distinct values (order-preserving), so
        # size/grid/sample agree on the number of distinct designs.
        object.__setattr__(self, "hw_axes",
                           {k: tuple(dict.fromkeys(v))
                            for k, v in self.hw_axes.items()})
        object.__setattr__(self, "dispatch",
                           tuple(dict.fromkeys(self.dispatch)))
        object.__setattr__(self, "sync", tuple(dict.fromkeys(self.sync)))
        object.__setattr__(self, "buffering",
                           tuple(dict.fromkeys(self.buffering)))
        object.__setattr__(self, "kernels",
                           tuple(dict.fromkeys(self.kernels)))

    @property
    def size(self) -> int:
        n = (len(self.dispatch) * len(self.sync) * len(self.buffering)
             * len(self.kernels))
        for values in self.hw_axes.values():
            n *= len(values)
        return n

    def _make_point(self, dispatch: str, sync: str, buffering: str,
                    kernel: str, hw_values: tuple) -> DesignPoint:
        hw = dataclasses.replace(self.base_hw, **dict(zip(self.hw_axes,
                                                          hw_values)))
        return DesignPoint(dispatch=dispatch, sync=sync, buffering=buffering,
                           kernel_name=kernel, hw=hw)

    def grid(self) -> Iterator[DesignPoint]:
        """Exhaustive cross product of every axis."""
        for kernel in self.kernels:
            for dispatch in self.dispatch:
                for sync in self.sync:
                    for buffering in self.buffering:
                        for hw_values in itertools.product(
                                *self.hw_axes.values()):
                            yield self._make_point(dispatch, sync, buffering,
                                                   kernel, hw_values)

    def sample(self, k: int, *, seed: int = 0) -> list[DesignPoint]:
        """``k`` distinct points drawn uniformly from the product space."""
        k = min(k, self.size)
        rng = random.Random(seed)
        seen: set[tuple] = set()
        points: list[DesignPoint] = []
        while len(points) < k:
            combo = (
                rng.choice(list(self.dispatch)),
                rng.choice(list(self.sync)),
                rng.choice(list(self.buffering)),
                rng.choice(list(self.kernels)),
                tuple(rng.choice(list(v)) for v in self.hw_axes.values()),
            )
            if combo in seen:
                continue
            seen.add(combo)
            points.append(self._make_point(*combo))
        return points

    def baseline_point(self, kernel: str | None = None) -> DesignPoint:
        """The paper-baseline reference all speedups are computed against."""
        return DesignPoint(dispatch="unicast", sync="poll",
                           kernel_name=kernel or self.kernels[0],
                           hw=self.base_hw)


#: The dispatch x sync grid over the default hardware — four designs, two of
#: which are the paper's published baseline and extended points.
PAPER_SPACE = DesignSpace(kernels=("daxpy",))
