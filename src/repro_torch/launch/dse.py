"""Co-design explorer CLI: sweep the offload design space (DESIGN.md §3).

  PYTHONPATH=src python -m repro_torch.launch.dse                       # paper grid
  PYTHONPATH=src python -m repro_torch.launch.dse --bus 48,96,192 \\
      --kernels daxpy,fused_adamw --workers 4 --deadline 700 --deadline-n 1024
  PYTHONPATH=src python -m repro_torch.launch.dse --sample 16 --seed 1 \\
      --axis cluster_wakeup=20,40,80 --json DSE.json
  PYTHONPATH=src python -m repro_torch.launch.dse --fleet --dvfs eco,nominal,turbo \\
      --power-cap 0.2                                # power-capped fleet DSE

Each design point (dispatch x sync x kernel x HWParams overrides) is run
through the discrete-event simulator over the (M, N) grid, refit to the
analytical Eq.-1 model (MAPE recorded), scored against the paper baseline,
and ranked; the (runtime, cost) Pareto front and — with ``--deadline`` — the
Eq.-3 deadline-feasible region per front design are printed.

``--fleet`` switches to the fleet-composition axis (DESIGN.md §8.3/§11):
each composition x router x DVFS point serves the same open-loop trace end
to end and is Pareto-scored on (throughput, p99, watts); ``--power-cap``
excludes over-cap compositions before the front forms, and silicon area is
reported per design as the static build proxy.

The port of ``repro/launch/dse.py``: the explorer is numpy, so its output
is line for line the reference's.  It runs on the CPU; no flag touches a
card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.dse import (DEFAULT_M_GRID, DEFAULT_N_GRID, DesignSpace,
                       deadline_region, design_speedup, front, run_sweep,
                       summarize)


def _ints(csv: str) -> list[int]:
    return [int(x) for x in csv.split(",") if x]


def _axis(spec: str) -> tuple[str, list]:
    """Parse --axis NAME=v1,v2,... (values as int, else float)."""
    name, _, values = spec.partition("=")
    if not values:
        raise argparse.ArgumentTypeError(
            f"--axis wants NAME=v1,v2,..., got {spec!r}")
    parsed = []
    for v in values.split(","):
        try:
            parsed.append(int(v))
        except ValueError:
            parsed.append(float(v))
    return name, parsed


def build_space(args) -> DesignSpace:
    hw_axes: dict = {}
    if args.bus:
        hw_axes["bus_bytes_per_cycle"] = _ints(args.bus)
    for name, values in args.axis or []:
        hw_axes[name] = values
    return DesignSpace(
        hw_axes=hw_axes,
        dispatch=tuple(args.dispatch.split(",")),
        sync=tuple(args.sync.split(",")),
        buffering=tuple(args.buffering.split(",")),
        kernels=tuple(args.kernels.split(",")),
    )


def run_fleet(args) -> dict:
    """Fleet-composition DSE: (throughput, p99, watts) front, power-capped."""
    from repro_torch.dse import (FleetSpace, fleet_front, silicon_area,
                           summarize_fleets, sweep_fleets)
    from repro_torch.serve import WorkloadSpec

    compositions = (tuple(tuple(_ints(c)) for c in
                          args.compositions.split(";") if c)
                    if args.compositions else None)
    space = FleetSpace(
        **({"compositions": compositions} if compositions else {}),
        routers=tuple(args.routers.split(",")),
        dvfs_points=tuple(args.dvfs.split(",")))
    spec = WorkloadSpec(num_requests=args.requests, seed=args.seed)
    print(f"sweeping {space.size} fleet designs "
          f"({len(space.compositions)} compositions x "
          f"{len(space.routers)} routers x {len(space.dvfs_points)} DVFS "
          f"points) on {spec.num_requests} requests")
    results = sweep_fleets(space, spec)

    print("\n" + summarize_fleets(results, power_cap_w=args.power_cap))
    uncapped = fleet_front(results)
    fr = fleet_front(results, power_cap_w=args.power_cap)
    cap_txt = (f" under cap {args.power_cap:.3f} W"
               if args.power_cap is not None else "")
    print(f"\nPareto front{cap_txt} ({len(fr)}/{len(results)} designs, "
          "max throughput / min p99 / min watts):")
    for r in fr:
        area = silicon_area(r.design.sizes)
        tpj = (f"{r.tokens_per_joule:,.0f} tok/J"
               if r.tokens_per_joule else "-")
        print(f"  {r.design.name:<20} thr {r.throughput_rps:>9.0f} req/s  "
              f"p99 {r.p99_us:>7.1f} us  {r.watts:.3f} W  {tpj}  "
              f"silicon area {area:.2f}")
    excluded = [r for r in uncapped if r not in fr]
    if excluded:
        print("\nexcluded by the power cap (on the uncapped front):")
        for r in excluded:
            print(f"  {r.design.name:<20} {r.watts:.3f} W "
                  f"> {args.power_cap:.3f} W")

    out = {
        "results": [r.as_dict() for r in results],
        "front": [r.design.name for r in fr],
        "uncapped_front": [r.design.name for r in uncapped],
        "excluded_over_cap": [r.design.name for r in excluded],
        "power_cap_w": args.power_cap,
    }
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2) + "\n")
        print(f"\nwrote {len(results)} fleet records to {args.json}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bus", default=None,
                    help="comma list of bus widths (B/cycle), e.g. 48,96,192")
    ap.add_argument("--axis", action="append", type=_axis, metavar="F=V,V",
                    help="extra HWParams axis, e.g. cluster_wakeup=20,40,80 "
                         "(repeatable)")
    ap.add_argument("--dispatch", default="unicast,multicast")
    ap.add_argument("--sync", default="poll,credit")
    ap.add_argument("--buffering", default="single",
                    help="comma list of descriptor-buffering depths to sweep "
                         "(single,double); double designs are scored on "
                         "steady-state pipelined runtimes (DESIGN.md §7)")
    ap.add_argument("--kernels", default="daxpy",
                    help="comma list of registry kernels "
                         "(repro_torch.kernels.ops.KERNELS)")
    ap.add_argument("--ms", default=",".join(map(str, DEFAULT_M_GRID)))
    ap.add_argument("--ns", default=",".join(map(str, DEFAULT_N_GRID)))
    ap.add_argument("--sample", type=int, default=None,
                    help="random-sample K points instead of the full grid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1,
                    help=">1 fans the sweep out over a process pool")
    ap.add_argument("--top", type=int, default=12, help="rows in the table")
    ap.add_argument("--deadline", type=float, default=None,
                    help="runtime budget (cycles) for the feasibility report")
    ap.add_argument("--deadline-n", type=int, default=1024,
                    help="problem sizes report around this N")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("--fleet", action="store_true",
                    help="sweep fleet compositions instead of single-fabric "
                         "designs (DESIGN.md §8.3/§11)")
    ap.add_argument("--compositions", default=None, metavar="C;C;...",
                    help="semicolon list of comma compositions, e.g. "
                         "'32;16,16;16,8,8' (default: the §8.3 set)")
    ap.add_argument("--routers", default="model",
                    help="comma list of router policies swept per "
                         "composition (model,rr,lql)")
    ap.add_argument("--dvfs", default="nominal",
                    help="comma list of DVFS points swept per composition "
                         "(eco,nominal,turbo)")
    ap.add_argument("--power-cap", type=float, default=None, metavar="WATTS",
                    help="power-capped DSE: exclude compositions whose "
                         "served draw exceeds this before the front forms")
    ap.add_argument("--requests", type=int, default=96,
                    help="trace length for the fleet sweep")
    args = ap.parse_args(argv)

    if args.fleet:
        return run_fleet(args)

    space = build_space(args)
    points = (space.sample(args.sample, seed=args.seed)
              if args.sample else space)
    ms, ns = _ints(args.ms), _ints(args.ns)
    n_points = args.sample or space.size
    print(f"sweeping {n_points} design points over "
          f"{len(ms)}x{len(ns)} (M, N) grid "
          f"({'sampled' if args.sample else 'full grid'}, "
          f"workers={args.workers})")
    results = run_sweep(points, ms, ns, workers=args.workers,
                        base_hw=space.base_hw)

    print("\n" + summarize(results, top=args.top))
    fr = front(results)
    print(f"\nPareto front ({len(fr)}/{len(results)} designs, "
          "minimize t_ref & cost):")
    for r in fr:
        print(f"  {r.point.name:<44} t_ref {r.t_ref:>7.0f} cy  "
              f"cost {r.cost:.2f}  MAPE {r.mape_pct:.2f}%")
    if len(fr) > 1:
        # Pareto extremes head-to-head: what the extra silicon buys at the
        # reference point (design_speedup works for ANY swept pair, not just
        # the paper's two published designs).
        fastest = min(fr, key=lambda r: r.t_ref)
        cheapest = min(fr, key=lambda r: r.cost)
        if fastest is not cheapest:
            sp = design_speedup(fastest.point, cheapest.point,
                                max(ms), max(ns))
            print(f"\nfront extremes at (M={max(ms)}, N={max(ns)}): "
                  f"[{fastest.point.name}] is {sp:.2f}x over "
                  f"[{cheapest.point.name}] for "
                  f"{fastest.cost - cheapest.cost:+.2f} cost")

    if args.deadline is not None:
        ns_report = sorted({n for n in ns
                            if n <= args.deadline_n} | {args.deadline_n})[-4:]
        print(f"\ndeadline {args.deadline:.0f} cy — smallest feasible M "
              "(Eq. 3) per front design (for unicast designs larger M may "
              "be infeasible again):")
        for r in fr:
            region = deadline_region(r, ns_report, args.deadline, ms)
            cells = ", ".join(
                f"N={n}: {'-' if m is None else f'minM={m}'}"
                for n, m in region.items())
            print(f"  {r.point.name:<44} {cells}")

    out = {
        "grid": {"ms": ms, "ns": ns},
        "results": [r.as_dict() for r in results],
        "front": [r.point.name for r in fr],
    }
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2) + "\n")
        print(f"\nwrote {len(results)} design records to {args.json}")
    return out


if __name__ == "__main__":
    main()
