"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Builds the cell's set-up, serves its
traffic through ``ContinuousBatcher.run`` for ``--seconds``, judges a
sample of the served tokens against the plain reference and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
its per-layer metrics with ``--trace 1``), ``device`` (and ``breakdown``
with ``--trace 1``), and last ``checks``, each compared number beside its
limit, which are also the last lines of standard error.  An earlier line
gives the card, its power limit and the peaks the metrics are taken
against.  Exits non-zero, printing no result, without a CUDA card or with
fewer cards than the cell asks for, and if JAX or the JAX package was
loaded.  Build outputs go to ``build/`` inside the checkout.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 without it)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = _T0 - _process_age()


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout; keep libraries that
    could load JAX by themselves from doing so."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch-extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness, peaks
    cell = harness.Cell.load(ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    result, lines = harness.run(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), dev, T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: loaded {bad}: the port must not need JAX",
              file=sys.stderr)
        return 4
    name = torch.cuda.get_device_name(dev)
    print(json.dumps({"card": name, "power_limit": power_limit(),
                      "peaks": peaks.peaks(name)}), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
