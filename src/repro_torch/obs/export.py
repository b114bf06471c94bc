"""Trace exporters: Chrome Trace Event JSON (Perfetto) and a JSONL log.

The port of ``repro/obs/export.py``: its results are bit-identical to the
reference's on the same inputs, save the host clock's epoch, which a trace
with host-clock stamps carries in its metadata.

Chrome Trace Event JSON is the `trace event format`_ Perfetto's legacy
importer reads: open https://ui.perfetto.dev and drop the file in.  The
exporter maps the tracer's ``proc`` names to processes and its ``track``
names to threads, emits the ``process_name``/``thread_name`` metadata
Perfetto uses for labels, and converts both time domains to the format's
microsecond axis:

  * ``cycles`` at the paper's 1 GHz clock: 1 cycle == 1 ns == 1e-3 us;
  * ``wall_s`` measured host seconds: 1 s == 1e6 us.

The cycle domain has no epoch, so wall-domain procs are exported as
separate ``wall:<proc>`` processes — side by side, never overlaid
(DESIGN.md §9).  A trace whose wall events were stamped on the tracer's
host clock carries that clock's epoch in ``otherData``:
``wall_epoch_unix_ns``, the Unix time in ns of its zero, so that
``wall_epoch_unix_ns / 1e3 + ts`` puts a ``wall:`` event on the Unix
microsecond axis a ``torch.profiler`` trace of the card uses.

The JSONL exporter writes one raw event dict per line (recording order,
native time units) — the machine-readable log ``tools/trace_report.py`` and
the residual tooling consume without Chrome-format lossiness.

.. _trace event format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""

from __future__ import annotations

import json
from pathlib import Path

from .tracer import Tracer

#: Cycles per microsecond at the paper's 1 GHz clock (cycles == ns).
CYCLES_PER_US = 1e3

#: Chrome flow-event phases (start / finish).
_FLOW_PHASES = {"s", "f"}


def _proc_key(e) -> str:
    """Process grouping key: wall-domain events get their own process so
    the unaligned time domains are never rendered on one axis."""
    return e.proc if e.domain == "cycles" else f"wall:{e.proc}"


def _ts_us(e) -> float:
    return e.ts / CYCLES_PER_US if e.domain == "cycles" else e.ts * 1e6


def to_chrome(tracer: Tracer) -> dict:
    """Translate recorded events to a Chrome Trace Event JSON object."""
    pids: dict[str, int] = {}
    tids: dict[tuple[str, str], int] = {}
    out: list[dict] = []

    for e in tracer.events:
        proc = _proc_key(e)
        if proc not in pids:
            pids[proc] = len(pids) + 1
            out.append({"ph": "M", "name": "process_name", "pid": pids[proc],
                        "tid": 0, "args": {"name": proc}})
        key = (proc, e.track)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == proc]) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pids[proc],
                        "tid": tids[key], "args": {"name": e.track}})
        rec = {"ph": e.ph, "name": e.name, "cat": e.track,
               "pid": pids[proc], "tid": tids[key], "ts": _ts_us(e)}
        if e.ph == "X":
            rec["dur"] = e.dur / CYCLES_PER_US if e.domain == "cycles" \
                else e.dur * 1e6
        if e.ph == "C":
            rec["args"] = e.args or {"value": 0.0}
        elif e.args:
            rec["args"] = e.args
        if e.ph in _FLOW_PHASES:
            rec["id"] = e.flow
            rec["cat"] = "route"
            if e.ph == "f":
                rec["bp"] = "e"     # bind to the enclosing slice
        out.append(rec)

    # Perfetto tolerates unsorted input but renders (and diffs) better
    # sorted; metadata events carry ts 0 implicitly and sort first.
    out.sort(key=lambda r: (r["ph"] != "M", r.get("ts", 0.0)))
    doc = {"traceEvents": out, "displayTimeUnit": "ns"}
    if tracer.host_stamped:
        doc["otherData"] = {"wall_epoch_unix_ns": tracer.epoch_unix_ns}
    return doc


def write_chrome_trace(tracer: Tracer, path: str | Path) -> Path:
    """Write the Perfetto-loadable Chrome Trace Event JSON file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(tracer)) + "\n")
    return path


def write_jsonl(tracer: Tracer, path: str | Path) -> Path:
    """Write the raw event log: one JSON object per line, native units."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for e in tracer.events:
            f.write(json.dumps(e.as_dict()) + "\n")
    return path


def read_jsonl(path: str | Path) -> list[dict]:
    """Load a JSONL event log back into raw event dicts."""
    return [json.loads(line)
            for line in Path(path).read_text().splitlines() if line]
