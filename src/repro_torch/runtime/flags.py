"""Runtime flags (a copy of ``repro/runtime/flags.py``).

``REPRO_BASELINE=1`` disables the beyond-paper collective-layout
optimizations (EXPERIMENTS.md §Perf iterations 2/4/5), reverting to the
paper-faithful baseline system — so both rows of the before/after tables are
reproducible from the same tree:

  * MoE dispatch-scatter local-domain pinning (iter. 2),
  * never-gather cross-entropy + replicated small dims of embed/lm_head
    (iter. 4),
  * flash-decoding (slot-parallel) decode layout (iter. 5).
"""

from __future__ import annotations

import os


def baseline_mode() -> bool:
    return os.environ.get("REPRO_BASELINE", "") not in ("", "0")
