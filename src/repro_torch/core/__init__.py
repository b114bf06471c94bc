"""The paper's offload path, ported: cycle model, Eq.-1 runtime model,
Eq.-3 decision, and the dispatch/sync pair on one CUDA card.

Submodules:
  simulator     — cycle model of the Manticore offload path (a copy).
  runtime_model — t̂(M,N) = alpha + beta*N + gamma*N/M; fitting + MAPE.
  decision      — M_min under a deadline (Eq. 3), argmin-M, host-vs-offload.
  dispatch      — Sequential (baseline) vs Multicast host->device dispatch.
  sync          — Polling (baseline) vs CreditCounter completion.
  engine        — discrete-event host+fabric timeline of overlapped jobs
                  (single/double descriptor buffering; a copy).

The TPU-pod roofline planner (``repro/core/planner.py``) is not ported: it
waits for the card's own chip spec (ROADMAP A12).
"""

from . import decision, dispatch, engine, runtime_model, simulator, sync
from .dispatch import DispatchStats, MulticastDispatcher, SequentialDispatcher
from .sync import CreditCounterSync, FaultDetected, PollingSync, emit_credits

__all__ = ["simulator", "runtime_model", "decision", "dispatch", "sync",
           "engine",
           "DispatchStats", "MulticastDispatcher", "SequentialDispatcher",
           "CreditCounterSync", "FaultDetected", "PollingSync",
           "emit_credits"]
