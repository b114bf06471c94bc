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
  planner       — the roofline planner at pod scale (a copy), with the
                  H100's chip spec beside the TPU's.
"""

from . import (decision, dispatch, engine, planner, runtime_model, simulator,
               sync)
from .dispatch import DispatchStats, MulticastDispatcher, SequentialDispatcher
from .planner import (H100_SXM, TPU_V5E, ChipSpec, JobStats, RooflineTerms,
                      choose_extent, roofline)
from .sync import (CreditCounterSync, FaultDetected, PollingSync,
                   credit_threshold, emit_credits)

__all__ = ["simulator", "runtime_model", "decision", "dispatch", "sync",
           "engine", "planner",
           "DispatchStats", "MulticastDispatcher", "SequentialDispatcher",
           "CreditCounterSync", "FaultDetected", "PollingSync",
           "emit_credits", "credit_threshold", "ChipSpec", "TPU_V5E",
           "H100_SXM", "JobStats", "RooflineTerms", "roofline",
           "choose_extent"]
