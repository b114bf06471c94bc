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
from .decision import (OffloadDecision, best_m, breakeven_n,
                       m_min_for_deadline, should_offload)
from .dispatch import (DISPATCHERS, DispatchStats, MulticastDispatcher,
                       SequentialDispatcher)
from .engine import (BUFFERING_MODES, JobRecord, OffloadEngine,
                     steady_runtime, steady_sweep)
from .planner import (H100_SXM, TPU_V5E, ChipSpec, JobStats, RooflineTerms,
                      choose_extent, roofline)
from .runtime_model import (PAPER_MODEL, OffloadModel, fit,
                            fit_from_simulator, fit_pipelined_from_engine,
                            mape, mape_by_n)
from .simulator import (DAXPY, DISPATCH_MODES, SYNC_MODES, HWParams,
                        KernelSpec, OffloadTrace, host_runtime,
                        offload_runtime, simulate_offload, speedup, sweep)
from .sync import (SYNCS, CreditCounterSync, FaultDetected, PollingSync,
                   attach_credits, credit_threshold, emit_credits)

__all__ = ["simulator", "runtime_model", "decision", "dispatch", "sync",
           "engine", "planner",
           "DispatchStats", "MulticastDispatcher", "SequentialDispatcher",
           "DISPATCHERS", "CreditCounterSync", "FaultDetected",
           "PollingSync", "SYNCS", "attach_credits", "emit_credits",
           "credit_threshold", "ChipSpec", "TPU_V5E",
           "H100_SXM", "JobStats", "RooflineTerms", "roofline",
           "choose_extent",
           "HWParams", "KernelSpec", "DAXPY", "DISPATCH_MODES", "SYNC_MODES",
           "BUFFERING_MODES", "OffloadEngine", "JobRecord", "steady_runtime",
           "steady_sweep", "fit_pipelined_from_engine", "OffloadTrace",
           "simulate_offload", "offload_runtime", "host_runtime", "speedup",
           "sweep", "OffloadModel", "PAPER_MODEL", "fit",
           "fit_from_simulator", "mape", "mape_by_n", "OffloadDecision",
           "m_min_for_deadline", "best_m", "should_offload", "breakeven_n"]
