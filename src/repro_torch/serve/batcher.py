"""The serving engine: prefill/decode steps over fixed request slots.

The port of ``ServingEngine`` and ``PendingStep`` from
``repro/serve/batcher.py``, with the same methods, arguments and return
values, so the reference ``ContinuousBatcher`` can drive it.  Each job is
the paper's offload round trip on the card: operands placed by the
multicast dispatcher (``DispatchStats`` seconds), the step launched, and
completion learned from the credit counter (``CreditCounterSync``).

Differences from the reference:
  * ``params=`` takes a port parameter tree (e.g. the reference's own,
    carried across by ``models.convert``); without it the parameters are
    drawn from a ``torch.Generator`` seeded with ``param_seed``;
  * ``device=`` selects the card (default ``"cuda"``) or the CPU;
  * caches are updated in place: a step's returned caches are the tensors
    it was given.  ``ContinuousBatcher`` chains each step on the caches
    the previous one returned, which in-place updates preserve.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dispatch import MulticastDispatcher
from repro_torch.core.sync import CreditCounterSync, FaultDetected
from repro_torch.launch.device import resolve_device
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_slot_prefill_step)
from repro_torch.models import init_cache, init_params, scaled_down


@dataclasses.dataclass
class PendingStep:
    """A launched-but-not-awaited engine step.

    PyTorch queues the step's kernels on the card's stream and returns;
    ``out`` holds its output tensors (including the credit scalar) and
    ``done`` an event recorded after its last kernel.  Blocking happens in
    ``ServingEngine.wait_step``.

    ``launch_s`` is the host time spent queueing the step's kernels.  In
    the reference one jitted call queues the whole step in microseconds;
    here every op is queued from Python, which takes as long as or longer
    than the card's work, so the credit wait alone would miss most of the
    step.
    """

    out: dict
    dispatch_s: float = 0.0        # measured operand-placement seconds
    launch_s: float = 0.0          # measured kernel-queueing seconds
    done: torch.cuda.Event | None = None


class ServingEngine:
    """Prefill/decode steps over ``max_batch`` request slots on one device."""

    def __init__(self, arch: str, *, reduced: bool = True, max_batch: int = 4,
                 max_len: int = 64, param_seed: int = 0,
                 fused_decode: bool = False, params=None,
                 device: str | torch.device = "cuda"):
        cfg = get_config(arch)
        if reduced:
            cfg = scaled_down(cfg)
        if cfg.frontend == "vision_patches":
            cfg = dataclasses.replace(cfg, frontend="")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        # Fused decode step: one kernel launch per attention layer instead
        # of separate rope/scatter/attend ops, the same tokens.
        self.fused_decode = fused_decode
        self.dispatcher = MulticastDispatcher()
        self.sync = CreditCounterSync()
        #: Credits read by the most recent completed step.
        self.last_credits: int | None = None
        self.params = (params if params is not None else
                       init_params(cfg, seed=param_seed, device=self.device))
        self._prefill = make_prefill_step(cfg, max_batch, max_len=max_len,
                                          device=self.device)
        self._slot_prefill = make_slot_prefill_step(
            cfg, max_batch, max_len=max_len, device=self.device)
        self._decode = make_decode_step(cfg, fused=fused_decode)

    def _launch(self, step, *args, dispatch_s: float = 0.0) -> PendingStep:
        """Queue ``step(*args)`` and time the queueing."""
        t0 = time.perf_counter()
        out = step(*args)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return PendingStep(out=out, dispatch_s=dispatch_s,
                           launch_s=time.perf_counter() - t0, done=done)

    def init_caches(self):
        """Fresh zeroed decode caches for the slot-managed serving loop."""
        return init_cache(self.cfg, self.max_batch, max_len=self.max_len,
                          device=self.device)

    def prefill(self, tokens: np.ndarray, metrics=None):
        """tokens (max_batch, L) int32 -> (next_token (B,), caches, wall_s).

        ``wall_s`` is the measured offload time of the step: the multicast
        placement seconds, the kernel-queueing seconds and the
        credit-counter blocking wait.
        """
        placed, dstats = self.dispatcher.timed_put(
            np.asarray(tokens, np.int32), self.device)
        if metrics is not None:
            metrics.record_dispatch(dstats)
        return self.wait_step(self._launch(
            self._prefill, self.params, {"tokens": placed},
            dispatch_s=dstats.seconds))

    def prefill_into_slots_async(self, tokens: np.ndarray, caches,
                                 slot_mask: np.ndarray,
                                 metrics=None) -> PendingStep:
        """Launch a prefill-into-slots step without blocking on it."""
        placed, dstats = self.dispatcher.timed_put(
            np.asarray(tokens, np.int32), self.device)
        if metrics is not None:
            metrics.record_dispatch(dstats)
        mask = torch.as_tensor(np.asarray(slot_mask, bool), device=self.device)
        return self._launch(self._slot_prefill, self.params,
                            {"tokens": placed}, caches, mask,
                            dispatch_s=dstats.seconds)

    def prefill_into_slots(self, tokens: np.ndarray, caches,
                           slot_mask: np.ndarray, metrics=None):
        """Prefill the ``slot_mask`` rows of ``tokens`` into live ``caches``;
        returns (next_token (B,), caches, wall_s) like :meth:`prefill`."""
        return self.wait_step(
            self.prefill_into_slots_async(tokens, caches, slot_mask, metrics))

    def warmup(self, prompt_lens, *, slots: bool = False) -> None:
        """Run every prompt-length bucket (and the decode step) once.

        On the card the first call of each shape pays one-time costs (the
        kernel build, cuBLAS handles and heuristics); a wall-clock
        calibration should not see them.  Decoding zero tokens may give
        non-finite logits, so a fault here is ignored.
        """
        for length in sorted(set(prompt_lens)):
            tokens = np.zeros((self.max_batch, length), np.int32)
            if slots:
                caches = self.init_caches()
                mask = np.zeros(self.max_batch, bool)
                mask[0] = True
                _, caches, _ = self.prefill_into_slots(tokens, caches, mask)
            else:
                _, caches, _ = self.prefill(tokens)
            tok = np.zeros((self.max_batch, 1), np.int32)
            try:
                self.decode(tok, caches, length)
            except FaultDetected:  # pragma: no cover - warmup is best-effort
                pass

    def decode_async(self, tok: np.ndarray, caches, lens) -> PendingStep:
        """Launch one decode step without blocking on its completion."""
        lens = np.asarray(lens, np.int32)
        if lens.ndim == 0:
            lens = np.full((self.max_batch,), int(lens), np.int32)
        tok_t = torch.as_tensor(np.asarray(tok, np.int32), device=self.device)
        lens_t = torch.as_tensor(lens, device=self.device)
        return self._launch(self._decode, self.params, tok_t, caches, lens_t)

    def decode(self, tok: np.ndarray, caches, lens):
        """tok (max_batch, 1) int32 -> (next_token (B,), caches, wall_s).

        ``lens`` is the per-slot cache length — an int or a (max_batch,)
        vector.  ``wall_s`` is the kernel-queueing seconds plus the
        credit-counter blocking wait.
        """
        return self.wait_step(self.decode_async(tok, caches, lens))

    def step_ready(self, pending: PendingStep) -> bool:
        """Non-blocking completion probe of a launched step."""
        if pending.done is None:
            return True   # CPU ops run to completion before they return
        return pending.done.query()

    def wait_step(self, pending: PendingStep):
        """Block on a launched step; returns (next_token, caches, wall_s).

        ``wall_s`` is the dispatch seconds (when the step placed operands),
        the kernel-queueing seconds and the residual blocking wait on the
        credit scalar.
        """
        got, wait_s = self.sync.timed_wait(pending.out["credits"])
        self.last_credits = got
        return (pending.out["next_token"].cpu().numpy(),
                pending.out["caches"],
                pending.dispatch_s + pending.launch_s + wait_s)
