"""Trace-driven workload families for the serving subsystem.

A copy of ``repro/serve/workload.py``; its results are bit-identical to the
reference's on the same inputs.

Open-loop means arrivals are independent of service: bursts queue up exactly
as they would under real traffic.  The original generator was a single
Poisson stream; the ``Workload`` hierarchy keeps that member bit-identical
(``PoissonWorkload`` reproduces the historical draw order exactly) and adds
the traffic shapes production serving actually sees (ROADMAP item 3):

  * **arrival processes** — ``poisson`` (memoryless), ``gamma`` (renewal
    process with a coefficient of variation > 1: diurnal-ish clumping), and
    ``mmpp`` (Markov-modulated Poisson: an ON/OFF burst state modulates the
    instantaneous rate; the state chain runs on its own ``derive_seed`` child
    stream so toggles never perturb the arrival draws);
  * **length distributions** — the historical discrete ``choice`` mix, plus
    heavy-tail ``lognormal`` and ``zipf`` prompt/output lengths (clipped to
    the spec's maxima so engine sizing is unaffected);
  * **multi-turn sessions** — a session is a sequence of ``turns`` requests
    with uniform think-time gaps; every turn carries the session's prefix id
    and the cumulative context length (``prefix_len``) a warm KV cache could
    skip (DESIGN.md §13);
  * **per-tenant SLO classes** — sessions belong to tenants; each tenant
    maps onto a :class:`TenantClass` (premium/standard/batch) that sets the
    queue priority and scales the Eq.-3 deadline sampling.

Deadlines are sampled *model-aware*: for a target parallel extent M drawn
from the available cluster configurations, the deadline is set a bit above
t̂(M, N) — so meeting it genuinely requires allocating ≳ M clusters, and the
scheduler's choices spread over the whole M grid (which is also what gives
the online calibrator a well-conditioned (1, N, N/M) design matrix).  A
second fraction of requests gets an *infeasible* deadline (below the serial
floor alpha + beta*N) to exercise admission control.

``WorkloadSpec.build()`` is the entry point; ``synthetic_workload`` is the
deprecated PR 1–9 alias.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.core.runtime_model import OffloadModel, PAPER_MODEL

from .queue import Request

#: Cycles per virtual second at the paper's 1 GHz clock (cycles == ns).
CYCLES_PER_SECOND = 1e9

#: Arrival-process families (``WorkloadSpec.arrival``).
ARRIVALS = ("poisson", "gamma", "mmpp")
#: Length-distribution families (``WorkloadSpec.length_dist``).
LENGTH_DISTS = ("choice", "lognormal", "zipf")


def derive_seed(seed: int, label: str) -> int:
    """Deterministic child seed for a named serving subsystem.

    One workload seed fans out to every stochastic subsystem of a run — the
    fault schedule, the router's tie-break stream, per-lane fabric jitter —
    through independent, label-keyed child streams:
    ``SeedSequence([seed, crc32(label)])``.  Same (seed, label) -> same
    stream, different labels -> uncorrelated streams, so the whole
    fault-tolerance A/B is reproducible run-to-run from a single ``--seed``
    (asserted in tests/test_fault.py).
    """
    import zlib
    return int(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, zlib.crc32(label.encode())]
    ).generate_state(1)[0])


@dataclass(frozen=True)
class TenantClass:
    """One tenant SLO class: queue priority + deadline-sampling knobs.

    ``priority`` orders admission under overload (0 = most important).
    ``slo_fraction`` overrides the spec-level fraction when not None (premium
    traffic always carries deadlines, batch never does); ``slack_scale``
    multiplies the sampled Eq.-3 slack (premium deadlines are tighter).
    """
    name: str
    priority: int
    slo_fraction: float | None = None
    slack_scale: float = 1.0


#: The built-in tenant SLO classes (``WorkloadSpec.tenant_classes`` names).
TENANT_CLASSES: dict[str, TenantClass] = {
    "premium": TenantClass("premium", priority=0, slo_fraction=1.0,
                           slack_scale=1.0),
    "standard": TenantClass("standard", priority=1),
    "batch": TenantClass("batch", priority=2, slo_fraction=0.0),
}


@dataclass(frozen=True)
class WorkloadSpec:
    num_requests: int = 64
    rate_rps: float = 400_000.0        # open-loop arrival rate (requests/s)
    prompt_lens: tuple[int, ...] = (256, 512, 768, 1024)
    gen_lens: tuple[int, ...] = (4, 8, 16)
    slo_fraction: float = 0.7          # fraction carrying an Eq.-3 deadline
    infeasible_fraction: float = 0.1   # of those, deliberately infeasible
    slack_factor: tuple[float, float] = (1.02, 1.25)  # deadline / t̂(M_target)
    m_grid: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    vocab_size: int = 128              # prompt token id range
    seed: int = 0
    # --- workload family (defaults reproduce the PR 1–9 Poisson stream) ---
    arrival: str = "poisson"           # one of ARRIVALS
    cv: float = 3.0                    # gamma inter-arrival coeff. of variation
    mmpp_burst: float = 8.0            # ON-state rate multiplier vs OFF state
    mmpp_duty: float = 0.2             # stationary fraction of ON arrivals
    mmpp_burst_len: float = 16.0       # mean ON-state sojourn, in arrivals
    length_dist: str = "choice"        # one of LENGTH_DISTS
    length_sigma: float = 0.6          # lognormal sigma (log-space)
    zipf_a: float = 1.5                # zipf exponent over the length mixes
    turns: int = 1                     # requests per session (1 = no sessions)
    think_time_s: tuple[float, float] = (0.0, 0.0)  # uniform turn gap (s)
    tenants: int = 1                   # tenants sharing the trace
    tenant_classes: tuple[str, ...] = ("standard",)  # tenant -> class, cycled

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}, "
                             f"got {self.arrival!r}")
        if self.length_dist not in LENGTH_DISTS:
            raise ValueError(f"length_dist must be one of {LENGTH_DISTS}, "
                             f"got {self.length_dist!r}")
        if self.turns < 1:
            raise ValueError("turns must be >= 1")
        if self.tenants < 1:
            raise ValueError("tenants must be >= 1")
        for name in self.tenant_classes:
            if name not in TENANT_CLASSES:
                raise ValueError(f"unknown tenant class {name!r}; known: "
                                 f"{sorted(TENANT_CLASSES)}")

    def build(self, *, model: OffloadModel = PAPER_MODEL,
              with_tokens: bool = True) -> list[Request]:
        """Generate the request trace (deterministic per seed)."""
        return workload_for(self).generate(model=model,
                                           with_tokens=with_tokens)


class Workload:
    """Base of the workload family: a seeded request-trace generator.

    Subclasses override :meth:`inter_arrivals` (session-start gaps, in
    virtual seconds).  :meth:`generate` owns everything else — sessions,
    tenants, lengths, deadlines, tokens — in a single fixed draw order so
    the default spec reproduces the historical Poisson trace bit-for-bit
    (tested in tests/test_workload.py).
    """

    kind = "base"

    def __init__(self, spec: WorkloadSpec):
        self.spec = spec

    def inter_arrivals(self, rng: np.random.Generator,
                       size: int) -> np.ndarray:
        raise NotImplementedError

    # --- length draws ------------------------------------------------------
    def _draw_len(self, rng: np.random.Generator,
                  mix: tuple[int, ...]) -> int:
        spec = self.spec
        if spec.length_dist == "choice":
            return int(rng.choice(mix))
        if spec.length_dist == "lognormal":
            median = float(np.median(mix))
            draw = rng.lognormal(math.log(median), spec.length_sigma)
            return int(np.clip(round(draw), 1, max(mix)))
        # zipf over the discrete mix, shortest lengths most probable.
        lens = sorted(mix)
        w = np.array([1.0 / (r + 1) ** spec.zipf_a
                      for r in range(len(lens))])
        return int(rng.choice(lens, p=w / w.sum()))

    # --- the one trace generator ------------------------------------------
    def generate(self, *, model: OffloadModel = PAPER_MODEL,
                 with_tokens: bool = True) -> list[Request]:
        spec = self.spec
        rng = np.random.default_rng(spec.seed)
        turns = spec.turns
        n_sessions = math.ceil(spec.num_requests / turns)

        # 1. Session-start arrivals.  For turns == 1 this is exactly the
        #    historical per-request arrival batch (same draw, same rng).
        inter = self.inter_arrivals(rng, n_sessions)
        starts = np.cumsum(inter) * CYCLES_PER_SECOND

        # 2. Turn schedule: think-time gaps only exist for turns > 1, so a
        #    single-turn trace consumes no extra rng state (the zero-think
        #    identity property relies on this).
        entries: list[tuple[float, int, int]] = []   # (arrival, session, turn)
        lo, hi = spec.think_time_s
        remaining = spec.num_requests
        for s in range(n_sessions):
            n_turns = min(turns, remaining)
            remaining -= n_turns
            t = float(starts[s])
            for k in range(n_turns):
                entries.append((t, s, k))
                if k + 1 < n_turns:
                    t += float(rng.uniform(lo, hi)) * CYCLES_PER_SECOND
        entries.sort()

        # 3. Tenants: sessions are assigned uniformly; a single-tenant spec
        #    draws nothing.  The class mapping is deterministic (cycled).
        if spec.tenants > 1:
            tenant_of = rng.integers(0, spec.tenants, size=n_sessions)
        else:
            tenant_of = np.zeros(n_sessions, dtype=np.int64)
        classes = spec.tenant_classes

        # 4. Per-request attributes, in arrival order (== rid order).  The
        #    draw sequence inside the loop matches the historical generator
        #    exactly when the defaults are in effect.
        sessions_on = turns > 1
        tenants_on = spec.tenants > 1 or classes != ("standard",)
        ctx_len: dict[int, int] = {}
        reqs: list[Request] = []
        for rid, (arrival, s, k) in enumerate(entries):
            tenant = int(tenant_of[s])
            cls = TENANT_CLASSES[classes[tenant % len(classes)]]
            n_new = self._draw_len(rng, spec.prompt_lens)
            gen = self._draw_len(rng, spec.gen_lens)
            # A later turn's prompt is cumulative: the conversation context
            # is re-sent, so an affinity-less server re-prefills all of it
            # while a warm KV hit skips the ``prefix_len`` resident tokens
            # (DESIGN.md §13).  Single-turn traces have prefix == 0 and are
            # bit-identical to the historical generator.
            prefix = ctx_len.get(s, 0) if sessions_on else 0
            n = prefix + n_new
            slo = None
            slo_fraction = (spec.slo_fraction if cls.slo_fraction is None
                            else cls.slo_fraction)
            if rng.random() < slo_fraction:
                serial_floor = model.alpha + model.beta * n
                if rng.random() < spec.infeasible_fraction:
                    # Below the serial floor: no M can meet it (Eq. 3
                    # slack <= 0).
                    slo = serial_floor * float(rng.uniform(0.5, 0.95))
                else:
                    m_target = int(rng.choice(spec.m_grid))
                    slack = float(rng.uniform(*spec.slack_factor))
                    slo = (float(model.predict(m_target, n)) * slack
                           * cls.slack_scale)
            tokens = None
            if with_tokens:
                tokens = rng.integers(0, spec.vocab_size, size=(n,),
                                      dtype=np.int32)
            req = Request(rid=rid, arrival=float(arrival), prompt_len=n,
                          gen_len=gen, slo_cycles=slo, tokens=tokens)
            if sessions_on:
                req.session = s
                req.turn = k
                req.prefix_id = s
                req.prefix_len = prefix
                ctx_len[s] = n + gen
            if tenants_on:
                req.tenant = tenant
                req.priority = cls.priority
            reqs.append(req)
        return reqs


class PoissonWorkload(Workload):
    """The historical open-loop Poisson stream (bit-identical member)."""

    kind = "poisson"

    def inter_arrivals(self, rng, size):
        return rng.exponential(1.0 / self.spec.rate_rps, size=size)


class GammaWorkload(Workload):
    """Gamma-renewal arrivals: same mean rate, CV > 1 clumps the trace."""

    kind = "gamma"

    def inter_arrivals(self, rng, size):
        cv2 = self.spec.cv ** 2
        # shape k = 1/CV^2, scale = CV^2/rate: mean 1/rate, variance CV^2x.
        return rng.gamma(1.0 / cv2, cv2 / self.spec.rate_rps, size=size)


class MMPPWorkload(Workload):
    """Markov-modulated Poisson arrivals: ON/OFF bursts around the mean rate.

    The two-state chain is embedded at arrival epochs: each arrival draws an
    exponential gap at the current state's rate, then toggles state with the
    transition probabilities implied by ``mmpp_duty`` / ``mmpp_burst_len``.
    Rates are normalized so the *stationary* mean equals ``rate_rps`` — the
    trace is burstier, not heavier.  The state chain runs on a
    ``derive_seed`` child stream so toggles never perturb the gap draws
    (same seed => comparable arrival randomness across families).
    """

    kind = "mmpp"

    def inter_arrivals(self, rng, size):
        spec = self.spec
        d = min(max(spec.mmpp_duty, 1e-6), 1 - 1e-6)
        # The chain is embedded at arrival epochs, so the stationary mean
        # gap is the *arrival*-weighted mixture d/rate_on + (1-d)/rate_off;
        # solve that for 1/rate_rps (a time-weighted mixture would land at
        # roughly half the spec'd rate at the default duty).
        rate_off = spec.rate_rps * (1.0 - d + d / spec.mmpp_burst)
        rate_on = spec.mmpp_burst * rate_off
        q_off = 1.0 / max(spec.mmpp_burst_len, 1.0)   # ON -> OFF per arrival
        q_on = d * q_off / (1.0 - d)                  # OFF -> ON per arrival
        state_rng = np.random.default_rng(
            derive_seed(spec.seed, f"mmpp-states:{self.kind}"))
        on = state_rng.random() < d                   # stationary start
        gaps = np.empty(size)
        for i in range(size):
            gaps[i] = rng.exponential(1.0 / (rate_on if on else rate_off))
            if state_rng.random() < (q_off if on else q_on):
                on = not on
        return gaps


#: Registry: ``WorkloadSpec.arrival`` -> family class.
WORKLOADS: dict[str, type[Workload]] = {
    "poisson": PoissonWorkload,
    "gamma": GammaWorkload,
    "mmpp": MMPPWorkload,
}


def workload_for(spec: WorkloadSpec) -> Workload:
    """Instantiate the workload family the spec names."""
    return WORKLOADS[spec.arrival](spec)


def synthetic_workload(
    spec: WorkloadSpec = WorkloadSpec(),
    *,
    model: OffloadModel = PAPER_MODEL,
    with_tokens: bool = True,
) -> list[Request]:
    """Deprecated alias of :meth:`WorkloadSpec.build` (the PR 1–9 API)."""
    warnings.warn("synthetic_workload() is deprecated; use "
                  "WorkloadSpec.build()", DeprecationWarning, stacklevel=2)
    return spec.build(model=model, with_tokens=with_tokens)
