"""Request-batching community-detection service (port of the repo's
``launch/community_serve.py``).

The single-graph drivers answer one graph per dispatch; serving traffic is
many small graphs arriving independently.  ``CommunityServeEngine`` is the
thin queueing layer that turns that traffic into the batched engine's
shape:

    submit() → admission control (bounded depth + estimated-cost budget,
               typed ``OverloadError`` sheds) → canonical ingest (per
               request, so a poisoned edge list is rejected/repaired BEFORE
               it can share a batch with clean traffic) → queue
    flush()  → group by (algo, capacity signature) → ``louvain_batch`` /
               ``plp_batch`` dispatch per group → unpack per-request
               responses with their ``RunReport`` and wall-clock latency

Batching changes throughput, never answers: every response is bit-identical
to running the single-graph driver on the same request (the batch engine's
parity contract).  On top of the batching, this layer keeps the service
HEALTHY under sustained faults (DESIGN.md §Resilience):

* **Deadlines** — a request may carry ``deadline_ms``; its batch dispatch
  runs under the watchdog (``utils.resilience.call_with_deadline``) with the
  tightest member budget.  A busted deadline fails ONLY the expired
  requests with a typed ``DeadlineError``; still-alive batch-mates are
  re-run sequentially under their own remaining budgets.
* **Backpressure** — the queue is bounded (``max_queue_depth`` requests and
  optionally ``max_queue_cost`` estimated padded-capacity units from
  ``capacity_signature``); ``submit`` sheds excess load immediately with a
  typed ``OverloadError`` response instead of growing silently.
* **Retries** — a transiently failed batch dispatch (``is_retryable`` over
  the error taxonomy) is retried with deterministic jittered backoff, never
  past the tightest member deadline.
* **Circuit breakers** — a signature bucket whose batched dispatches keep
  failing trips a per-(algo, signature) breaker: while open, new
  submissions for that signature are rejected at the door (no further
  breaker accounting) and already-queued members route around the batched
  path to the sequential ladder; after the reset window one half-open
  batched probe decides whether it closes.
* **Preemption** — a ``resilience.Preempted`` kill at the dispatch tick is
  absorbed by re-running the tick (the fault is an event, not a state);
  long cascades additionally resume from stage checkpoints when
  ``LouvainConfig.checkpoint_dir`` is set (``core.louvain``).

If a batch trips a non-retryable typed taxonomy error, the engine degrades
that ONE group to sequential single-graph runs so clean requests still get
answers and only the offending request carries the error — recorded in
``stats()["counters"]`` as ``serve.batch_fallback_sequential``.

Deliberately synchronous and in-process: flush() is the unit a real
transport (thread, asyncio loop, RPC server) would call on its batching
tick; the engine itself stays free of I/O so it can be tested and
benchmarked hermetically.  It serves on one device, resolved when it is
built (``device``: the card unless the caller names another; without a
card and without ``device="cpu"`` it raises there, not at the first
request).  Every request is ingested onto that device, and every run —
batched, or single-graph on the sequential ladder — takes the engine's
configs, backend included: nothing falls back to the CPU or to a plain
version.  ``python -m repro_torch.launch.community_serve --smoke
[--device cpu]`` drives a small end-to-end traffic sample under whatever
fault points ``REPRO_FAULTS`` arms.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

import torch

from repro_torch.core.batch import louvain_batch, plp_batch
from repro_torch.core.louvain import LouvainConfig, louvain
from repro_torch.core.plp import PLPConfig, plp
from repro_torch.graph.builders import from_numpy_edges_robust
from repro_torch.graph.structure import resolve_device
from repro_torch.kernels.common import capacity_signature
from repro_torch.utils import faultinject, resilience, telemetry
from repro_torch.utils.errors import (CommunityDetectionError, DeadlineError,
                                      OverloadError, RunReport)

ALGOS = ("louvain", "plp")


@dataclasses.dataclass
class CommunityRequest:
    """One graph to cluster: an undirected edge list + algorithm choice."""

    request_id: str
    u: np.ndarray
    v: np.ndarray
    w: Optional[np.ndarray] = None
    algo: str = "louvain"          # "louvain" | "plp"
    n: Optional[int] = None        # vertex count override (else max id + 1)
    deadline_ms: Optional[float] = None  # wall-clock budget from submit()


@dataclasses.dataclass
class CommunityResponse:
    """Per-request outcome, positionally independent of batch placement."""

    request_id: str
    ok: bool
    labels: Optional[np.ndarray] = None
    result: object = None          # LouvainResult | PLPResult when ok
    error: Optional[str] = None    # typed-taxonomy message when not ok
    repairs: dict = dataclasses.field(default_factory=dict)
    signature: Optional[tuple] = None
    latency_s: float = 0.0         # submit() → response unpack, wall clock
    batch_size: int = 0            # slots sharing this request's dispatch
    report: Optional[RunReport] = None  # failure-path RunReport (ok=False)


@dataclasses.dataclass
class _Queued:
    req: CommunityRequest
    graph: object
    repairs: dict
    t_submit: float
    seq: int
    deadline: Optional[resilience.Deadline] = None
    cost: int = 0


def _estimate_cost(req: CommunityRequest) -> int:
    """Admission-control cost of a request BEFORE ingest: the padded
    capacity units (n_cap + m_cap) its batch slot will occupy, from the
    same ``capacity_signature`` the flush-time bucketing uses."""
    m_est = 2 * int(len(req.u))
    if req.n is not None:
        n_est = int(req.n)
    elif len(req.u):
        n_est = int(max(np.max(req.u), np.max(req.v))) + 1
    else:
        n_est = 1
    sig = capacity_signature(max(n_est, 1), max(m_est, 1))
    return int(sig.n_cap) + int(sig.m_cap)


def _fail(q: _Queued, err_text: str, batch: int,
          warning: str) -> CommunityResponse:
    sig = (tuple(capacity_signature(q.graph.n_max, q.graph.m_max))
           if q.graph.n_max else None)
    return CommunityResponse(
        request_id=q.req.request_id, ok=False, error=err_text,
        repairs=q.repairs, signature=sig,
        latency_s=time.perf_counter() - q.t_submit, batch_size=batch,
        report=RunReport(warnings=[warning],
                         faults=sorted(faultinject.active())))


class CommunityServeEngine:
    """Queue → admit → bucket → batch-dispatch (deadline/retry/breaker
    guarded) → unpack (module docstring).

    ``max_batch`` caps the slot count of one dispatch (memory bound);
    larger groups are chunked.  ``max_queue_depth`` / ``max_queue_cost``
    bound the queue (requests / estimated padded-capacity units) —
    ``submit`` sheds the excess with typed ``OverloadError`` responses.
    ``max_retries`` transient-failure retries use jittered backoff seeded
    per dispatch (``backoff_base_s``).  ``breaker`` is injectable for
    deterministic tests (else a ``CircuitBreaker(breaker_threshold,
    breaker_reset_s)``).  ``ingest`` kwargs forward to
    ``from_numpy_edges_robust`` (e.g. ``bad_weights="drop"`` to repair
    rather than reject poisoned weights).  ``device`` is resolved here
    (``graph.structure.resolve_device``): the card unless named.

    Leave ``louvain_cfg.checkpoint_dir`` unset here: the stage-checkpoint
    directory is one-run-per-dir and sequential fallbacks would collide.
    """

    def __init__(self, louvain_cfg: Optional[LouvainConfig] = None,
                 plp_cfg: Optional[PLPConfig] = None, max_batch: int = 256,
                 max_queue_depth: int = 1024,
                 max_queue_cost: Optional[int] = None,
                 max_retries: int = 2, backoff_base_s: float = 0.05,
                 breaker_threshold: int = 3, breaker_reset_s: float = 30.0,
                 breaker: Optional[resilience.CircuitBreaker] = None,
                 device: Union[str, torch.device, None] = None,
                 **ingest):
        self.device = resolve_device(device)
        # default configs are built PER ENGINE (a shared default-argument
        # instance would leak config mutations across engines)
        self.louvain_cfg = (louvain_cfg if louvain_cfg is not None
                            else LouvainConfig())
        self.plp_cfg = plp_cfg if plp_cfg is not None else PLPConfig()
        self.max_batch = int(max_batch)
        self.max_queue_depth = int(max_queue_depth)
        self.max_queue_cost = (None if max_queue_cost is None
                               else int(max_queue_cost))
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.breaker = (breaker if breaker is not None
                        else resilience.CircuitBreaker(
                            threshold=breaker_threshold,
                            reset_after_s=breaker_reset_s, name="serve"))
        self.ingest = ingest
        self._queue: List[_Queued] = []
        self._queue_cost = 0
        self._rejects: List[Tuple[int, CommunityResponse]] = []
        self._seq = 0
        self._served = 0
        self._shed = 0
        self._dispatches = 0

    # ------------------------------------------------------------ submit

    def submit(self, req: CommunityRequest) -> Optional[CommunityResponse]:
        """Admit + validate + canonicalize one request onto the queue.

        Returns ``None`` when the request was accepted (its response comes
        back from the next ``flush()``, including typed ingest rejections).
        Returns an immediate ``ok=False`` response when admission control
        sheds it — queue at depth/cost bound, or the signature's circuit
        breaker is open — so the caller learns to back off NOW, without
        the shed load ever occupying queue memory.
        """
        if req.algo not in ALGOS:
            raise ValueError(f"unknown algo {req.algo!r}; choose {ALGOS}")
        t0 = time.perf_counter()

        if len(self._queue) >= self.max_queue_depth:
            return self._shed_response(req, t0, (
                f"queue depth {len(self._queue)} at bound "
                f"{self.max_queue_depth}"))
        cost = _estimate_cost(req)
        if (self.max_queue_cost is not None
                and self._queue_cost + cost > self.max_queue_cost):
            return self._shed_response(req, t0, (
                f"queued cost {self._queue_cost} + {cost} would bust bound "
                f"{self.max_queue_cost}"))

        self._seq += 1
        deadline = (resilience.Deadline(req.deadline_ms / 1000.0)
                    if req.deadline_ms is not None else None)
        try:
            g, rep = from_numpy_edges_robust(req.u, req.v, req.w, n=req.n,
                                             device=self.device,
                                             **self.ingest)
        except CommunityDetectionError as err:
            telemetry.bump("serve.ingest_reject")
            self._rejects.append((self._seq, CommunityResponse(
                request_id=req.request_id, ok=False,
                error=f"{type(err).__name__}: {err}",
                latency_s=time.perf_counter() - t0)))
            return None

        sig = (tuple(capacity_signature(g.n_max, g.m_max))
               if g.n_max else None)
        if self.breaker.state((req.algo, sig)) == "open":
            # reject at the door: a known-bad signature class must not
            # consume queue space or breaker accounting while open
            telemetry.bump("serve.breaker_reject")
            err = OverloadError(
                f"circuit breaker open for {(req.algo, sig)!r}; retry "
                f"after the reset window")
            return CommunityResponse(
                request_id=req.request_id, ok=False,
                error=f"OverloadError: {err}", signature=sig,
                latency_s=time.perf_counter() - t0)

        self._queue.append(
            _Queued(req, g, dataclasses.asdict(rep), t0, self._seq,
                    deadline=deadline, cost=cost))
        self._queue_cost += cost
        return None

    def _shed_response(self, req: CommunityRequest, t0: float,
                       why: str) -> CommunityResponse:
        self._shed += 1
        telemetry.bump("serve.shed")
        err = OverloadError(f"admission control shed {req.request_id!r}: "
                            f"{why}")
        return CommunityResponse(
            request_id=req.request_id, ok=False,
            error=f"OverloadError: {err}",
            latency_s=time.perf_counter() - t0)

    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------- flush

    def flush(self) -> List[CommunityResponse]:
        """Serve everything queued; responses in submit order."""
        queue, self._queue = self._queue, []
        self._queue_cost = 0
        rejects, self._rejects = self._rejects, []
        groups: Dict[Tuple, List[_Queued]] = {}
        for q in queue:
            sig = (tuple(capacity_signature(q.graph.n_max, q.graph.m_max))
                   if q.graph.n_max else None)
            groups.setdefault((q.req.algo, sig), []).append(q)

        tagged: List[Tuple[int, CommunityResponse]] = list(rejects)
        for key, members in groups.items():
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                tagged += zip((q.seq for q in chunk),
                              self._dispatch(key, chunk))
        tagged.sort(key=lambda t: t[0])   # submit order
        return [r for _, r in tagged]

    # ---------------------------------------------------------- dispatch

    def _dispatch(self, key: Tuple,
                  members: List[_Queued]) -> List[CommunityResponse]:
        algo = key[0]
        cfg = self.louvain_cfg if algo == "louvain" else self.plp_cfg
        self._dispatches += 1

        # requests that expired while queued fail BEFORE burning a dispatch
        expired: List[_Queued] = []
        alive: List[_Queued] = []
        for q in members:
            (expired if q.deadline is not None and q.deadline.expired
             else alive).append(q)
        out = [(q, DeadlineError(
            f"deadline expired while queued ({q.req.deadline_ms}ms)"))
            for q in expired]
        if expired:
            telemetry.bump("serve.deadline_expired_queued", len(expired))

        if alive:
            if self.breaker.state(key) == "open":
                # open breaker: route around the batched path entirely;
                # sequential outcomes are per-request and do NOT feed the
                # breaker (it re-evaluates only via the half-open probe)
                telemetry.bump("serve.breaker_routed_sequential")
                out += zip(alive, self._sequential(algo, cfg, alive))
            else:
                out += self._dispatch_batched(key, algo, cfg, alive)

        return [self._unpack(q, res, len(members)) for q, res in out]

    def _dispatch_batched(self, key, algo, cfg, alive):
        run_batch = louvain_batch if algo == "louvain" else plp_batch
        graphs = [q.graph for q in alive]
        try:
            results = self._run_with_retries(
                run_batch, graphs, cfg,
                lambda: resilience.min_remaining_s(
                    q.deadline for q in alive))
            self.breaker.record_success(key)
            return list(zip(alive, results))
        except DeadlineError as err:
            # the watchdog cancelled the batch: only requests whose budget
            # is actually spent fail; batch-mates re-run sequentially under
            # their own remaining budgets.  Not a breaker signal — the
            # budget was spent, the signature is not (known) poisoned.
            telemetry.bump("serve.batch_deadline_split")
            busted: List[_Queued] = []
            rest: List[_Queued] = []
            for q in alive:
                (busted if q.deadline is not None and q.deadline.expired
                 else rest).append(q)
            out = [(q, err) for q in busted]
            out += zip(rest, self._sequential(algo, cfg, rest))
            return out
        except CommunityDetectionError as err:
            # retry budget exhausted (or non-retryable): one poisoned slot
            # must not starve its batch-mates — degrade this group to
            # single-graph runs, isolating the error to the request that
            # owns it.  THIS is the breaker's signal: the batched path for
            # this signature failed outright.
            self.breaker.record_failure(key)
            telemetry.bump("serve.batch_fallback_sequential")
            return list(zip(alive, self._sequential(algo, cfg, alive)))

    def _run_with_retries(self, run_batch, graphs, cfg, deadline_s_fn):
        """One batched dispatch with preemption re-runs and jittered-backoff
        retries for transient failures, bounded by ``max_retries`` and the
        tightest member deadline."""
        delays = resilience.backoff_delays(
            self.max_retries, base_s=self.backoff_base_s,
            seed=self._dispatches)
        attempt = 0
        while True:
            try:
                if faultinject.consume("preempt_stage"):
                    raise resilience.Preempted(
                        "injected preemption at the serve dispatch tick")
                return run_batch(graphs, cfg, deadline_s=deadline_s_fn())
            except resilience.Preempted:
                # an event, not a state: the tick survives a kill by
                # re-running (bounded like any other retry, minus backoff)
                telemetry.bump("serve.preempt_rerun")
                attempt += 1
                if attempt > self.max_retries + 1:
                    raise CommunityDetectionError(
                        "dispatch tick preempted repeatedly; giving up")
            except Exception as err:  # noqa: BLE001 — taxonomy-routed below
                if attempt >= self.max_retries \
                        or not resilience.is_retryable(err):
                    raise
                delay = next(delays)
                rem = deadline_s_fn()
                if rem is not None and delay >= rem:
                    raise DeadlineError(
                        f"retry backoff ({delay:.3f}s) would bust the "
                        f"tightest member deadline ({rem:.3f}s remaining)"
                    ) from err
                telemetry.bump("serve.retry")
                telemetry.observe("serve.retry_backoff_s", delay)
                time.sleep(delay)
                attempt += 1

    def _sequential(self, algo, cfg, members):
        """Single-graph degradation path: each request under its OWN
        remaining deadline, errors isolated per request."""
        single = louvain if algo == "louvain" else plp
        results = []
        for q in members:
            budget = (q.deadline.remaining_s()
                      if q.deadline is not None else None)
            try:
                results.append(resilience.call_with_deadline(
                    lambda g=q.graph: single(g, cfg), budget))
            except CommunityDetectionError as err:
                results.append(err)
        return results

    def _unpack(self, q: _Queued, res, batch: int) -> CommunityResponse:
        if isinstance(res, CommunityDetectionError):
            kind = type(res).__name__
            return _fail(q, f"{kind}: {res}", batch,
                         warning=f"serve:{kind}:{q.req.request_id}")
        now = time.perf_counter()
        sig = (tuple(capacity_signature(q.graph.n_max, q.graph.m_max))
               if q.graph.n_max else None)
        self._served += 1
        return CommunityResponse(
            request_id=q.req.request_id, ok=True, labels=res.labels,
            result=res, repairs=q.repairs, signature=sig,
            latency_s=now - q.t_submit, batch_size=batch)

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Service + resilience observability.  The JAX package's
        ``programs`` entry (its compiled-program caches) has no counterpart:
        the port compiles no per-signature programs."""
        return {
            "pending": len(self._queue),
            "queued_cost": self._queue_cost,
            "served": self._served,
            "shed": self._shed,
            "dispatches": self._dispatches,
            "breakers": self.breaker.snapshot(),
            "counters": {k: v for k, v in telemetry.snapshot().items()
                         if k.startswith(("batch.", "serve.", "ladder.",
                                          "resilience.", "fault."))},
            "values": telemetry.values(),
        }


# ----------------------------------------------------------------- CLI smoke


def smoke_requests(n_requests: int, deadline_ms: Optional[float],
                   seed: int = 0) -> List[CommunityRequest]:
    """The smoke's traffic: two size classes (n = 96 and 24, m = 3n random
    id pairs, so two signature buckets), ``louvain`` when ``i % 3`` and
    ``plp`` otherwise, each with ``deadline_ms``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        n = 24 if i % 2 else 96
        m = 3 * n
        u = rng.integers(0, n, size=m).astype(np.int64)
        v = rng.integers(0, n, size=m).astype(np.int64)
        reqs.append(CommunityRequest(request_id=f"smoke-{i}", u=u, v=v,
                                     algo="louvain" if i % 3 else "plp",
                                     n=n, deadline_ms=deadline_ms))
    return reqs


def _smoke(n_requests: int, deadline_ms: Optional[float],
           seed: int = 0,
           device: Union[str, torch.device, None] = None) -> int:
    """End-to-end traffic sample: submit ``smoke_requests`` on ``device``,
    flush, and REQUIRE a typed response for every accepted request.  Armed
    fault points (``REPRO_FAULTS``) perturb the run; the contract is
    "never hang, never drop" — errors are acceptable, silence is not."""
    import json as _json

    eng = CommunityServeEngine(max_batch=8, max_retries=2,
                               backoff_base_s=0.01, device=device)
    accepted, shed = [], 0
    for req in smoke_requests(n_requests, deadline_ms, seed):
        resp = eng.submit(req)
        if resp is None:
            accepted.append(req.request_id)
        else:
            shed += 1
    responses = eng.flush()
    got = {r.request_id for r in responses}
    missing = [rid for rid in accepted if rid not in got]
    ok = sum(r.ok for r in responses)
    print(_json.dumps({
        "faults": sorted(faultinject.active()),
        "device": str(eng.device),
        "submitted": n_requests, "accepted": len(accepted), "shed": shed,
        "responses": len(responses), "ok": ok,
        "errors": sorted({r.error.split(":")[0] for r in responses
                          if r.error}),
        "missing": missing,
        "stats": {k: eng.stats()[k]
                  for k in ("served", "shed", "dispatches", "breakers")},
    }, default=str, indent=2))
    if missing:
        print(f"FATAL: {len(missing)} accepted request(s) got no response")
        return 1
    return 0


if __name__ == "__main__":
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run the end-to-end traffic sample and exit")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--deadline-ms", type=float, default=30000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="serve on this device (default: the card)")
    a = ap.parse_args()
    if not a.smoke:
        ap.error("this entrypoint only implements --smoke")
    sys.exit(_smoke(a.requests, a.deadline_ms, a.seed, a.device))
