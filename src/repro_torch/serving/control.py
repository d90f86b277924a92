"""Self-tuning serving control plane: the loops that close the knobs.

`serving/frontend.py` has three static knobs — the micro-batch window,
the queue bound, and the least-in-flight replica policy — and the load
curves in BENCH_query_engine.json show the right settings move with
offered load. The three controllers here replace hand-tuning with
feedback from `serving/telemetry.py` observations:

  * `BatchController` — sets the micro-batch window each time a batch
    opens, from the observed queue depth, the arrival rate (EWMA over
    inter-arrival gaps) and a fitted service-time model S(b) = a + c·b
    (batches share fixed round cost `a`; each extra member adds `c`).
    It scores a small grid of candidate windows with a queueing model
    of the frontend itself — expected fill, batch service, and an
    instability penalty when a window cannot sustain the offered rate —
    and picks the argmin. A Little's-law bound caps the window: with
    `depth` waiting and arrival rate λ, expected queue wait is
    W = depth/λ (Little's law), so any window beyond
    `target_p99_s − W − S_p99` would blow the latency target and is
    clipped.
  * `DeadlineShedder` — admission control by *predicted* deadline miss,
    not queue depth alone: a request is rejected at the door iff
    `now + queue-wait estimate + service-time quantile` exceeds its
    deadline. The wait estimate is `(batches ahead of it) × S_q`; the
    service quantile comes from the same windowed histograms, so the
    shedder adapts as the cluster speeds up or slows down. Rejection
    raises `PredictedDeadlineMiss`, a subclass of the frontend's
    `DeadlineExceeded`, so callers' existing handlers keep working.
  * `PowerOfTwoChoices` — replica picking for *multiple* uncoordinated
    frontends. Deterministic least-loaded herds: every process reads
    the same gauges, picks the same "least" replica, and stampedes it
    until the gauges catch up. Sampling two random replicas and taking
    the less loaded breaks the symmetry with no shared state — the
    classic balls-into-bins result bounds the max/mean load gap — while
    still steering away from slow replicas because in-flight gauges ARE
    the latency signal (slow replica ⇒ requests pile up ⇒ higher gauge).

Controllers subscribe to the `GenerationBus` (`follow`): a generation
swap changes the service-time profile (new segment set, new shard
layout), so fitted state is reset while arrival-rate state — a property
of the traffic, not the index — is kept.

Everything here is deliberately clock-agnostic: callers pass `now`
explicitly, so the same controller instance drives the real threaded
`Frontend` (wall clock) and the virtual-clock load generator
(benchmarks/serving_tier.py) identically — which is how the benchmark's
adaptive-vs-static comparison can be trusted.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..analysis.locks import OrderedLock
from .frontend import DeadlineExceeded
from .telemetry import Telemetry, WindowedHistogram


class PredictedDeadlineMiss(DeadlineExceeded):
    """Shed at admission: the predicted completion misses the deadline.

    Carries the prediction so callers (and the shed-precision
    benchmark) can see *why* the request was refused."""

    def __init__(self, predicted_completion_s: float,
                 deadline_s: float) -> None:
        super().__init__(
            f"predicted completion {predicted_completion_s:.3f}s exceeds "
            f"deadline {deadline_s:.3f}s; shedding at admission")
        self.predicted_completion_s = predicted_completion_s
        self.deadline_s = deadline_s


# --------------------------------------------------------------- controllers
@dataclass(frozen=True)
class ControlConfig:
    """Knobs of the knob-remover (all have serving-scale defaults).

    `target_p99_s=None` means "minimize predicted latency"; a number
    makes the Little's-law clamp hard: the window never knowingly
    schedules past the target."""

    max_window_s: float = 0.05       # never wait longer than this
    n_candidates: int = 8            # window grid resolution
    target_p99_s: float | None = None
    ewma_alpha: float = 0.2          # arrival-gap smoothing
    hist_window: int = 128           # service histogram size
    min_samples: int = 6             # observations before trusting fit
    initial_window_s: float = 0.0    # pre-data fallback (static default)
    fit_decay: float = 0.98          # per-observation decay of S(b) fit
    overload_penalty_s: float | None = None  # None -> 8x fitted service


class BatchController:
    """Little's-law micro-batch window control.

    Feed it `on_arrival(now)` at every admission and
    `on_batch(service_s, batch_size)` after every dispatch; ask it
    `window(depth, now)` each time a batch opens. Thread-safe: the
    threaded frontend calls `on_arrival` from submitters and `window`
    from the batching loop concurrently.
    """

    def __init__(self, max_batch: int = 16,
                 config: ControlConfig | None = None,
                 telemetry: Telemetry | None = None) -> None:
        self.max_batch = max_batch
        self.config = config or ControlConfig()
        self._lock = OrderedLock("control.controller")
        # arrival process: EWMA of inter-arrival gaps -> rate estimate
        self._gap_ewma: float | None = None
        self._last_arrival: float | None = None
        # service process: decayed least-squares fit of S(b) = a + c*b
        self._n = 0.0
        self._sb = 0.0
        self._sb2 = 0.0
        self._ss = 0.0
        self._sbs = 0.0
        self._n_obs = 0
        self._service = WindowedHistogram(self.config.hist_window)
        self._subscription = None
        self.n_generation_resets = 0
        self._telemetry = telemetry
        if telemetry is not None:
            self._g_window = telemetry.gauge("control.window_s")
            self._g_rate = telemetry.gauge("control.arrival_rate_qps")
        else:
            self._g_window = self._g_rate = None

    # -- observations -----------------------------------------------------
    def on_arrival(self, now: float) -> None:
        a = self.config.ewma_alpha
        with self._lock:
            if self._last_arrival is not None:
                gap = max(now - self._last_arrival, 1e-9)
                self._gap_ewma = gap if self._gap_ewma is None \
                    else (1.0 - a) * self._gap_ewma + a * gap
            self._last_arrival = now
        if self._g_rate is not None:
            self._g_rate.set(self.arrival_rate())

    def on_batch(self, service_s: float, batch_size: int) -> None:
        if batch_size <= 0:
            return
        d = self.config.fit_decay
        with self._lock:
            self._n = self._n * d + 1.0
            self._sb = self._sb * d + batch_size
            self._sb2 = self._sb2 * d + batch_size * batch_size
            self._ss = self._ss * d + service_s
            self._sbs = self._sbs * d + batch_size * service_s
            self._n_obs += 1
        self._service.observe(service_s)

    # -- estimates --------------------------------------------------------
    def arrival_rate(self) -> float:
        """Requests/s EWMA; 0.0 until two arrivals have been seen."""
        gap = self._gap_ewma
        return 0.0 if not gap else 1.0 / gap

    def _fit(self) -> tuple[float, float]:
        """(a, c) of S(b) = a + c*b; falls back to (mean, 0) while the
        observed batch sizes are degenerate (all equal)."""
        n, sb, sb2, ss, sbs = (self._n, self._sb, self._sb2,
                               self._ss, self._sbs)
        if n <= 0.0:
            return 0.0, 0.0
        det = n * sb2 - sb * sb
        mean = ss / n
        if det <= 1e-12 * max(1.0, sb2):
            return mean, 0.0
        c = (n * sbs - sb * ss) / det
        a = (ss - c * sb) / n
        if c < 0.0:       # noisy fit claiming batching is free: distrust
            return mean, 0.0
        return max(a, 0.0), c

    def predict_service(self, batch_size: int) -> float:
        with self._lock:
            a, c = self._fit()
        return max(a + c * max(batch_size, 1), 1e-9)

    def service_quantile(self, q: float) -> float:
        return self._service.quantile(q)

    @property
    def n_observations(self) -> int:
        return self._n_obs

    # -- the control law --------------------------------------------------
    def window(self, depth: int, now: float | None = None) -> float:
        """Micro-batch window for the batch opening now, given `depth`
        requests already waiting."""
        del now  # the law is state-based; `now` kept for signature parity
        cfg = self.config
        if depth >= self.max_batch:
            w = 0.0                      # backlog already fills the batch
        elif self._n_obs < cfg.min_samples:
            w = min(cfg.initial_window_s, cfg.max_window_s)
        else:
            w = self._choose(depth)
        if self._g_window is not None:
            self._g_window.set(w)
        return w

    def _choose(self, depth: int) -> float:
        cfg = self.config
        lam = self.arrival_rate()
        with self._lock:
            a, c = self._fit()
        s_p99 = self.service_quantile(0.99)

        # Little's law: with `depth` in queue at rate lam the expected
        # wait already accrued is W = L/lam; whatever p99 headroom
        # remains after W and the service tail is the most window we
        # may add before knowingly scheduling past the target.
        w_cap = cfg.max_window_s
        if cfg.target_p99_s is not None:
            w_little = depth / lam if lam > 0.0 else 0.0
            w_cap = min(w_cap,
                        max(0.0, cfg.target_p99_s - w_little - s_p99))

        def service(b: float) -> float:
            return max(a + c * max(b, 1.0), 1e-9)

        penalty_s = cfg.overload_penalty_s
        if penalty_s is None:
            penalty_s = 8.0 * service(self.max_batch)

        best_w, best_score = 0.0, float("inf")
        n = max(cfg.n_candidates, 2)
        for i in range(n):
            w = w_cap * i / (n - 1)
            # expected batch: what waits now + what the window collects,
            # then (busy regime) what a full service cycle collects —
            # a 3-step fixed point of b = min(B, depth + lam*(w + S(b)))
            b = max(1.0, depth + lam * w)
            for _ in range(3):
                cycle = w + service(min(b, self.max_batch))
                b_busy = depth + lam * cycle
                b = max(1.0, min(b_busy, float(self.max_batch)))
            t = service(b)
            thr = b / (w + t)            # sustainable requests/s at w
            # waiters pay the whole window, window joiners half of it
            fill = min(lam * w, max(b - depth, 0.0))
            members = max(depth + fill, 1.0)
            wait = (depth * w + fill * 0.5 * w) / members
            score = wait + t + max(0.0, lam - thr) * penalty_s
            if score < best_score - 1e-12:
                best_w, best_score = w, score
        return best_w

    # -- generation swaps -------------------------------------------------
    def follow(self, bus) -> "BatchController":
        """Reset the fitted service model on generation swaps (a new
        segment set or shard layout changes the cost of a round); the
        arrival-rate estimate is traffic, not index, so it is kept."""
        self._subscription = bus.subscribe(self._on_generation)
        return self

    def _on_generation(self, _event) -> None:
        with self._lock:
            self._n = self._sb = self._sb2 = self._ss = self._sbs = 0.0
            self._n_obs = 0
        self._service = WindowedHistogram(self.config.hist_window)
        self.n_generation_resets += 1

    def close(self) -> None:
        if self._subscription is not None:
            self._subscription.cancel()
            self._subscription = None


class DeadlineShedder:
    """Admission control by predicted completion, not queue depth.

    `admit(now, deadline, depth)` raises `PredictedDeadlineMiss` when
    `now + (batches ahead + 1) * S_q + margin` exceeds the deadline —
    i.e. when, at the service times we are *currently observing*, the
    request would queue past its deadline and waste a fetch round on an
    answer nobody is waiting for. Requests without deadlines are always
    admitted; so is everything until `min_samples` batches have been
    observed (no data, no predictions, no false sheds).
    """

    def __init__(self, max_batch: int = 16, quantile: float = 0.9,
                 margin_s: float = 0.0, min_samples: int = 6,
                 hist_window: int = 128,
                 telemetry: Telemetry | None = None) -> None:
        self.max_batch = max_batch
        self.quantile = quantile
        self.margin_s = margin_s
        self.min_samples = min_samples
        self._service = WindowedHistogram(hist_window)
        self._n_obs = 0
        self.n_evaluated = 0
        self.n_shed = 0
        self._telemetry = telemetry
        self._c_shed = (telemetry.counter("shed.predicted_miss")
                        if telemetry is not None else None)
        self._subscription = None

    def on_batch(self, service_s: float, batch_size: int) -> None:
        if batch_size <= 0:
            return
        self._service.observe(service_s)
        self._n_obs += 1

    def follow(self, bus) -> "DeadlineShedder":
        """Generation swaps change service times; forget the old ones
        (predictions pause until `min_samples` fresh batches arrive)."""
        self._subscription = bus.subscribe(self._on_generation)
        return self

    def _on_generation(self, _event) -> None:
        self._service = WindowedHistogram(self._service._window)
        self._n_obs = 0

    def close(self) -> None:
        if self._subscription is not None:
            self._subscription.cancel()
            self._subscription = None

    def predicted_completion(self, now: float, depth: int) -> float:
        """Completion estimate for a request admitted at `now` with
        `depth` already queued ahead of it: it waits out the batches in
        front (depth // max_batch full rounds), then its own round."""
        s_q = self._service.quantile(self.quantile)
        rounds = depth // self.max_batch + 1
        return now + rounds * s_q + self.margin_s

    def admit(self, now: float, deadline: float | None,
              depth: int) -> None:
        """Raise `PredictedDeadlineMiss` iff the prediction misses."""
        if deadline is None or self._n_obs < self.min_samples:
            return
        self.n_evaluated += 1
        predicted = self.predicted_completion(now, depth)
        if predicted > deadline:
            self.n_shed += 1
            if self._c_shed is not None:
                self._c_shed.inc()
            raise PredictedDeadlineMiss(predicted, deadline)


# ------------------------------------------------------------ replica policy
class LeastLoaded:
    """Deterministic argmin picker — the pre-control-plane behaviour.

    Optimal for ONE frontend with perfect local gauges; herds when
    several frontends share the view (they all pick the same replica)."""

    def pick(self, loads, exclude: int | None = None) -> int:
        best, best_load = -1, float("inf")
        for i, load in enumerate(loads):
            if i == exclude:
                continue
            if load < best_load:
                best, best_load = i, load
        if best < 0:
            raise ValueError("no replica to pick from")
        return best


class PowerOfTwoChoices:
    """Sample two distinct replicas, take the less loaded (ties to the
    lower index). With d=2 choices the classic balls-into-bins bound
    keeps the max load within O(log log n) of the mean even when many
    frontends pick concurrently from *stale* gauges — randomization is
    what prevents the synchronized-herd failure of `LeastLoaded`, and
    it needs no coordination between processes whatsoever."""

    def __init__(self, seed: int | None = None) -> None:
        self._rng = random.Random(seed)

    def pick(self, loads, exclude: int | None = None) -> int:
        cand = [i for i in range(len(loads)) if i != exclude]
        if not cand:
            raise ValueError("no replica to pick from")
        if len(cand) == 1:
            return cand[0]
        i, j = self._rng.sample(cand, 2)
        if loads[i] < loads[j]:
            return i
        if loads[j] < loads[i]:
            return j
        return min(i, j)


def as_picker(picker) -> object:
    """Normalize a picker argument: None -> LeastLoaded (back-compat),
    "p2c"/"least_loaded" by name, or any object with `.pick`."""
    if picker is None or picker == "least_loaded":
        return LeastLoaded()
    if picker == "p2c":
        return PowerOfTwoChoices()
    if hasattr(picker, "pick"):
        return picker
    raise TypeError(f"not a replica picker: {picker!r}")
