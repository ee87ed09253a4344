"""PowerPolicy protocol and the windowed-policy base class.

A power policy is anything with ``maybe_act(engine) -> Optional[float]``:
called after every engine step, it may read the engine's aggregate metrics
and actuate ``engine.set_frequency``; it returns the chosen frequency when
it acts and ``None`` otherwise. The shared event loop
(``repro.serving.driver``) calls nothing else, so AGFT, rule-based
governors and SLO controllers are interchangeable behind this boundary.

Policies carry a ``scope`` class attribute: ``"node"`` (this module's
default — one controller per engine, invoked on iteration-complete
events) or ``"fleet"`` (one controller for a whole cluster, invoked on
FLEET_TICK events with aggregated telemetry; see
``repro.policies.fleet``).

Node policies may additionally implement the OPTIONAL band hook
``set_band(f_lo, f_hi)``: a fleet coordinator (``repro.policies.
hierarchy``) assigns each node a frequency band on FLEET_TICK and the
node-local loop fine-tunes inside it. ``WindowedPolicy`` implements it by
clamping every decision into the band; AGFT masks its LinUCB arms
instead. Policies without the hook simply aren't band-governed (the
event loop still clamps the engine's frequency into the band).

A second OPTIONAL hook, ``tick(engine, now)``, supports the event loop's
pure POLICY_TICK scheduling (``policy_tick_mode="tick"``): one decision
per wall-clock tick, telemetry window cut at the tick's virtual time.
``WindowedPolicy`` and ``AGFTTuner`` implement it; duck-typed minimal
policies without it fall back to ``maybe_act`` at tick times.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.core.monitor import TelemetryMonitor
from repro_torch.energy.edp import WindowStats
from repro_torch.energy.power_model import HardwareSpec
from repro_torch.policies.registry import register_policy


@runtime_checkable
class PowerPolicy(Protocol):
    """Structural interface every frequency controller implements.

    ``set_band(f_lo, f_hi)`` is an OPTIONAL extra hook (deliberately not a
    protocol member — ``runtime_checkable`` would demand it of every
    implementation): policies that have it are band-governable by a fleet
    coordinator; the event loop feature-detects it with ``getattr``.
    """

    def maybe_act(self, engine) -> Optional[float]:
        """Observe the engine (aggregate metrics only) and optionally set
        its frequency; return the actuated frequency, else ``None``."""
        ...


class WindowedPolicy:
    """Base for policies that decide once per telemetry window.

    Owns a :class:`TelemetryMonitor` so every subclass observes the engine
    through the same Prometheus-boundary ``WindowStats`` the paper's monitor
    produces, and records an AGFT-compatible ``history`` of per-window
    decisions (``t``/``freq``/``energy_j``/``tpot``/``edp``/``phase``) so
    benchmarks can treat all policies uniformly.

    Subclasses implement ``decide(window, engine) -> Optional[float]``;
    the returned frequency is clamped to the hardware envelope — and into
    the fleet-assigned band, when a coordinator has set one — and actuated.
    A decision may instead be a ``(f_prefill, f_decode)`` pair (the
    optional 2-D surface, see ``repro.policies.phased``): both axes are
    clamped the same way and actuated via ``set_phase_frequencies``.
    Phased policies declare ``phased = True`` so the batched fleet loop
    can refuse them at construction.
    """

    #: label recorded in history rows; subclasses override
    phase_name = "rule"
    #: governs a single engine (fleet-scope policies declare "fleet")
    scope = "node"

    def __init__(self, hardware: HardwareSpec,
                 sampling_period_s: float = 0.8):
        self.hw = hardware
        self.monitor = TelemetryMonitor(sampling_period_s)
        self.band: Optional[Tuple[float, float]] = None
        self.history: List[dict] = []

    # ------------------------------------------------------------------
    def set_band(self, f_lo: float, f_hi: float) -> None:
        """Fleet-coordinator hook: clamp every subsequent decision into
        ``[f_lo, f_hi]`` (inverted bounds tolerated, clamped to the
        hardware envelope)."""
        lo, hi = (float(f_lo), float(f_hi))
        if lo > hi:
            lo, hi = hi, lo
        lo = min(max(lo, self.hw.f_min), self.hw.f_max)
        hi = min(max(hi, self.hw.f_min), self.hw.f_max)
        self.band = (lo, hi)

    def maybe_act(self, engine) -> Optional[float]:
        if not self.monitor.due(engine):
            return None
        # a due iteration-gated decision IS a tick cut at the engine
        # clock — one decision body, two gates
        return self.tick(engine, engine.clock)

    def tick(self, engine, now: float) -> Optional[float]:
        """POLICY_TICK entrypoint (``policy_tick_mode="tick"``): decide
        once per wall-clock tick, with the telemetry window cut at the
        tick's virtual time ``now`` instead of at an iteration boundary.
        One tick = one decision — the monitor's due-gating is the event
        loop's job in this mode (and ``maybe_act``'s in iteration mode).

        Under fault injection (``repro.serving.faults``) a failed
        telemetry scrape blanks the window: the monitor is re-armed
        without a snapshot, no decision is taken (the engine holds its
        frequency), and a ``blank`` history row records the dropout —
        the rule-policy half of graceful degradation (AGFT's richer
        freeze lives in ``repro.core.tuner``)."""
        fs = getattr(engine, "fault_state", None)
        if fs is not None and fs.scrape_dropped(now):
            self.monitor.skip(engine, now=now)
            self._record(engine, None, None, t=now)
            return None
        window = self.monitor.observe(engine, now=now)
        f = self.decide(window, engine)
        if isinstance(f, tuple):
            # phase-disaggregated decision (optional 2-D surface): clamp
            # each axis into the envelope/band and actuate both phase
            # clocks (see repro.serving.engine.set_phase_frequencies)
            f = tuple(self._clamp(x) for x in f)
            engine.set_phase_frequencies(*f)
        elif f is not None:
            f = self._clamp(f)
            engine.set_frequency(f)
        self._record(engine, f, window, t=now)
        return f

    def _clamp(self, f: float) -> float:
        f = float(min(max(f, self.hw.f_min), self.hw.f_max))
        if self.band is not None:
            f = float(min(max(f, self.band[0]), self.band[1]))
        return f

    def decide(self, window: Optional[WindowStats],
               engine) -> Optional[float]:
        """Per-window decision; ``window`` is ``None`` on the first sample."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _record(self, engine, f: Optional[float],
                window: Optional[WindowStats],
                t: Optional[float] = None) -> None:
        self.history.append({
            "t": engine.clock if t is None else t,
            "freq": float(engine.frequency),
            "reward": None,
            "edp": window.edp if window else None,
            "energy_j": window.energy_j if window else None,
            "tpot": window.effective_tpot if window else None,
            "phase": self.phase_name if window else "warmup",
            "acted": f is not None,
        })


@register_policy("observer")
class TelemetryRecorder(WindowedPolicy):
    """Observe-only policy: records per-window telemetry, never actuates.

    Attach it to a baseline (fixed-frequency) engine so time-windowed
    energy/latency series are measured exactly — replacing the old
    average-power estimate in the phase benchmarks.
    """

    phase_name = "observe"

    def decide(self, window, engine):
        return None
