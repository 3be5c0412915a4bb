"""Policy-driven network fault injection for the messenger.

The port's copy of ``ceph_tpu.msg.fault``.

Reference behavior re-created (``src/msg/Messenger.h`` ms_inject_*
knobs + the ceph_manager/qa thrasher network-partition tooling): the
single ``ms_inject_socket_failures`` cut is generalised into a
per-peer-pair **policy table** — message drop / delay / duplicate /
reorder probabilities and **directed partitions** (A⇸B while B→A
still flows).

Determinism contract: every verdict is a pure function of
``(seed, src, dst, n)`` where ``n`` is the per-pair message counter —
NOT of thread interleaving or wall clock.  Two clusters driven with
the same seed see the n-th message of every peer pair suffer the same
fate, so a thrash failure replays from the logged seed alone.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

# verdicts, in evaluation order (first matching probability band wins)
DROP = "drop"
DELAY = "delay"
DUP = "dup"
REORDER = "reorder"
PARTITION = "partition"


@dataclass
class FaultRule:
    """One peer-pair policy.  Probabilities are independent bands of a
    single uniform draw (cumulative), so drop+dup+reorder+delay must
    sum to ≤ 1.0."""
    drop: float = 0.0
    delay: float = 0.0        # probability of delaying a message
    delay_ms: float = 20.0    # how long a delayed message waits
    dup: float = 0.0
    reorder: float = 0.0
    reorder_ms: float = 40.0  # hold-back window (later sends overtake)
    partition: bool = False   # directed: src→dst blackholed entirely

    def active(self) -> bool:
        return bool(self.partition or self.drop or self.delay
                    or self.dup or self.reorder)

    def to_dict(self) -> dict:
        return {"drop": self.drop, "delay": self.delay,
                "delay_ms": self.delay_ms, "dup": self.dup,
                "reorder": self.reorder, "reorder_ms": self.reorder_ms,
                "partition": self.partition}


@dataclass
class FaultDecision:
    verdict: str | None
    hold_s: float = 0.0       # enqueue delay for DELAY/REORDER


class FaultInjector:
    """Per-messenger fault policy table + seeded RNG.

    Rules are keyed ``(src, dst)`` where either side may be ``"*"``;
    lookup precedence is (src,dst) > (src,*) > (*,dst) > (*,*) so a
    targeted partition overrides a blanket drop policy.
    """

    def __init__(self, seed: int | None = None):
        if seed is None:
            seed = random.SystemRandom().randrange(1 << 31)
        self.seed = int(seed)
        # rng: the legacy socket-cut draw (ms_inject_socket_failures)
        # and any jitter — seeded so thrash runs replay from the seed
        self.rng = random.Random(self.seed)
        self._rules: dict[tuple[str, str], FaultRule] = {}
        self._counters: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        # mutation epoch: bumped on every rule change so hot paths can
        # skip the table scan entirely while no rules are installed
        self._active = False

    # -- policy management (thread-safe; callable from admin socket) ---
    def set_rule(self, src: str = "*", dst: str = "*", **kw) -> FaultRule:
        with self._lock:
            rule = self._rules.get((src, dst))
            if rule is None:
                rule = FaultRule()
                self._rules[(src, dst)] = rule
            for k, v in kw.items():
                if not hasattr(rule, k):
                    raise KeyError(f"unknown fault knob {k!r}")
                setattr(rule, k, type(getattr(rule, k))(v))
            self._refresh_active()
            return rule

    def partition(self, dst: str, src: str = "*"):
        """Install a DIRECTED partition: src→dst blackholed (the
        reverse direction is untouched — install on the peer's
        injector for a full split)."""
        return self.set_rule(src, dst, partition=True)

    def heal(self, src: str | None = None, dst: str | None = None):
        """Remove rules.  No args = everything; src/dst filter."""
        with self._lock:
            for key in list(self._rules):
                if (src is None or key[0] == src) and \
                        (dst is None or key[1] == dst):
                    del self._rules[key]
            self._refresh_active()

    def clear(self):
        self.heal()

    def describe(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": {f"{s}>{d}": r.to_dict()
                          for (s, d), r in self._rules.items()},
                "counters": {f"{s}>{d}": n
                             for (s, d), n in self._counters.items()},
            }

    def _refresh_active(self):
        self._active = any(r.active() for r in self._rules.values())

    @property
    def active(self) -> bool:
        return self._active

    # -- verdicts ------------------------------------------------------
    def _match(self, src: str, dst: str) -> FaultRule | None:
        rules = self._rules
        for key in ((src, dst), (src, "*"), ("*", dst), ("*", "*")):
            r = rules.get(key)
            if r is not None and r.active():
                return r
        return None

    @staticmethod
    def _verdict_for(rule: FaultRule, u: float) -> str | None:
        """Map one uniform draw to a verdict via cumulative bands."""
        if rule.partition:
            return PARTITION
        edge = rule.drop
        if u < edge:
            return DROP
        edge += rule.dup
        if u < edge:
            return DUP
        edge += rule.reorder
        if u < edge:
            return REORDER
        edge += rule.delay
        if u < edge:
            return DELAY
        return None

    def _draw(self, src: str, dst: str, n: int) -> float:
        # string seeding is sha512-based in CPython: stable across
        # processes and PYTHONHASHSEED, so the n-th message of a pair
        # draws the same uniform in every run with this seed
        return random.Random(
            f"{self.seed}|{src}>{dst}|{n}").random()

    def decide(self, src: str, dst: str) -> FaultDecision:
        """Fate of the next message src→dst; advances the pair counter."""
        with self._lock:
            rule = self._match(src, dst)
            if rule is None:
                return FaultDecision(None)
            key = (src, dst)
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
        v = self._verdict_for(rule, self._draw(src, dst, n))
        if v == DELAY:
            return FaultDecision(v, rule.delay_ms / 1000.0)
        if v == REORDER:
            return FaultDecision(v, rule.reorder_ms / 1000.0)
        return FaultDecision(v)

    def preview(self, src: str, dst: str, count: int) -> list[str | None]:
        """The fault schedule for the first `count` messages of a pair
        — pure (no counter advance).  Two injectors with equal seeds
        and rules return identical schedules; this is the acceptance
        hook for seeded reproducibility."""
        with self._lock:
            rule = self._match(src, dst)
        if rule is None:
            return [None] * count
        return [self._verdict_for(rule, self._draw(src, dst, n))
                for n in range(count)]

    def preview_pairs(self, pairs, count: int) -> dict[str, list]:
        """Site-level twin of `preview`: the fault schedule for each
        directed ``(src, dst)`` pair over its first `count` messages,
        keyed ``"src>dst"``.  Pure — this is how a whole-site event
        (blackout, WAN degradation over every inter-site pair) proves
        it replays from the logged seed."""
        return {f"{s}>{d}": self.preview(s, d, count) for s, d in pairs}

    def socket_cut(self, every: int) -> bool:
        """Legacy ms_inject_socket_failures draw, through the seeded
        per-messenger RNG (was: module-global ``random``)."""
        with self._lock:
            return self.rng.randrange(every) == 0


def site_pairs(a: list[str], b: list[str],
               bidirectional: bool = True) -> list[tuple[str, str]]:
    """All directed inter-site (src, dst) entity-name pairs — the unit
    the site-level primitives (partition_sites, blackout, slow-WAN)
    operate on.  Deterministic order: sorted within each site."""
    pairs = [(s, d) for s in sorted(a) for d in sorted(b)]
    if bidirectional:
        pairs += [(s, d) for s in sorted(b) for d in sorted(a)]
    return pairs


def injector_from_config(cfg) -> FaultInjector:
    """Build a FaultInjector from ms_inject_* options; a blanket
    (*→*) rule is installed when any probability is non-zero."""
    seed = int(cfg.get("ms_inject_seed") or 0) or None
    fi = FaultInjector(seed=seed)
    kw = {}
    for opt, knob in (("ms_inject_drop_prob", "drop"),
                      ("ms_inject_delay_prob", "delay"),
                      ("ms_inject_delay_ms", "delay_ms"),
                      ("ms_inject_dup_prob", "dup"),
                      ("ms_inject_reorder_prob", "reorder"),
                      ("ms_inject_reorder_ms", "reorder_ms")):
        v = cfg.get(opt)
        if v:
            kw[knob] = float(v)
    if any(k in kw for k in ("drop", "delay", "dup", "reorder")):
        fi.set_rule("*", "*", **kw)
    return fi
