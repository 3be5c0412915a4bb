"""PaxosService base — the mon's service-on-paxos pattern.

The port's copy of ``ceph_tpu.mon.service``.

Reference behavior re-created (``src/mon/PaxosService.{h,cc}``;
SURVEY.md §3.4): message/command handlers stage store ops on the
LEADER's pending transaction; the monitor bundles each service's
pending ops into one paxos value and proposes; every quorum member
applies committed transactions and refreshes the service's in-memory
state via ``update_from_store`` — so all mons expose identical maps
at identical versions.

Split out of ``monitor.py`` so services that live in their own module
(``health.py``) can subclass it without importing the Monitor.
"""

from __future__ import annotations


class PaxosService:
    NAME = "base"

    def __init__(self, mon):
        self.mon = mon
        self.pending_ops: list = []

    @property
    def prefix(self) -> str:
        return f"svc_{self.NAME}"

    def stage(self, kind: str, key, value=None):
        self.pending_ops.append([kind, self.prefix, str(key), value])

    def have_pending(self) -> bool:
        return bool(self.pending_ops)

    def take_pending(self) -> list:
        ops, self.pending_ops = self.pending_ops, []
        return ops

    # hooks
    def create_initial(self):
        pass

    def update_from_store(self):
        """Reload in-memory state after a commit (all quorum members)."""

    def dispatch_command(self, cmd: dict) -> tuple[int, str, object] | None:
        """→ (rc, status, output) or None if not mine.  Mutating
        handlers stage ops and the monitor proposes after."""
        return None

    def on_election_start(self):
        """Leadership lost or in doubt: staged-but-unproposed ops and
        any pending (uncommitted) working state are dead.  Subclasses
        with extra pending fields clear them here too."""
        self.pending_ops = []

    def tick(self):
        """Periodic leader-side work (liveness checks etc.)."""
