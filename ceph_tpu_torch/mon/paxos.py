"""Elector + Paxos — the mon quorum's consensus core.

The port's copy of ``ceph_tpu.mon.paxos``.

Reference behavior re-created (``src/mon/Elector.cc``,
``src/mon/ElectionLogic.cc``, ``src/mon/Paxos.{h,cc}``; SURVEY.md §3.4):

- **Election**: rank-based.  Epochs are odd during an election, even
  when stable.  A mon bootstraps by PROPOSEing; peers ACK anyone with a
  lower rank (deferring) or counter-propose.  The proposer that
  collects a majority declares VICTORY, fixing the quorum and becoming
  leader; the rest are peons.
- **Paxos**: leader-driven multi-instance.  After election the leader
  runs COLLECT (a Prepare over the whole log): peons promise to the new
  pn and report their last_committed + any uncommitted (pn, value);
  the leader re-proposes the highest-pn uncommitted value, and peers
  share committed versions the others miss.  Steady state is
  BEGIN(v, value) → ACCEPT×quorum → COMMIT(v) with values applied to
  the MonitorDBStore; proposal numbers are ``(n*100 + rank)`` so they
  are unique and ordered across mons, exactly the reference's scheme.
- **Leases**: the leader extends a read lease to peons with every
  commit/tick; peons time out the lease into a new election (failure
  detection for a dead leader).

Single-proposal-in-flight, as upstream: services batch their pending
changes and propose one transaction blob per round.
"""

from __future__ import annotations

import json
import time

# election ops
PROPOSE, ACK, VICTORY = "propose", "ack", "victory"
# paxos ops
COLLECT, LAST, BEGIN, ACCEPT, COMMIT, LEASE, CATCHUP = (
    "collect", "last", "begin", "accept", "commit", "lease", "catchup")
LEASE_ACK = "lease_ack"

PAXOS_PREFIX = "paxos"


class Elector:
    """Rank-based election logic (transport-agnostic: the Monitor feeds
    messages in and sends what `outbox` accumulates)."""

    def __init__(self, rank: int, ranks: list[int],
                 tiebreaker: int | None = None):
        self.rank = rank
        self.ranks = ranks           # all monmap ranks
        # stretch-mode tiebreaker rank (reference
        # MonMap::tiebreaker_mon / disallowed_leaders): its ACK counts
        # toward a majority — that's how a surviving site keeps quorum
        # after losing half the mons — but it never campaigns and no
        # one defers to it, so it can never become leader.
        self.tiebreaker = tiebreaker
        self.epoch = 1               # odd ⇒ electing
        self.state = "startup"       # no round begun yet
        self.leader: int | None = None
        self.quorum: list[int] = []
        self.acked: set[int] = set()
        self.electing_me = False     # am I an active candidate?
        self.deferred_to: int | None = None  # who we acked this epoch
        self.outbox: list[tuple[int, dict]] = []   # (to_rank, payload)

    @property
    def majority(self) -> int:
        return len(self.ranks) // 2 + 1

    def start(self):
        """Begin (or restart) an election round."""
        if self.rank == self.tiebreaker:
            # a tiebreaker never campaigns: its PROPOSE below is only
            # a nudge (peers treat candidacy from the tiebreaker rank
            # as "please start an election", never as a candidate)
            if self.epoch % 2 == 0:
                self.epoch += 1
            self.state = "electing"
            self.leader = None
            self.electing_me = False
            self.acked = set()
            self.deferred_to = None
            for r in self.ranks:
                if r != self.rank:
                    self.outbox.append(
                        (r, {"op": PROPOSE, "epoch": self.epoch,
                             "from": self.rank}))
            return
        if self.epoch % 2 == 0:
            self.epoch += 1
        elif self.deferred_to is not None:
            # we ACKed someone in the current round; campaigning in the
            # SAME epoch could hand two candidates a majority (our old
            # ACK still counts for the other).  Open a fresh round so
            # peers' epoch filter voids stale votes.
            self.epoch += 2
        self.state = "electing"
        self.leader = None
        self.electing_me = True
        self.acked = {self.rank}
        self.deferred_to = None
        for r in self.ranks:
            if r != self.rank:
                self.outbox.append(
                    (r, {"op": PROPOSE, "epoch": self.epoch,
                         "from": self.rank}))
        self._maybe_win()

    def _bump_epoch(self, epoch: int):
        """Adopt a newer epoch; a new round voids both our candidacy
        and any deferral made in the old round (reference
        ElectionLogic::bump_epoch)."""
        if epoch > self.epoch:
            self.epoch = epoch
            self.electing_me = False
            self.deferred_to = None
            self.acked = set()
        if self.epoch % 2 == 0:
            self.epoch += 1

    def _defer(self, frm: int):
        """Ack a better (lower-ranked) candidate.  Deferring withdraws
        our own candidacy: with ``electing_me`` false, stray ACKs that
        arrive later are discarded and ``finalize()`` cannot declare us
        the winner — otherwise two leaders could emerge in one epoch."""
        self.state = "electing"
        self.electing_me = False
        self.deferred_to = frm
        self.acked = set()
        self.outbox.append(
            (frm, {"op": ACK, "epoch": self.epoch, "from": self.rank}))

    def handle(self, msg: dict):
        op, frm, epoch = msg["op"], msg["from"], msg["epoch"]
        if epoch < self.epoch and op != VICTORY:
            # stale round: nudge the sender forward
            if op == PROPOSE:
                self.outbox.append(
                    (frm, {"op": PROPOSE, "epoch": self.epoch,
                           "from": self.rank}))
            return
        if op == PROPOSE:
            self._bump_epoch(epoch)
            if self.tiebreaker is not None and frm == self.tiebreaker:
                # the tiebreaker's PROPOSE is a nudge, not a candidacy
                # — deferring to it could elect a leader outside both
                # sites.  Campaign ourselves instead.
                if not self.electing_me and self.deferred_to is None \
                        and self.rank != self.tiebreaker:
                    self.start()
                return
            if self.rank == self.tiebreaker:
                # tiebreaker: ack the best (lowest-ranked) candidate
                # seen this round, never campaign
                if self.deferred_to is None or frm <= self.deferred_to:
                    self._defer(frm)
                return
            if frm < self.rank:
                # they would win over me — defer unless we already
                # deferred to a still-better (lower) candidate this
                # round (reference ElectionLogic::receive_propose; <=
                # re-acks the SAME candidate's retry, repairing a lost
                # ACK)
                if self.deferred_to is None or frm <= self.deferred_to:
                    self._defer(frm)
            else:
                # I would win over them
                if self.deferred_to is not None:
                    # already deferred to someone who beats them too:
                    # ignore (deferred_to < self.rank < frm)
                    pass
                elif not self.electing_me:
                    self.start()
                else:
                    # already campaigning: remind them of my candidacy
                    self.outbox.append(
                        (frm, {"op": PROPOSE, "epoch": self.epoch,
                               "from": self.rank}))
        elif op == ACK:
            # acks only count while we are an active candidate; after a
            # deferral they are stale and must not elect us
            if self.electing_me and self.state == "electing" \
                    and epoch == self.epoch:
                self.acked.add(frm)
                self._maybe_win()
        elif op == VICTORY:
            if epoch >= self.epoch:
                self.epoch = epoch
                self.state = "peon"
                self.leader = frm
                self.quorum = msg["quorum"]
                self.electing_me = False
                self.deferred_to = None

    def _maybe_win(self):
        """Immediate victory only when EVERY rank deferred; a mere
        majority waits for `finalize()` (the monitor calls it after a
        gather delay) so slower acks still join the quorum — otherwise
        the last mon systematically loses the ack race and can never
        rejoin."""
        if len(self.acked) == len(self.ranks):
            self._declare_victory()

    def finalize(self):
        """Gather-timeout expiry: take the quorum we have, if majority."""
        if self.state == "electing" and self.electing_me \
                and len(self.acked) >= self.majority:
            self._declare_victory()

    def _declare_victory(self):
        self.epoch += 1   # to even: stable
        self.state = "leader"
        self.leader = self.rank
        self.quorum = sorted(self.acked)
        # VICTORY to EVERY rank, not just the quorum: a mon that
        # missed the round learns the leader, and (receiving no
        # lease, being outside the quorum) its lease timeout calls
        # the next election to rejoin — the reference's bootstrap-
        # to-rejoin behavior
        for r in self.ranks:
            if r != self.rank:
                self.outbox.append(
                    (r, {"op": VICTORY, "epoch": self.epoch,
                         "from": self.rank,
                         "quorum": self.quorum}))




class Paxos:
    """The consensus log.  Values are opaque bytes (service transaction
    blobs); committed versions live in the store under PAXOS_PREFIX."""

    def __init__(self, store, rank: int):
        self.store = store
        self.rank = rank
        self.last_committed = store.get_int(PAXOS_PREFIX, "last_committed")
        self.first_committed = store.get_int(PAXOS_PREFIX,
                                             "first_committed")
        self.accepted_pn = store.get_int(PAXOS_PREFIX, "accepted_pn")
        self.state = "recovering"
        self.quorum: list[int] = []
        self.outbox: list[tuple[int, dict]] = []
        self.on_commit = None        # cb(version, value_bytes)
        self.on_active = None        # cb() when a round finishes
        # leader collect state
        self._collect_pn = 0
        self._collecting = False   # a collect WE started is open
        self._last_from: set[int] = set()
        self._uncommitted_v = None
        self._uncommitted_pn = 0
        self._uncommitted_value = None
        # leader begin state
        self._accepts: set[int] = set()
        self._pending_value: bytes | None = None
        self._pending_v = 0
        self._begin_started = 0.0     # when the open BEGIN round started
        self.lease_until = 0.0
        # leader-side: rank → monotonic time of last lease ack
        self.lease_acks: dict[int, float] = {}

    # -- helpers -----------------------------------------------------------
    def _new_pn(self) -> int:
        pn = (self.accepted_pn // 100 + 1) * 100 + self.rank
        self.accepted_pn = pn
        self.store.apply_transaction(
            _tx(("put", PAXOS_PREFIX, "accepted_pn", pn)))
        return pn

    def get_version(self, v: int) -> bytes | None:
        return self.store.get(PAXOS_PREFIX, v)

    def is_active(self) -> bool:
        return self.state == "active"

    def is_writeable(self) -> bool:
        """Safe to stage new service mutations: an open round may be
        in flight ("updating"), but never mid-recovery — a value
        staged before create_initial's activation seeding commits
        would be stomped by it (same version, same keys)."""
        return self.state in ("active", "updating") \
            and not self._collecting

    def abort_round(self):
        """Leadership lost: whatever round is open can never gather
        full-quorum accepts under our pn again, and a LATE accept must
        not fire a commit the new quorum never agreed to."""
        self.state = "recovering"
        self._collecting = False
        self._pending_value = None
        self._accepts = set()

    # -- leader ------------------------------------------------------------
    def leader_collect(self, quorum: list[int]):
        """Phase 1 after winning an election."""
        self.quorum = quorum
        now = time.monotonic()
        self.lease_acks = {r: now for r in quorum if r != self.rank}
        self.state = "recovering"
        pn = self._new_pn()
        self._collect_pn = pn
        self._collecting = True
        self._last_from = {self.rank}
        self._uncommitted_v = None
        self._uncommitted_pn = 0
        self._uncommitted_value = None
        # my own uncommitted value (with its accept-time pn)
        unv = self.last_committed + 1
        mine = self.store.get(PAXOS_PREFIX, f"uncommitted_{unv}")
        if mine is not None:
            self._uncommitted_v = unv
            self._uncommitted_pn = self.store.get_int(
                PAXOS_PREFIX, f"uncommitted_pn_{unv}")
            self._uncommitted_value = mine
        for r in self.quorum:
            if r != self.rank:
                self.outbox.append((r, {
                    "op": COLLECT, "pn": pn,
                    "last_committed": self.last_committed,
                    "from": self.rank}))
        self._maybe_collect_done()

    def _maybe_collect_done(self):
        if len(self._last_from) >= len(self.quorum):
            if self._uncommitted_value is not None:
                # re-propose the in-flight value (Paxos safety)
                self._do_begin(self._uncommitted_v,
                               self._uncommitted_value)
            else:
                self._go_active()

    def _go_active(self):
        self.state = "active"
        self._collecting = False
        self.extend_lease()
        if self.on_active:
            self.on_active()

    def propose(self, value: bytes) -> bool:
        """Leader-only: propose the next version. One in flight."""
        if self.state != "active":
            return False
        self._do_begin(self.last_committed + 1, value)
        return True

    def _do_begin(self, v: int, value: bytes):
        self.state = "updating"
        self._pending_v = v
        self._pending_value = value
        self._accepts = {self.rank}
        self._begin_started = time.monotonic()
        self.store.apply_transaction(_tx(
            ("put", PAXOS_PREFIX, f"uncommitted_{v}", value),
            ("put", PAXOS_PREFIX, f"uncommitted_pn_{v}",
             self.accepted_pn)))
        for r in self.quorum:
            if r != self.rank:
                self.outbox.append((r, {
                    "op": BEGIN, "pn": self.accepted_pn, "v": v,
                    "value": value.hex(), "from": self.rank}))
        self._maybe_commit()

    def accept_timed_out(self, timeout: float = 5.0) -> bool:
        """True when a BEGIN round has waited longer than `timeout` for
        the full quorum to accept — the monitor bootstraps a new
        election (reference: Paxos accept_timeout → mon->bootstrap())."""
        return (self.state == "updating"
                and time.monotonic() - self._begin_started > timeout)

    def _maybe_commit(self):
        # Commit only when the ENTIRE quorum accepted (reference
        # Paxos::handle_accept).  A mere majority of the quorum is not
        # safe: the quorum itself may be a strict subset of all mons, so
        # a majority-of-quorum commit could land on a minority of mons
        # and be lost to a later election drawn from the others.
        if self.state == "updating" and \
                len(self._accepts) == len(self.quorum):
            v, value = self._pending_v, self._pending_value
            self._commit_local(v, value)
            for r in self.quorum:
                if r != self.rank:
                    self.outbox.append((r, {
                        "op": COMMIT, "v": v, "value": value.hex(),
                        "from": self.rank}))
            self._go_active()

    def peon_ack_stale(self, grace: float = 6.0) -> list[int]:
        """Quorum peons silent past grace (leader side) — the failure
        signal the reference derives from missing lease acks."""
        if not self.lease_acks:
            return []
        now = time.monotonic()
        return [r for r, t in self.lease_acks.items()
                if now - t > grace]

    def extend_lease(self, duration: float = 5.0):
        self.lease_until = time.monotonic() + duration
        for r in self.quorum:
            if r != self.rank:
                self.outbox.append((r, {
                    "op": LEASE, "last_committed": self.last_committed,
                    "duration": duration, "from": self.rank}))

    # -- both sides --------------------------------------------------------
    def _commit_local(self, v: int, value: bytes):
        if v <= self.last_committed:
            return
        self.store.apply_transaction(_tx(
            ("put", PAXOS_PREFIX, str(v), value),
            ("put", PAXOS_PREFIX, "last_committed", v),
            ("erase", PAXOS_PREFIX, f"uncommitted_{v}", None),
            ("erase", PAXOS_PREFIX, f"uncommitted_pn_{v}", None)))
        self.last_committed = v
        if self.on_commit:
            self.on_commit(v, value)

    # -- peon --------------------------------------------------------------
    def handle(self, msg: dict):
        op = msg["op"]
        frm = msg["from"]
        if op == COLLECT:
            pn = msg["pn"]
            reply = {"op": LAST, "pn": pn,
                     "last_committed": self.last_committed,
                     "from": self.rank, "values": {}}
            if pn > self.accepted_pn:
                self.accepted_pn = pn
                self.store.apply_transaction(
                    _tx(("put", PAXOS_PREFIX, "accepted_pn", pn)))
                # share committed versions the leader may miss
                lc = msg["last_committed"]
                for v in range(lc + 1, self.last_committed + 1):
                    blob = self.get_version(v)
                    if blob is not None:
                        reply["values"][str(v)] = blob.hex()
                unv = self.last_committed + 1
                un = self.store.get(PAXOS_PREFIX, f"uncommitted_{unv}")
                if un is not None:
                    reply["uncommitted_v"] = unv
                    # the pn the value was ACCEPTED under (not the pn we
                    # just promised) — the highest-accepted-pn tie-break
                    # is the safety rule of the re-propose step
                    reply["uncommitted_pn"] = self.store.get_int(
                        PAXOS_PREFIX, f"uncommitted_pn_{unv}")
                    reply["uncommitted_value"] = un.hex()
            else:
                reply["pn"] = self.accepted_pn   # NACK with higher pn
            self.outbox.append((frm, reply))
        elif op == LAST:
            # only while a collect WE started is open: a leader demoted
            # mid-collect is back in "recovering", and late LASTs from
            # its dead round must not walk it to active as a phantom
            # leader (nor may their pn-NACKs restart its collect)
            if self.state != "recovering" or not self._collecting:
                return
            if msg["pn"] > self._collect_pn:
                # NACK: someone promised a higher pn; restart collect
                # above it (adopting it ensures _new_pn goes higher)
                self.accepted_pn = msg["pn"]
                self.leader_collect(self.quorum)
                return
            if msg["pn"] != self._collect_pn:
                # stale LAST from a superseded collect of OURS: counting
                # it could complete the restarted round without the
                # restarted promises — and miss an uncommitted value a
                # peon accepted in between (divergent re-propose)
                return
            # learn newer commits from the peon
            for vs, blob in sorted(msg["values"].items(),
                                   key=lambda kv: int(kv[0])):
                self._commit_local(int(vs), bytes.fromhex(blob))
            if msg.get("uncommitted_value") is not None and \
                    msg["uncommitted_pn"] >= self._uncommitted_pn and \
                    msg["uncommitted_v"] == self.last_committed + 1:
                self._uncommitted_v = msg["uncommitted_v"]
                self._uncommitted_pn = msg["uncommitted_pn"]
                self._uncommitted_value = bytes.fromhex(
                    msg["uncommitted_value"])
            self._last_from.add(frm)
            self._maybe_collect_done()
        elif op == BEGIN:
            if msg["pn"] >= self.accepted_pn:
                v = msg["v"]
                value = bytes.fromhex(msg["value"])
                self.store.apply_transaction(_tx(
                    ("put", PAXOS_PREFIX, f"uncommitted_{v}", value),
                    ("put", PAXOS_PREFIX, f"uncommitted_pn_{v}",
                     msg["pn"])))
                self.outbox.append((frm, {
                    "op": ACCEPT, "pn": msg["pn"], "v": v,
                    "from": self.rank}))
        elif op == ACCEPT:
            if msg["pn"] == self.accepted_pn:
                self._accepts.add(frm)
                self._maybe_commit()
        elif op == COMMIT:
            self._commit_local(msg["v"], bytes.fromhex(msg["value"]))
        elif op == LEASE:
            self.lease_until = time.monotonic() + msg["duration"]
            # ack so the leader can tell live peons from dead ones
            # (reference MMonPaxos OP_LEASE_ACK)
            self.outbox.append((frm, {"op": LEASE_ACK,
                                      "from": self.rank}))
            if msg["last_committed"] > self.last_committed:
                # we missed a COMMIT (dropped peer message): ask the
                # leader to resend the gap instead of serving stale reads
                self.outbox.append((frm, {
                    "op": CATCHUP, "from": self.rank,
                    "last_committed": self.last_committed}))
        elif op == LEASE_ACK:
            # only quorum members refresh: a late ack from an evicted
            # rank must not re-enter the table (it would never refresh
            # again and trip the staleness check forever)
            if frm in self.quorum:
                self.lease_acks[frm] = time.monotonic()
        elif op == CATCHUP:
            for v in range(msg["last_committed"] + 1,
                           self.last_committed + 1):
                blob = self.get_version(v)
                if blob is not None:
                    self.outbox.append((frm, {
                        "op": COMMIT, "v": v, "value": blob.hex(),
                        "from": self.rank}))

    def lease_expired(self) -> bool:
        return time.monotonic() > self.lease_until


def _tx(*ops):
    from .store import StoreTransaction
    t = StoreTransaction()
    for op in ops:
        if op[0] == "put":
            t.put(op[1], op[2], op[3] if not isinstance(op[3], int)
                  else str(op[3]))
        else:
            t.erase(op[1], op[2])
    return t
