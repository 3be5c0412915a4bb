"""MonClient — client-side mon session: hunt, commands, subscriptions.

The port's copy of ``ceph_tpu.mon.client``.

Reference behavior re-created (``src/mon/MonClient.{h,cc}``; SURVEY.md
§3.4): pick a mon from the monmap, keep the session alive, resend
commands on failover (mutating commands are leader-only, so a -11
"not leader" reply triggers a reconnect to the leader), and maintain
subscriptions (``sub_want``) — the osdmap feed every daemon lives on.
"""

from __future__ import annotations

import json
import random
import threading
import time

from ..msg import Dispatcher, Messenger
from ..msg.messenger import EntityAddr
from . import messages as M
from .monitor import MonMap


class MonClient(Dispatcher):
    # session keepalive (reference MonClient::tick): ping the session
    # mon; silence past the grace — or an "out of quorum" ack — makes
    # us hunt a different mon.  Without this a fault-injected blackout
    # (TCP up, frames blackholed) pins subscribers to a dead mon
    # forever: nothing ever resets the connection.
    PING_INTERVAL = 1.0
    PING_GRACE = 3.5

    def __init__(self, monmap: MonMap, entity: str = "client.admin",
                 timeout: float = 10.0, auth=None):
        self.monmap = monmap
        self.entity = entity
        self.timeout = timeout
        self.msgr = Messenger(
            entity, **(auth.msgr_kwargs(entity) if auth else {}))
        self.msgr.add_dispatcher(self)
        self._con = None
        self._cur_rank: int | None = None
        self._mgr_con = None
        self._mgr_addr: tuple | None = None
        self._tid = 0
        self._waiters: dict[int, tuple[threading.Event, list]] = {}
        self._subs: dict[str, int] = {}
        self.osdmap_epoch = 0
        self.osdmap_dict: dict | None = None
        self.on_osdmap = None       # cb(epoch, map_dict)
        self.fsmap_epoch = 0
        self.fsmap_dict: dict | None = None
        self.on_fsmap = None        # cb(epoch, fsmap_dict)
        self.mgrmap_epoch = 0
        self.mgrmap_dict: dict | None = None
        self.on_mgrmap = None       # cb(epoch, mgrmap_dict)
        self.on_event = None        # cb(kind, data, stamp) — "events"
        self._lock = threading.Lock()
        self._last_ack = time.monotonic()
        self._stop = threading.Event()
        threading.Thread(target=self._keepalive_loop, daemon=True,
                         name=f"monc-ping-{entity}").start()

    # -- session -----------------------------------------------------------
    def _connect(self, rank: int | None = None):
        ranks = self.monmap.ranks()
        order = [rank] if rank is not None else \
            random.sample(ranks, len(ranks))
        last_err = None
        for r in order:
            try:
                self._con = self.msgr.connect_to(self.monmap.mons[r])
                self._cur_rank = r
                self._last_ack = time.monotonic()  # fresh grace
                if self._subs:
                    self._con.send_message(
                        M.MMonSubscribe(what=dict(self._subs)))
                return
            except (ConnectionError, OSError) as e:
                last_err = e
        raise ConnectionError(f"no monitor reachable: {last_err}")

    def _ensure(self):
        if self._con is None or not self._con.is_connected:
            self._connect()

    def _keepalive_loop(self):
        while not self._stop.wait(self.PING_INTERVAL):
            con = self._con
            if con is None or not con.is_connected:
                # nothing to watch over unless a subscription exists
                # (command clients reconnect lazily on their own)
                if self._subs:
                    try:
                        self._connect()
                        self._last_ack = time.monotonic()
                    except (ConnectionError, OSError):
                        pass
                continue
            if time.monotonic() - self._last_ack > self.PING_GRACE:
                # silent session (blackholed, wedged, or dead): hunt
                self._con = None
                try:
                    con.mark_down()
                except Exception:   # noqa: BLE001 — already dead
                    pass
                continue
            try:
                con.send_message(M.MMonPing(tid=0))
            except (ConnectionError, OSError):
                self._con = None

    def shutdown(self):
        self._stop.set()
        self.msgr.shutdown()

    # -- commands ----------------------------------------------------------
    def _send_and_wait(self, con, cmd: dict, end: float):
        """Register a tid waiter, send MMonCommand on `con`, await the
        reply until `end` → reply message or None (timeout).  Shared
        by the mon and mgr command paths so the waiter/timeout
        machinery cannot drift between them."""
        with self._lock:
            self._tid += 1
            tid = self._tid
            ev = threading.Event()
            self._waiters[tid] = (ev, [])
        try:
            con.send_message(M.MMonCommand(tid=tid, cmd=cmd))
        except Exception:
            with self._lock:
                self._waiters.pop(tid, None)
            raise
        if not ev.wait(max(0.05, end - time.monotonic())):
            with self._lock:
                self._waiters.pop(tid, None)
            return None
        with self._lock:
            _, box = self._waiters.pop(tid)
        return box[0]

    def command(self, cmd: dict | str, timeout: float | None = None):
        """→ (rc, status_str, output).  Retries against the leader when
        a peon refuses a mutating command."""
        if isinstance(cmd, str):
            cmd = {"prefix": cmd}
        deadline = timeout if timeout is not None else self.timeout
        end = time.monotonic() + deadline   # TOTAL budget: retries,
        last_outs = ""                      # waits and reconnects all
        while time.monotonic() < end:       # share it
            try:
                self._ensure()
                reply = self._send_and_wait(self._con, cmd, end)
            except (ConnectionError, OSError, AttributeError):
                # no mon reachable right now, or another thread hunted
                # (_con = None) between _ensure and the send: back off
                # a beat and keep hunting within the budget
                self._con = None
                time.sleep(0.3)
                continue
            if reply is None:
                self._con = None     # mon silent: hunt a new one
                continue
            if reply.rc == -11:      # not leader (referral) or a
                # transient internal error: remember the reason so a
                # persistent failure surfaces it, then retry
                last_outs = reply.outs or last_outs
                leader = (reply.outb or {}).get("leader")
                if leader is None or leader == self._cur_rank:
                    # leaderless churn, or "retry" from the mon we are
                    # already on (recovering): give the election a beat
                    # (instant retries burn the budget inside one
                    # churn window)
                    time.sleep(0.3)
                self._con = None
                try:
                    self._connect(leader if leader is not None
                                  else None)
                except ConnectionError:
                    # referred to a dead mon: hunt any live one
                    self._con = None
                continue
            return reply.rc, reply.outs, reply.outb
        raise TimeoutError(
            f"mon command {cmd.get('prefix')!r} failed"
            + (f": {last_outs}" if last_outs else ""))

    def _drop_mgr_con(self):
        """Abandon the mgr connection properly: mark_down stops the
        messenger's reconnect loop from retrying a dead mgr's port
        forever (one immortal loop per failover otherwise)."""
        con, self._mgr_con = self._mgr_con, None
        if con is not None:
            try:
                con.mark_down()
            except Exception:   # noqa: BLE001 — already dead
                pass

    def mgr_command(self, cmd: dict | str,
                    timeout: float | None = None):
        """→ (rc, status_str, output) from the ACTIVE mgr's command
        server (reference librados mgr_command / `ceph tell mgr`):
        resolve active_addr from the mgrmap, connect, correlate the
        reply by tid through the shared waiter table."""
        if isinstance(cmd, str):
            cmd = {"prefix": cmd}
        deadline = timeout if timeout is not None else self.timeout
        end = time.monotonic() + deadline
        last_outs = ""
        while time.monotonic() < end:
            rc, outs, mgrmap = self.command(
                "mgr dump", timeout=max(0.1, end - time.monotonic()))
            if rc != 0 or not (mgrmap or {}).get("active_addr"):
                last_outs = outs or "no active mgr"
                time.sleep(0.3)
                continue
            host, port = mgrmap["active_addr"]
            try:
                con = self._mgr_con
                if con is None or not con.is_connected \
                        or self._mgr_addr != (host, port):
                    if con is not None:
                        con.mark_down()
                    con = self.msgr.connect_to(
                        EntityAddr(host, int(port)))
                    self._mgr_con = con
                    self._mgr_addr = (host, port)
                reply = self._send_and_wait(con, cmd, end)
            except (ConnectionError, OSError, AttributeError):
                self._drop_mgr_con()
                time.sleep(0.3)
                continue
            if reply is None:
                self._drop_mgr_con()
                continue
            if reply.rc == -11:     # mgr mid-failover: re-resolve
                last_outs = reply.outs or last_outs
                self._drop_mgr_con()
                time.sleep(0.3)
                continue
            return reply.rc, reply.outs, reply.outb
        raise TimeoutError(
            f"mgr command {cmd.get('prefix')!r} failed"
            + (f": {last_outs}" if last_outs else ""))

    def send(self, msg):
        """Fire-and-forget daemon→mon message (MOSDBoot/MOSDFailure —
        peons forward these to the leader)."""
        try:
            self._ensure()
            con = self._con
            if con is not None:
                con.send_message(msg)
        except (ConnectionError, OSError, AttributeError):
            # AttributeError: another thread hunted (_con = None)
            # between _ensure and the send — next call reconnects
            self._con = None

    # -- subscriptions -----------------------------------------------------
    def sub_want(self, what: str, start: int = 0):
        self._subs[what] = start
        self._ensure()
        self._con.send_message(M.MMonSubscribe(what={what: start}))

    def _wait_for_map(self, what: str, min_epoch: int,
                      timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            d = getattr(self, f"{what}_dict")
            if d is not None and \
                    getattr(self, f"{what}_epoch") >= min_epoch:
                return d
            time.sleep(0.02)
        raise TimeoutError(f"{what} epoch {min_epoch} not seen")

    def wait_for_fsmap(self, min_epoch: int = 1,
                       timeout: float = 10.0) -> dict:
        return self._wait_for_map("fsmap", min_epoch, timeout)

    def wait_for_mgrmap(self, min_epoch: int = 1,
                        timeout: float = 10.0) -> dict:
        return self._wait_for_map("mgrmap", min_epoch, timeout)

    def wait_for_osdmap(self, min_epoch: int = 1,
                        timeout: float = 10.0) -> dict:
        return self._wait_for_map("osdmap", min_epoch, timeout)

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, M.MMonPing):
            self._last_ack = time.monotonic()
            if msg.quorum is not None and not msg.quorum:
                # mon is alive but outside quorum: it serves no events
                # or fresh maps — hunt one that does.  Subscriptions
                # re-send (and the mon re-snapshots) on reconnect.
                con, self._con = self._con, None
                if con is not None:
                    try:
                        con.mark_down()
                    except Exception:   # noqa: BLE001
                        pass
            return True
        if isinstance(msg, M.MMonCommandReply):
            with self._lock:
                waiter = self._waiters.get(msg.tid)
                if waiter:
                    waiter[1].append(msg)
                    waiter[0].set()
            return True
        if isinstance(msg, M.MFSMapMsg):
            if msg.epoch >= self.fsmap_epoch:
                self.fsmap_epoch = msg.epoch
                self.fsmap_dict = msg.fsmap
                if self.on_fsmap:
                    self.on_fsmap(msg.epoch, msg.fsmap)
            return True
        if isinstance(msg, M.MMgrMapMsg):
            if msg.epoch >= self.mgrmap_epoch:
                self.mgrmap_epoch = msg.epoch
                self.mgrmap_dict = msg.mgrmap
                if self.on_mgrmap:
                    self.on_mgrmap(msg.epoch, msg.mgrmap)
            return True
        if isinstance(msg, M.MMonEvent):
            cb = self.on_event
            if cb is not None:
                cb(msg.kind, msg.data, msg.stamp)
            return True
        if isinstance(msg, M.MOSDMapMsg):
            if msg.epoch >= self.osdmap_epoch:
                self.osdmap_epoch = msg.epoch
                self.osdmap_dict = msg.osdmap
                # advance a range subscription so a reconnect resumes
                # from the next unseen epoch instead of replaying all
                if self._subs.get("osdmap", 0) > 0:
                    self._subs["osdmap"] = max(self._subs["osdmap"],
                                               msg.epoch + 1)
                if self.on_osdmap:
                    newest = msg.newest if msg.newest is not None \
                        else msg.epoch
                    self.on_osdmap(msg.epoch, msg.osdmap, newest)
            return True
        return False

    def ms_handle_reset(self, con):
        if con is self._con:
            self._con = None
