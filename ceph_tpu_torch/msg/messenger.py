"""The messenger: asyncio frames, handshake, auth, resume, injection.

The port's copy of ``ceph_tpu.msg.messenger``.

Reference behavior re-created (``src/msg/async/AsyncMessenger.cc``,
``ProtocolV2.{h,cc}``, ``frames_v2``; SURVEY.md §3.2):

- banner + hello exchange (entity name, address, features, mode) on
  connect;
- optional CephX-style authorizer check during the handshake
  (``core.auth``): the accepting side verifies the ticket, both sides
  then share a session key;
- connection modes, negotiated in the handshake and required to match
  (the reference's ``ms_mode`` crc/secure pair,
  ``ProtocolV2.cc``):
  * **crc**: frames ``u32 len | u8 tag | u32 crc | payload [| 8B
    sig]`` — integrity only; with a session key each frame is also
    HMAC-signed;
  * **secure**: post-handshake frames are AES-128-GCM encrypted with
    the session key (nonce ‖ ciphertext ‖ gcm-tag, AAD = frame tag),
    crc over the ciphertext; confidentiality AND tamper rejection —
    a flipped bit fails the GCM tag and faults the transport.  Secure
    mode refuses to come up without an authenticated session key.
- per-connection ordered delivery with sequence numbers, acks, replay
  of unacked messages after reconnect, and receive-side dedup — the
  msgr2 session-resume contract;
- ``ms_inject_socket_failures``: randomly cut the socket every ~1/N
  sends (the reference's fault-injection knob, used by the tests).

Public API mirrors the reference: ``Messenger(entity)``, ``bind()``,
``add_dispatcher()``, ``connect_to(addr)`` → ``Connection`` with
``send_message(msg)``; dispatch callbacks run on the messenger thread.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass

from ..core.auth import AuthError, CryptoKey, ServiceVerifier
from ..core.encoding import DecodeError
from .fault import DELAY, DROP, DUP, PARTITION, REORDER, FaultInjector
from .message import Message

BANNER = b"ceph-tpu msgr2\n"

TAG_HELLO = 1
TAG_AUTH = 2
TAG_AUTH_REPLY = 3
TAG_MSG = 4
TAG_ACK = 5
TAG_KEEPALIVE = 6
TAG_RESET = 7


@dataclass(frozen=True)
class EntityAddr:
    host: str
    port: int
    nonce: int = 0

    def __str__(self):
        return f"{self.host}:{self.port}/{self.nonce}"


# everything a failed/garbled handshake can throw; retrying is right for
# each (a peer mid-restart can emit any of them)
_HANDSHAKE_ERRORS = (ConnectionError, OSError, EOFError, ValueError,
                     KeyError, struct.error)


async def _read_json(r: asyncio.StreamReader) -> dict:
    """One length-prefixed JSON handshake blob."""
    (n,) = struct.unpack("<I", await r.readexactly(4))
    if n > 1 << 20:
        raise ConnectionError("handshake blob too large")
    return json.loads((await r.readexactly(n)).decode())


class Dispatcher:
    """Reference Dispatcher: subclass and register via
    add_dispatcher(); first dispatcher returning True consumes."""

    def ms_dispatch(self, msg: Message) -> bool:  # noqa: ARG002
        return False

    def ms_handle_reset(self, con: "Connection"):
        pass

    def ms_handle_accept(self, con: "Connection"):
        pass


class Connection:
    """One peer session (survives socket reconnects)."""

    def __init__(self, msgr: "Messenger", peer_addr: EntityAddr | None,
                 outgoing: bool):
        self.msgr = msgr
        self.peer_addr = peer_addr
        self.peer_name: str | None = None
        self.peer_nonce: int | None = None  # peer process incarnation
        self.outgoing = outgoing
        self.session_key: CryptoKey | None = None
        self.secure = False          # negotiated AES-GCM frame mode
        self.out_seq = 0
        self.in_seq = 0
        self._unacked: dict[int, Message] = {}
        self._send_q: asyncio.Queue = asyncio.Queue()
        self._writer: asyncio.StreamWriter | None = None
        self._closed = False
        self._tasks: list[asyncio.Task] = []
        self._reconnect_task: asyncio.Task | None = None  # strong ref:
        # asyncio keeps only weak task refs; an unreferenced reconnect
        # task gets garbage-collected MID-HANDSHAKE (GeneratorExit)
        self._gen = 0     # transport incarnation; stale-failure guard

    # -- public (thread-safe) ---------------------------------------------
    def send_message(self, msg: Message):
        if self._closed:
            raise ConnectionError("connection closed")
        if self._send_q.qsize() >= self.msgr.max_queued:
            # a dead peer must not grow an unbounded backlog; senders
            # (heartbeats, elections) retry at the protocol level
            raise ConnectionError("send queue full (peer unreachable?)")
        tracer = self.msgr.tracer
        span = None
        if tracer is not None and tracer.enabled:
            ctx = getattr(msg, "trace", None)
            if ctx:
                span = tracer.start_span(
                    f"wire_send:{type(msg).__name__}", parent=ctx,
                    tags={"layer": "wire",
                          "peer": self.peer_name or (
                              f"{self.peer_addr.host}:"
                              f"{self.peer_addr.port}"
                              if self.peer_addr else "?")})
        faults = self.msgr.faults
        if faults.active:
            dst = self.peer_name or (
                f"{self.peer_addr.host}:{self.peer_addr.port}"
                if self.peer_addr else "?")
            d = faults.decide(self.msgr.entity_name, dst)
            if span is not None and d.verdict is not None:
                span.set_tag("fault", d.verdict)
            if d.verdict in (DROP, PARTITION):
                if span is not None:
                    span.finish()
                return           # lost on the wire; protocols retry
            if d.verdict in (DELAY, REORDER):
                # late enqueue: anything sent inside the hold window
                # overtakes this message (seq is assigned at dequeue,
                # so the scramble is a real logical-order inversion)
                if span is not None:
                    span.set_tag("hold_s", round(d.hold_s, 6))
                    span.finish()
                self.msgr._call_soon(
                    self.msgr._loop.call_later, d.hold_s,
                    self._send_q.put_nowait, msg)
                return
            if d.verdict == DUP:
                # enqueue twice: the second pass gets a fresh seq, so
                # the session-layer dedup does NOT absorb it and the
                # application sees a true duplicate delivery
                self.msgr._call_soon(self._send_q.put_nowait, msg)
        if span is not None:
            span.finish()
        self.msgr._call_soon(self._send_q.put_nowait, msg)

    def mark_down(self):
        self.msgr._call_soon(self._do_close)

    @property
    def is_connected(self) -> bool:
        return self._writer is not None and not self._closed

    # -- loop-side internals ----------------------------------------------
    def _do_close(self):
        self._closed = True
        for t in self._tasks:
            t.cancel()
        if self._writer:
            self._writer.close()
            self._writer = None
        self.msgr._conn_closed(self)

    async def _write_frame(self, tag: int, payload: bytes):
        w = self._writer
        if w is None:
            raise ConnectionError("not connected")
        if self.msgr.inject_socket_failures:
            if self.msgr.faults.socket_cut(
                    self.msgr.inject_socket_failures):
                # simulate a cut link: kill the transport only; session
                # state stays for resume
                w.transport.abort()
                raise ConnectionError("injected socket failure")
        if self.secure:
            # AES-GCM with the frame tag as AAD: moving a ciphertext
            # under a different tag fails authentication, same as a
            # flipped payload bit
            wire = self.session_key.encrypt(payload, aad=bytes([tag]))
            crc = zlib.crc32(wire) & 0xFFFFFFFF
            frame = struct.pack("<IBI", len(wire) + 5, tag, crc) + wire
        else:
            crc = zlib.crc32(payload) & 0xFFFFFFFF
            frame = struct.pack("<IBI", len(payload) + 5 +
                                (8 if self.session_key else 0), tag, crc)
            frame += payload
            if self.session_key:
                frame += self.session_key.sign(payload)
        w.write(frame)
        await w.drain()

    async def _sender(self, gen: int):
        try:
            while True:
                msg = await self._send_q.get()
                self.out_seq += 1
                msg.seq = self.out_seq
                self._unacked[msg.seq] = msg
                await self._write_frame(TAG_MSG, msg.encode())
        except asyncio.CancelledError:
            pass
        except (ConnectionError, OSError):
            await self._on_transport_fail(gen)

    async def _read_frame(self, r: asyncio.StreamReader):
        hdr = await r.readexactly(9)
        length, tag, crc = struct.unpack("<IBI", hdr)
        body = await r.readexactly(length - 5)
        if self.secure:
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                raise ConnectionError("frame crc mismatch")
            try:
                payload = self.session_key.decrypt(body,
                                                   aad=bytes([tag]))
            except AuthError as e:
                # tampered or spliced ciphertext: GCM authentication
                # failed — poison the transport, never deliver
                raise ConnectionError(f"secure frame rejected: {e}") \
                    from None
            return tag, payload
        siglen = 8 if self.session_key else 0
        payload = body[:len(body) - siglen]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ConnectionError("frame crc mismatch")
        if siglen:
            if not self.session_key.verify(payload, body[-8:]):
                raise ConnectionError("frame signature mismatch")
        return tag, payload

    async def _reader(self, r: asyncio.StreamReader, gen: int):
        try:
            while True:
                tag, payload = await self._read_frame(r)
                if tag == TAG_MSG:
                    try:
                        msg = Message.decode(payload)
                    except ValueError:
                        # unknown message TYPE (version skew): the frame
                        # is CRC-valid, so consume it — take the seq from
                        # the fixed header offset, ack, and drop, exactly
                        # so a newer peer doesn't replay it forever
                        seq = struct.unpack_from("<Q", payload, 2)[0]
                        if seq == self.in_seq + 1:
                            self.in_seq = seq
                        await self._write_frame(
                            TAG_ACK, struct.pack("<Q", self.in_seq))
                        continue
                    if msg.seq != self.in_seq + 1:
                        # duplicate (≤ in_seq: replay after a lost ack)
                        # or a GAP (a stale transport's buffered frames
                        # racing the resumed one): drop either, and
                        # RE-ACK the cumulative position so the peer
                        # trims/replays correctly instead of forever
                        await self._write_frame(
                            TAG_ACK, struct.pack("<Q", self.in_seq))
                        continue
                    self.in_seq = msg.seq
                    msg.connection = self
                    # dispatch BEFORE the ack write: the ack await can
                    # raise on a dying transport, and a message whose
                    # in_seq already advanced would then be swallowed —
                    # deliver-then-ack + dedup = exactly-once
                    self.msgr._dispatch(msg)
                    await self._write_frame(
                        TAG_ACK, struct.pack("<Q", msg.seq))
                elif tag == TAG_ACK:
                    (seq,) = struct.unpack("<Q", payload)
                    for s in [s for s in self._unacked if s <= seq]:
                        del self._unacked[s]
                elif tag == TAG_KEEPALIVE:
                    pass
                elif tag == TAG_RESET:
                    raise ConnectionError("peer reset")
        except asyncio.CancelledError:
            pass
        except (asyncio.IncompleteReadError, EOFError, ConnectionError,
                OSError, struct.error, DecodeError):
            # malformed frame/payload = poisoned transport: fault it so
            # the session resumes instead of the reader dying silently
            await self._on_transport_fail(gen)

    async def _on_transport_fail(self, gen: int):
        if self._closed or gen != self._gen:
            return    # a newer transport already took over
        self._gen += 1  # invalidate concurrent failure reports
        self.msgr.transport_faults += 1
        if self._writer:
            self._writer.close()
            self._writer = None
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        if self.outgoing:
            if self.msgr.reconnect:
                if self._reconnect_task and not \
                        self._reconnect_task.done():
                    return  # one reconnect loop is already working
                self._reconnect_task = self.msgr._loop.create_task(
                    self._reconnect())
            else:
                self._closed = True
                self.msgr._conn_closed(self)
                self.msgr._notify_reset(self)
        # incoming: keep the session (in_seq, unacked) registered so the
        # peer can resume — the msgr2 lossless-connection contract; the
        # session dies only via mark_down()/shutdown()

    async def _reconnect(self):
        backoff = 0.02
        while not self._closed:
            try:
                await self.msgr._establish(self, resume=True)
                return
            except _HANDSHAKE_ERRORS:
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2,
                              self.msgr.reconnect_backoff_max)
        self.msgr._notify_reset(self)

    async def _start_io(self, r: asyncio.StreamReader,
                        w: asyncio.StreamWriter, peer_in_seq: int):
        """Common tail of connect/accept: drop acked, REPLAY unacked
        (before the sender task starts, so replays can't interleave
        with new sends), then run reader+sender."""
        self._gen += 1
        gen = self._gen
        self._writer = w
        for s in [s for s in self._unacked if s <= peer_in_seq]:
            del self._unacked[s]
        # reader first: replayed frames get acked WHILE we replay, so a
        # mid-replay transport cut still made progress (the next resume
        # replays only what remains) — without this, a long unacked
        # backlog under failure injection can never fully replay
        self._tasks = [self.msgr._loop.create_task(self._reader(r, gen))]
        if self._unacked:
            # flush per frame during replay: a cut (transport.abort)
            # discards the asyncio write buffer, so without this a large
            # buffered replay loses EVERY frame of the attempt and the
            # session never converges under failure injection
            w.transport.set_write_buffer_limits(0)
            try:
                for seq in sorted(self._unacked):
                    msg = self._unacked.get(seq)
                    if msg is None:
                        continue   # acked concurrently by the new reader
                    await self._write_frame(TAG_MSG, msg.encode())
            finally:
                w.transport.set_write_buffer_limits()
        self._tasks.append(self.msgr._loop.create_task(self._sender(gen)))


class Messenger:
    def __init__(self, entity_name: str, *,
                 keyring_key: CryptoKey | None = None,
                 verifier: ServiceVerifier | None = None,
                 session_ticket=None,
                 mode: str = "crc",
                 inject_socket_failures: int = 0,
                 fault_injector: FaultInjector | None = None,
                 inject_seed: int | None = None,
                 reconnect: bool = True,
                 reconnect_backoff_max: float = 2.0,
                 max_queued: int = 4096):
        """`verifier` makes the accepting side demand an authorizer;
        `session_ticket` (core.auth.SessionTicket, or a zero-arg
        callable returning one — a factory lets long-lived daemons
        present FRESH tickets so reconnects keep working past the
        ticket TTL) makes the connecting side present one.  Both
        None ⇒ AUTH_NONE mode.

        `mode` is the reference's ms_mode: "crc" (integrity) or
        "secure" (AES-GCM frame encryption; requires auth on both
        roles — secure peers refuse to talk to crc peers and vice
        versa, so a cluster runs one mode)."""
        if mode not in ("crc", "secure"):
            raise ValueError(f"unknown ms_mode {mode!r}")
        if mode == "secure" and verifier is None and \
                session_ticket is None:
            raise ValueError(
                "secure mode requires auth (verifier and/or ticket): "
                "there is no session key to encrypt with otherwise")
        self.mode = mode
        self.entity_name = entity_name
        self.my_addr: EntityAddr | None = None
        self.verifier = verifier
        self.session_ticket = session_ticket
        self.keyring_key = keyring_key
        self.inject_socket_failures = inject_socket_failures
        # every injection decision (socket cuts included) routes
        # through this seeded policy table — the deterministic-replay
        # contract lives in msg/fault.py
        self.faults = fault_injector or FaultInjector(seed=inject_seed)
        self.reconnect = reconnect
        self.reconnect_backoff_max = reconnect_backoff_max
        self.max_queued = max_queued
        # core.tracer.Tracer attached by the owning daemon; wire
        # spans are only cut for messages already carrying a trace
        # ctx, so heartbeats/elections stay span-free
        self.tracer = None
        self.dispatchers: list[Dispatcher] = []
        self.connections: list[Connection] = []
        # observability: every EPIPE/ECONNRESET/half-open cut that was
        # absorbed as a clean connection fault (tests assert >0 after
        # killing a peer process instead of grepping for tracebacks)
        self.transport_faults = 0
        self._down = False
        self._server: asyncio.AbstractServer | None = None
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name=f"msgr-{entity_name}",
            daemon=True)
        self._thread.start()
        self._nonce = int.from_bytes(os.urandom(4), "little")

    # -- lifecycle ---------------------------------------------------------
    def add_dispatcher(self, d: Dispatcher):
        self.dispatchers.append(d)

    def bind(self, host: str = "127.0.0.1", port: int = 0) -> EntityAddr:
        fut = asyncio.run_coroutine_threadsafe(
            self._bind(host, port), self._loop)
        self.my_addr = fut.result(10)
        return self.my_addr

    async def _bind(self, host, port):
        self._server = await asyncio.start_server(
            self._accept, host, port)
        sock = self._server.sockets[0]
        return EntityAddr(host, sock.getsockname()[1], self._nonce)

    def shutdown(self):
        async def _stop():
            # cancel, then AWAIT, every task before stopping the loop —
            # stop() in the same callback leaves the cancellations
            # unprocessed and the interpreter prints "Task was
            # destroyed but it is pending!" for each at GC time
            for c in list(self.connections):
                c._closed = True
                c._tasks = []
                c._reconnect_task = None
                if c._writer:
                    c._writer.close()
                    c._writer = None
                self._conn_closed(c)
            if self._server:
                self._server.close()
            # sweep EVERY task on this loop — connection readers/
            # senders, reconnect loops, AND in-flight _accept handlers
            # (start_server spawns those; we hold no reference to them).
            # Loop until drained: a cross-thread callback queued before
            # _down was set can spawn a task while gather() yields
            while True:
                pending = [t for t in asyncio.all_tasks()
                           if t is not asyncio.current_task()]
                if not pending:
                    break
                for t in pending:
                    t.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
            self._loop.stop()
        if self._down or self._loop.is_closed():
            return    # double shutdown
        self._down = True
        try:
            asyncio.run_coroutine_threadsafe(_stop(), self._loop)
        except RuntimeError:
            return    # loop already gone
        self._thread.join(timeout=5)
        if not self._thread.is_alive():
            self._loop.close()

    # -- connecting --------------------------------------------------------
    def connect_to(self, addr: EntityAddr) -> Connection:
        con = Connection(self, addr, outgoing=True)
        fut = asyncio.run_coroutine_threadsafe(
            self._establish(con, resume=False), self._loop)
        fut.result(10)
        self.connections.append(con)
        return con

    def connect_to_lazy(self, addr: EntityAddr) -> Connection:
        """Non-blocking connect: returns immediately; messages queue and
        flow once the handshake lands; failures retry via the normal
        reconnect loop.  REQUIRED when calling from a dispatch handler —
        the blocking connect_to would deadlock the messenger's own loop."""
        con = Connection(self, addr, outgoing=True)
        self.connections.append(con)

        async def _first():
            try:
                await self._establish(con, resume=False)
            except _HANDSHAKE_ERRORS:
                if self.reconnect:
                    await con._reconnect()  # loops until success/close
                else:
                    con._closed = True
                    self._conn_closed(con)
                    self._notify_reset(con)

        def _spawn():
            if self._down:
                return    # raced shutdown(): don't spawn past the sweep
            con._reconnect_task = self._loop.create_task(_first())

        # create_task is NOT thread-safe and won't wake a foreign
        # loop's selector; route through the self-pipe (_call_soon also
        # absorbs the post-shutdown closed-loop RuntimeError)
        self._call_soon(_spawn)
        return con

    async def _establish(self, con: Connection, resume: bool):
        r, w = await asyncio.open_connection(
            con.peer_addr.host, con.peer_addr.port)
        w.write(BANNER)
        hello = {
            "entity": self.entity_name,
            "nonce": self._nonce,
            "in_seq": con.in_seq if resume else 0,
            "resume": resume,
            "mode": self.mode,
        }
        # resolve the ticket per attempt: a factory re-mints, so a
        # reconnect hours later presents a fresh (unexpired) ticket
        ticket = (self.session_ticket()
                  if callable(self.session_ticket)
                  else self.session_ticket)
        if ticket is not None:
            # ticket only; the proof answers the SERVER's challenge in
            # the next round (a client-chosen nonce would make captured
            # handshakes replayable)
            hello["authorizer"] = {
                "entity": ticket.entity,
                "ticket": ticket.ticket.hex(),
            }
        payload = json.dumps(hello).encode()
        w.write(struct.pack("<I", len(payload)) + payload)
        await w.drain()
        banner = await r.readexactly(len(BANNER))
        if banner != BANNER:
            raise ConnectionError("bad banner")
        reply = await _read_json(r)
        if "challenge" in reply:
            if ticket is None:
                raise ConnectionError("server demands auth, no ticket")
            proof = ticket.session_key.sign(
                bytes.fromhex(reply["challenge"]))
            payload = json.dumps({"proof": proof.hex()}).encode()
            w.write(struct.pack("<I", len(payload)) + payload)
            await w.drain()
            reply = await _read_json(r)
        if reply.get("error"):
            raise ConnectionError(f"handshake refused: {reply['error']}")
        if reply.get("mode", "crc") != self.mode:
            raise ConnectionError(
                f"ms_mode mismatch: we={self.mode} "
                f"peer={reply.get('mode', 'crc')}")
        con.peer_name = reply.get("entity")
        peer_nonce = reply.get("nonce")
        if (resume and peer_nonce is not None
                and con.peer_nonce is not None
                and peer_nonce != con.peer_nonce):
            # the peer PROCESS died and came back (kill -9 + respawn on
            # the same addr): its session state — our in_seq as it knew
            # it, its out stream — is gone.  Rebase instead of replaying
            # old seqs at a server that would see them as a gap and
            # re-ack 0 forever: restart its incoming stream at 1 by
            # renumbering our unacked backlog in order, and accept its
            # fresh outgoing stream from 1.  Dedup against the old
            # incarnation is impossible (it took its receive state to
            # the grave), so redelivery of acked-but-unapplied work is
            # the application contract, same as any daemon restart.
            replay = [con._unacked[s] for s in sorted(con._unacked)]
            con._unacked = {}
            for i, m in enumerate(replay, 1):
                m.seq = i
                con._unacked[i] = m
            con.out_seq = len(replay)
            con.in_seq = 0
        if peer_nonce is not None:
            con.peer_nonce = peer_nonce
        if ticket is not None:
            con.session_key = ticket.session_key
        con.secure = (self.mode == "secure")
        if con.secure and con.session_key is None:
            raise ConnectionError("secure mode without a session key")
        await con._start_io(r, w, reply.get("in_seq", 0))

    # -- accepting ---------------------------------------------------------
    async def _accept(self, r: asyncio.StreamReader,
                      w: asyncio.StreamWriter):
        try:
            banner = await r.readexactly(len(BANNER))
            if banner != BANNER:
                w.close()
                return
            hello = await _read_json(r)
            session_key = None
            banner_sent = False
            if hello.get("mode", "crc") != self.mode:
                payload = json.dumps({
                    "error": f"ms_mode mismatch: we={self.mode} "
                             f"peer={hello.get('mode', 'crc')}"}
                ).encode()
                w.write(BANNER + struct.pack("<I", len(payload))
                        + payload)
                await w.drain()
                w.close()
                return
            if self.verifier is not None:
                try:
                    authz = hello.get("authorizer")
                    if not authz:
                        raise AuthError("authorizer required")
                    # challenge-response: WE pick the nonce, so captured
                    # handshakes cannot be replayed
                    challenge = os.urandom(16)
                    payload = json.dumps(
                        {"challenge": challenge.hex()}).encode()
                    w.write(BANNER + struct.pack("<I", len(payload))
                            + payload)
                    banner_sent = True
                    await w.drain()
                    answer = await _read_json(r)
                    entity, session_key, _caps = \
                        self.verifier.verify_authorizer(
                            {"entity": authz["entity"],
                             "ticket": bytes.fromhex(authz["ticket"]),
                             "proof": bytes.fromhex(answer["proof"])},
                            challenge)
                    # the hello's entity is unauthenticated; bind the
                    # session to the ticket-verified identity so a valid
                    # ticket for A cannot splice into B's session
                    if hello.get("entity") != entity:
                        raise AuthError(
                            "hello entity does not match ticket")
                except (AuthError, KeyError, ValueError) as e:
                    payload = json.dumps({"error": str(e)}).encode()
                    prefix = b"" if banner_sent else BANNER
                    w.write(prefix + struct.pack("<I", len(payload))
                            + payload)
                    await w.drain()
                    w.close()
                    return
        except (asyncio.IncompleteReadError, EOFError, OSError,
                ValueError, KeyError, json.JSONDecodeError,
                struct.error):
            w.close()
            return
        # session resume: find the existing session from this exact peer
        # incarnation — (entity, nonce), not entity alone, so two
        # connections from one entity can't splice each other's state
        con = None
        if hello.get("resume"):
            for c in self.connections:
                if (c.peer_name == hello["entity"]
                        and c.peer_nonce == hello.get("nonce")
                        and not c.outgoing and not c._closed):
                    con = c
                    break
        if con is None:
            con = Connection(self, None, outgoing=False)
            con.peer_name = hello["entity"]
            con.peer_nonce = hello.get("nonce")
            self.connections.append(con)
            for d in self.dispatchers:
                d.ms_handle_accept(con)
        con.session_key = session_key
        con.secure = (self.mode == "secure")
        if con.secure and session_key is None:
            # secure without an authenticated key is a contradiction;
            # the ctor enforces verifier-presence, so this only trips
            # if auth was skipped by a code path change — refuse loudly
            payload = json.dumps(
                {"error": "secure mode without session key"}).encode()
            prefix = b"" if banner_sent else BANNER
            w.write(prefix + struct.pack("<I", len(payload)) + payload)
            await w.drain()
            w.close()
            return
        reply = {"entity": self.entity_name, "in_seq": con.in_seq,
                 "nonce": self._nonce, "mode": self.mode}
        payload = json.dumps(reply).encode()
        prefix = b"" if banner_sent else BANNER
        w.write(prefix + struct.pack("<I", len(payload)) + payload)
        await w.drain()
        # cancel stale tasks from a previous transport incarnation
        for t in con._tasks:
            t.cancel()
        await con._start_io(r, w, hello.get("in_seq", 0))

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, msg: Message):
        tracer = self.tracer
        span = None
        if tracer is not None and tracer.enabled:
            ctx = getattr(msg, "trace", None)
            if ctx:
                span = tracer.start_span(
                    f"wire_recv:{type(msg).__name__}", parent=ctx,
                    tags={"layer": "wire"})
        try:
            for d in self.dispatchers:
                try:
                    if d.ms_dispatch(msg):
                        return
                except Exception:  # noqa: BLE001 — a dispatcher must
                    import traceback  # not kill the messenger thread
                    traceback.print_exc()
                    return
            # undispatched messages are dropped, as the reference does
        finally:
            if span is not None:
                span.finish()

    def _notify_reset(self, con: Connection):
        for d in self.dispatchers:
            d.ms_handle_reset(con)

    def _conn_closed(self, con: Connection):
        if con in self.connections:
            self.connections.remove(con)

    def _call_soon(self, fn, *args):
        try:
            self._loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass    # loop closed by shutdown(); nothing left to do
