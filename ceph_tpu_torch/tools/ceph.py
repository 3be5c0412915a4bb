"""ceph CLI — mon command dispatch (reference ``src/ceph.in``).

The port's copy of ``ceph_tpu.tools.ceph``.

    ceph -m HOST:PORT[,...] status|-s | health | df | osd df
    ceph -m ... -w [--count N] [--timeout S] [--filter CODE]
        (live event stream; --filter narrows to one health code)
    ceph -m ... health detail | health history
    ceph -m ... health mute CODE [TTL_SECONDS] [--sticky]
    ceph -m ... health unmute CODE
    ceph -m ... crash ls|ls-new|archive-all | crash info|rm|archive ID
        (mgr crash archive — post-mortems from revived daemons)
    ceph -m ... progress [json]   (mgr progress events)
    ceph -m ... iostat [json]     (live rates from the telemetry spine)
    ceph -m ... osd perf [json]   (commit latency + device launches)
    ceph -m ... osd top [clients|pools|pgs] [--by ops|bytes|p99]
        [--count N] [json]   (cluster-merged heavy hitters)
    ceph -m ... alerts [status|history|rules [KNOB [VAL]]|
        silence NAME [TTL|--off]|enable [SEED]|disable]
    ceph -m ... tracing exemplar [METRIC [BUCKET]]
        (slowest-op trace id per latency histogram bucket)
    ceph -m ... pg stat | pg dump
    ceph -m ... osd tree | osd dump | osd stat | osd pool ls
    ceph -m ... osd pool create NAME [--pg-num N] [--size N] [--type T]
        [--compression-mode M] [--compression-algorithm A] [--dedup]
    ceph -m ... osd pool set POOL VAR VAL | osd pool get POOL [VAR]
        (VAR incl. compression_mode|compression_algorithm|dedup_enable)
    ceph -m ... osd out ID | osd in ID | osd down ID
    ceph -m ... osd reweight ID WEIGHT
    ceph -m ... osd pool mksnap POOL SNAP | rmsnap POOL SNAP
    ceph -m ... osd pg-upmap-items PGID FROM TO [FROM TO ...]
    ceph -m ... log last [N] [cluster|audit] | log MESSAGE...
    ceph -m ... daemon SOCK_PATH COMMAND [k=v ...]
        (e.g. daemon <asok> dump_tracing [format=otlp] |
         trace start|stop|clear | profiler dump|reset |
         dump_historic_ops_by_duration | perf histogram dump)
        (e.g. daemon <asok> injectargs args="op_complaint_time=5",
         daemon <asok> fault show | fault set dst=osd.1 drop=0.3 |
         fault partition dst=osd.2 | fault heal — the seeded
         network-chaos injector, see msg/fault.py)

Free-form: any unrecognized argument list is sent as
{"prefix": "<joined words>"} — the same pass-through the reference CLI
does with its command descriptions."""

from __future__ import annotations

import argparse
import json
import sys

from ..core.admin_socket import admin_command
from ..mon.client import MonClient
from .rados import _monmap_from_addrs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="ceph", add_help=False)
    p.add_argument("-m", "--mon")
    args, rest = p.parse_known_args(argv)
    if not rest:
        print(__doc__)
        return 1

    try:
        return _dispatch(args, rest)
    except (IndexError, ValueError):
        print(__doc__)
        return 1


def _run_mgr_command(mc, cmd: dict) -> int:
    """Send one mgr-hosted command and print the standard output
    shape (shared by the orch and device branches)."""
    rc, outs, outb = mc.mgr_command(cmd)
    if outb is not None:
        print(json.dumps(outb, indent=2, default=str))
    if outs:
        print(outs, file=sys.stderr)
    return 0 if rc == 0 else 1


def _dispatch(args, rest) -> int:
    if rest[0] == "daemon":
        # `ceph daemon <asok> <cmd> [k=v ...]` — local admin socket
        sock, words, kvs = rest[1], [], {}
        toks = rest[2:]
        i = 0
        while i < len(toks):
            tok = toks[i]
            if tok.startswith("--") and "=" in tok:
                k, v = tok[2:].split("=", 1)
                kvs[k] = v
            elif tok.startswith("--") and i + 1 < len(toks):
                kvs[tok[2:]] = toks[i + 1]
                i += 1
            elif "=" in tok:
                k, v = tok.split("=", 1)
                kvs[k] = v
            else:
                words.append(tok)
            i += 1
        out = admin_command(sock, " ".join(words), **kvs)
        print(json.dumps(out, indent=2, default=str))
        return 0

    if rest[0] in ("-w", "--watch", "watch"):
        # `ceph -w` — live event stream (health transitions, clog,
        # progress); --count/--timeout bound it for scripting;
        # --filter CODE prints only events about that health check
        # (repeatable — any match passes)
        sub = argparse.ArgumentParser(prog="ceph -w")
        sub.add_argument("--count", type=int, default=0)
        sub.add_argument("--timeout", type=float, default=0.0)
        sub.add_argument("--filter", action="append", default=[])
        a = sub.parse_args(rest[1:])
        if not args.mon:
            raise SystemExit("ceph: -m HOST:PORT required")
        mc = MonClient(_monmap_from_addrs(args.mon))
        try:
            return _watch(mc, count=a.count, timeout=a.timeout,
                          codes=[c.upper() for c in a.filter])
        finally:
            mc.shutdown()

    if not args.mon:
        raise SystemExit("ceph: -m HOST:PORT required")
    mc = MonClient(_monmap_from_addrs(args.mon))
    try:
        if rest[0] == "device" and len(rest) >= 2:
            # mgr-hosted devicehealth commands
            cmd = {"prefix": f"device {rest[1]}"}
            if rest[1] == "info" and len(rest) > 2:
                cmd["devid"] = rest[2]
            return _run_mgr_command(mc, cmd)
        if rest[0] == "crash":
            # mgr-hosted crash archive (reference `ceph crash ...`)
            usage = ("usage: ceph crash ls|ls-new|archive-all | "
                     "crash info|rm|archive ID")
            verb = rest[1] if len(rest) > 1 else "ls"
            if verb not in ("ls", "ls-new", "info", "rm", "archive",
                            "archive-all"):
                print(usage, file=sys.stderr)
                return 1
            cmd = {"prefix": f"crash {verb}"}
            if verb in ("info", "rm", "archive"):
                if len(rest) < 3:
                    print(usage, file=sys.stderr)
                    return 1
                cmd["id"] = rest[2]
            return _run_mgr_command(mc, cmd)
        if rest[0] == "orch":
            # mgr-hosted orchestrator commands (reference `ceph orch`
            # → mon → active mgr → cephadm); transport: mgr_command
            usage = ("usage: ceph orch ls|ps | "
                     "orch apply TYPE [COUNT] | orch rm TYPE")
            if len(rest) < 2 or rest[1] not in ("ls", "ps", "apply",
                                                "rm"):
                print(usage, file=sys.stderr)
                return 1
            cmd = {"prefix": f"orch {rest[1]}"}
            if rest[1] == "apply":
                if len(rest) < 3 or (len(rest) > 3
                                     and not rest[3].isdigit()):
                    print(usage, file=sys.stderr)
                    return 1
                cmd["service_type"] = rest[2]
                if len(rest) > 3:
                    cmd["count"] = int(rest[3])
            elif rest[1] == "rm":
                if len(rest) < 3:
                    print(usage, file=sys.stderr)
                    return 1
                cmd["service_type"] = rest[2]
            return _run_mgr_command(mc, cmd)
        cmd: dict = {}
        if rest[0] == "osd" and rest[1:2] == ["pool"] and \
                rest[2:3] == ["create"]:
            sub = argparse.ArgumentParser()
            sub.add_argument("name")
            sub.add_argument("--pg-num", type=int, default=32)
            sub.add_argument("--size", type=int, default=3)
            sub.add_argument("--type", default="replicated")
            sub.add_argument("--profile", default="")
            sub.add_argument("--compression-mode", default=None)
            sub.add_argument("--compression-algorithm", default=None)
            sub.add_argument("--dedup", action="store_true",
                             default=None)
            a = sub.parse_args(rest[3:])
            cmd = {"prefix": "osd pool create", "pool": a.name,
                   "pg_num": a.pg_num, "size": a.size,
                   "pool_type": a.type}
            if a.profile:
                cmd["erasure_code_profile"] = a.profile
            if a.compression_mode is not None:
                cmd["compression_mode"] = a.compression_mode
            if a.compression_algorithm is not None:
                cmd["compression_algorithm"] = a.compression_algorithm
            if a.dedup is not None:
                cmd["dedup_enable"] = a.dedup
        elif rest[0] == "osd" and rest[1:2] == ["pool"] and \
                rest[2:3] in (["mksnap"], ["rmsnap"]):
            cmd = {"prefix": f"osd pool {rest[2]}", "pool": rest[3],
                   "snap": rest[4]}
        elif rest[0] == "osd" and rest[1:2] == ["pg-upmap-items"]:
            pairs = [[int(a), int(b)]
                     for a, b in zip(rest[3::2], rest[4::2])]
            cmd = {"prefix": "osd pg-upmap-items", "pgid": rest[2],
                   "mappings": pairs}
        elif rest[0] == "osd" and rest[1:2] in (["out"], ["in"],
                                                ["down"]):
            cmd = {"prefix": f"osd {rest[1]}", "ids": [int(rest[2])]}
        elif rest[0] == "osd" and rest[1:2] in (["set"], ["unset"]) \
                and len(rest) == 3:
            cmd = {"prefix": f"osd {rest[1]}", "key": rest[2]}
        elif rest[0] == "osd" and rest[1:2] == ["pool"] and \
                rest[2:3] == ["set"] and len(rest) == 6:
            # `ceph osd pool set POOL VAR VAL` — the mon coerces the
            # string val per var (pg-num ints, efficiency enums/bools)
            cmd = {"prefix": "osd pool set", "pool": rest[3],
                   "var": rest[4], "val": rest[5]}
        elif rest[0] == "osd" and rest[1:2] == ["pool"] and \
                rest[2:3] == ["get"] and len(rest) >= 4:
            cmd = {"prefix": "osd pool get", "pool": rest[3]}
            if len(rest) > 4:
                cmd["var"] = rest[4]
        elif rest[0] == "osd" and rest[1:2] == ["pool"] and \
                rest[2:3] == ["set-quota"]:
            cmd = {"prefix": "osd pool set-quota", "pool": rest[3],
                   "field": rest[4], "val": rest[5]}
        elif rest[0] == "pg" and rest[1:2] in (["scrub"], ["deep-scrub"],
                                               ["repair"]):
            cmd = {"prefix": f"pg {rest[1]}", "pgid": rest[2]}
        elif rest[0] == "pg" and rest[1:2] == ["list-inconsistent-obj"]:
            cmd = {"prefix": "pg list-inconsistent-obj",
                   "pgid": rest[2]}
        elif rest[0] == "fs" and rest[1:2] == ["set"]:
            cmd = {"prefix": "fs set", "fs_name": rest[2],
                   "var": rest[3], "val": rest[4]}
        elif rest[0] == "fs" and rest[1:2] == ["new"]:
            cmd = {"prefix": "fs new", "fs_name": rest[2],
                   "metadata": rest[3], "data": rest[4]}
        elif rest[0] == "osd" and rest[1:2] == ["tier"]:
            verb = rest[2]
            if verb in ("add", "remove"):
                cmd = {"prefix": f"osd tier {verb}",
                       "pool": rest[3], "tierpool": rest[4]}
            elif verb == "cache-mode":
                cmd = {"prefix": "osd tier cache-mode",
                       "pool": rest[3], "mode": rest[4]}
            elif verb == "set-overlay":
                cmd = {"prefix": "osd tier set-overlay",
                       "pool": rest[3], "overlaypool": rest[4]}
            elif verb == "remove-overlay":
                cmd = {"prefix": "osd tier remove-overlay",
                       "pool": rest[3]}
            else:
                raise ValueError(verb)
        elif rest[0] == "osd" and rest[1:2] == ["reweight"]:
            cmd = {"prefix": "osd reweight", "id": int(rest[2]),
                   "weight": float(rest[3])}
        elif rest[0] == "health" and rest[1:2] == ["mute"]:
            # `ceph health mute CODE [TTL] [--sticky]`
            cmd = {"prefix": "health mute", "code": rest[2]}
            for tok in rest[3:]:
                if tok == "--sticky":
                    cmd["sticky"] = True
                else:
                    cmd["ttl"] = float(tok)
        elif rest[0] == "health" and rest[1:2] == ["unmute"]:
            cmd = {"prefix": "health unmute", "code": rest[2]}
        elif rest[0] == "progress":
            # mgr-hosted progress events
            return _run_mgr_command(mc, {"prefix": "progress"})
        elif rest[0] == "iostat":
            # mgr telemetry spine: live rates from osd_stats deltas
            rc, outs, outb = mc.mgr_command({"prefix": "iostat"})
            if rc == 0 and outb is not None and "json" not in rest[1:]:
                print(_render_iostat(outb))
                # autotune panel rides along when the module is loaded
                arc, _, aout = mc.mgr_command(
                    {"prefix": "autotune status"})
                if arc == 0 and aout:
                    print(_render_autotune(aout))
                return 0
            if outb is not None:
                print(json.dumps(outb, indent=2, default=str))
            if outs:
                print(outs, file=sys.stderr)
            return 0 if rc == 0 else 1
        elif rest[0] == "autotune":
            # mgr autotuner: status|history|enable|disable|pin|unpin
            verb = rest[1] if len(rest) > 1 else "status"
            cmd = {"prefix": f"autotune {verb}"}
            json_out = False
            pos = []
            for tok in rest[2:]:
                if tok == "json":
                    json_out = True
                elif "=" in tok:
                    k, v = tok.split("=", 1)
                    cmd[k] = int(v) if v.lstrip("-").isdigit() else v
                else:
                    pos.append(tok)
            if verb in ("pin", "unpin") and pos:
                cmd["knob"] = pos[0]
                if verb == "pin" and len(pos) > 1:
                    cmd["value"] = pos[1]
            elif verb == "enable" and pos:
                cmd["seed"] = int(pos[0])
            rc, outs, outb = mc.mgr_command(cmd)
            if rc == 0 and verb == "status" and outb and not json_out:
                print(_render_autotune(outb))
                return 0
            if outb is not None:
                print(json.dumps(outb, indent=2, default=str))
            if outs:
                print(outs, file=sys.stderr)
            return 0 if rc == 0 else 1
        elif rest[0] == "osd" and rest[1:2] == ["top"]:
            # `ceph osd top [clients|pools|pgs] [--by ops|bytes|p99]
            #  [--count N] [json]` — cluster-merged heavy hitters
            sub = argparse.ArgumentParser(prog="ceph osd top")
            sub.add_argument("dim", nargs="?", default="clients",
                             choices=("clients", "pools", "pgs"))
            sub.add_argument("--by", default="ops",
                             choices=("ops", "bytes", "p99"))
            sub.add_argument("--count", type=int, default=10)
            # "json" is a bare token, not a positional — argparse
            # refuses positionals after interleaved optionals
            json_out = "json" in rest[2:]
            a = sub.parse_args([t for t in rest[2:] if t != "json"])
            rc, outs, outb = mc.mgr_command(
                {"prefix": "osd top", "dim": a.dim, "by": a.by,
                 "count": a.count})
            if rc == 0 and outb is not None and not json_out:
                print(_render_osd_top(outb))
                return 0
            if outb is not None:
                print(json.dumps(outb, indent=2, default=str))
            if outs:
                print(outs, file=sys.stderr)
            return 0 if rc == 0 else 1
        elif rest[0] == "tracing" and rest[1:2] == ["exemplar"]:
            # `ceph tracing exemplar [METRIC [BUCKET]]` — metric→trace
            # lookup: the slowest-op trace id per histogram bucket
            cmd = {"prefix": "tracing exemplar"}
            if len(rest) > 2:
                cmd["metric"] = rest[2]
            if len(rest) > 3:
                cmd["bucket"] = int(rest[3])
            return _run_mgr_command(mc, cmd)
        elif rest[0] == "alerts":
            # mgr alert rules: status|history|rules|silence|enable|
            # disable
            verb = rest[1] if len(rest) > 1 else "status"
            cmd = {"prefix": f"alerts {verb}"}
            json_out = False
            pos = []
            for tok in rest[2:]:
                if tok == "json":
                    json_out = True
                elif tok == "--off":
                    cmd["off"] = True
                elif "=" in tok:
                    k, v = tok.split("=", 1)
                    cmd[k] = int(v) if v.lstrip("-").isdigit() else v
                else:
                    pos.append(tok)
            if verb == "silence" and pos:
                cmd["name"] = pos[0]
                if len(pos) > 1:
                    cmd["ttl"] = float(pos[1])
            elif verb == "rules" and pos:
                cmd["knob"] = pos[0]
                if len(pos) > 1:
                    cmd["value"] = pos[1]
            elif verb == "enable" and pos:
                cmd["seed"] = int(pos[0])
            rc, outs, outb = mc.mgr_command(cmd)
            if rc == 0 and verb == "status" and outb and not json_out:
                print(_render_alerts(outb))
                return 0
            if outb is not None:
                print(json.dumps(outb, indent=2, default=str))
            if outs:
                print(outs, file=sys.stderr)
            return 0 if rc == 0 else 1
        elif rest[0] == "osd" and rest[1:2] == ["perf"]:
            # commit latency + device-launch breakdown per OSD
            rc, outs, outb = mc.mgr_command({"prefix": "osd perf"})
            if rc == 0 and outb is not None and "json" not in rest[2:]:
                print(_render_osd_perf(outb))
                return 0
            if outb is not None:
                print(json.dumps(outb, indent=2, default=str))
            if outs:
                print(outs, file=sys.stderr)
            return 0 if rc == 0 else 1
        elif rest[0] == "log" and rest[1:2] == ["last"]:
            # `ceph log last [n] [cluster|audit]` — ring tails
            cmd = {"prefix": "log last"}
            for tok in rest[2:]:
                if tok.isdigit():
                    cmd["num"] = int(tok)
                else:
                    cmd["channel"] = tok
        elif rest[0] == "log" and len(rest) > 1:
            # `ceph log <msg...>` — operator entry into the clog
            cmd = {"prefix": "log", "logtext": " ".join(rest[1:])}
        else:
            words = ["status" if w == "-s" else w for w in rest]
            fmt = None
            cleaned = []
            i = 0
            while i < len(words):
                w = words[i]
                if w.startswith("--format="):
                    fmt = w.split("=", 1)[1]
                elif w in ("--format", "-f") and i + 1 < len(words):
                    fmt = words[i + 1]
                    i += 1
                else:
                    cleaned.append(w)
                i += 1
            cmd = {"prefix": " ".join(cleaned),
                   "_render": fmt in (None, "plain")}
        want_render = cmd.pop("_render", False)
        rc, outs, outb = mc.command(cmd)
        if rc == 0 and want_render and outb is not None:
            text = _render(cmd["prefix"], outb)
            if text is not None:
                print(text)
                return 0
        if outb is not None:
            print(json.dumps(outb, indent=2, default=str))
        if outs:
            print(outs, file=sys.stderr)
        return 0 if rc == 0 else 1
    finally:
        mc.shutdown()


def _fmt_event(kind: str, data: dict, stamp: float) -> str | None:
    """One `ceph -w` line per event; None ⇒ suppressed (snapshots)."""
    import datetime
    ts = datetime.datetime.fromtimestamp(
        data.get("stamp", stamp) or stamp).strftime("%H:%M:%S")
    if kind == "clog":
        return (f"{ts} {data.get('channel', 'cluster')} "
                f"[{data.get('prio', 'info').upper()[:3]}] "
                f"{data.get('name', '?')}: {data.get('text', '')}")
    if kind == "health":
        state = data.get("state")
        if state == "snapshot":
            return None     # catch-up frame, not a transition
        if state == "rollup":
            return f"{ts} health: cluster is {data.get('status')}"
        return (f"{ts} health: {data.get('code')} {state} "
                f"({data.get('summary', '')}) → {data.get('status')}")
    if kind == "progress":
        pct = round(float(data.get("progress", 0.0)) * 100)
        return (f"{ts} progress: {data.get('message', '?')} — "
                f"{pct}% ({data.get('state', 'update')})")
    return f"{ts} {kind}: {json.dumps(data, default=str)}"


def _event_matches(kind: str, data: dict, codes: list[str]) -> bool:
    """--filter CODE predicate: health events match on their code,
    clog lines on a mention of the code in their text (the mon logs
    'Health check failed: CODE (...)' transitions), everything else is
    suppressed when a filter is active."""
    if not codes:
        return True
    if kind == "health":
        return data.get("code") in codes
    if kind == "clog":
        text = data.get("text", "")
        return any(c in text for c in codes)
    return False


def _watch(mc: MonClient, count: int = 0, timeout: float = 0.0,
           codes: list[str] | None = None) -> int:
    import queue
    import time as _time
    q: queue.Queue = queue.Queue()
    mc.on_event = lambda kind, data, stamp: q.put((kind, data, stamp))
    mc.sub_want("events", 0)
    printed = 0
    deadline = _time.monotonic() + timeout if timeout > 0 else None
    try:
        while True:
            wait = 1.0 if deadline is None else \
                min(1.0, deadline - _time.monotonic())
            if wait <= 0:
                return 0
            try:
                kind, data, stamp = q.get(timeout=wait)
            except queue.Empty:
                continue
            data = data if isinstance(data, dict) else {}
            if not _event_matches(kind, data, codes or []):
                continue
            line = _fmt_event(kind, data, stamp)
            if line is None:
                continue
            print(line, flush=True)
            printed += 1
            if count and printed >= count:
                return 0
    except KeyboardInterrupt:
        return 0


def _render_iostat(out: dict) -> str:
    """`ceph iostat` panel: one cluster line + one row per OSD."""
    c = out.get("cluster") or {}
    lines = [
        f"cluster: {c.get('ops_per_sec', 0.0):.1f} op/s "
        f"(rd {c.get('read_ops_per_sec', 0.0):.1f}, "
        f"wr {c.get('write_ops_per_sec', 0.0):.1f}), "
        f"{c.get('bytes_per_sec', 0.0):.0f} B/s, "
        f"{c.get('launches_per_sec', 0.0):.1f} launches/s, "
        f"comp {c.get('compress_bytes_per_sec', 0.0):.0f}→"
        f"{c.get('compressed_bytes_per_sec', 0.0):.0f} B/s "
        f"(rd {c.get('decompress_bytes_per_sec', 0.0):.0f}, "
        f"fp {c.get('fingerprint_bytes_per_sec', 0.0):.0f})",
        f"{'OSD':<8}{'OP/S':>10}{'RD/S':>10}{'WR/S':>10}"
        f"{'B/S':>12}{'LAUNCH/S':>10}",
    ]
    for d, r in sorted((out.get("osds") or {}).items()):
        lines.append(
            f"{d:<8}{r.get('ops_per_sec', 0.0):>10.1f}"
            f"{r.get('read_ops_per_sec', 0.0):>10.1f}"
            f"{r.get('write_ops_per_sec', 0.0):>10.1f}"
            f"{r.get('bytes_per_sec', 0.0):>12.0f}"
            f"{r.get('launches_per_sec', 0.0):>10.1f}")
    return "\n".join(lines)


def _render_autotune(out: dict) -> str:
    """`ceph autotune status` panel: controller header + one row per
    actuated knob."""
    state = "enabled" if out.get("enabled") else "disabled"
    lines = [
        f"autotune: {state} seed={out.get('seed')} "
        f"tick={out.get('tick', 0)} "
        f"decisions={out.get('decisions_total', 0)} "
        f"rollbacks={out.get('rollbacks_total', 0)} "
        f"digest={str(out.get('journal_digest', ''))[:12]}",
        f"{'KNOB':<36}{'VALUE':>12}{'PIN':>5}{'COOL':>6}"
        f"{'LAST':>10}",
    ]
    for name, k in sorted((out.get("knobs") or {}).items()):
        v = k.get("value")
        vs = f"{v:g}" if isinstance(v, float) else str(v)
        lines.append(
            f"{name:<36}{vs:>12}"
            f"{'*' if k.get('pinned') else '':>5}"
            f"{k.get('cooldown_ticks', 0):>6}"
            f"{str(k.get('last_action') or '-'):>10}")
    return "\n".join(lines)


def _render_osd_top(out: dict) -> str:
    """`ceph osd top` panel: cluster-merged heavy hitters for one
    attribution dimension, with the sketch's error bound."""
    lines = [
        f"top {out.get('dim')} by {out.get('by')} "
        f"(merged from {len(out.get('osds') or [])} osds, "
        f"err floor {out.get('err_floor', 0)})",
        f"{'KEY':<28}{'OPS':>10}{'±ERR':>8}{'BYTES':>14}"
        f"{'AVG(MS)':>10}{'P99(MS)':>10}",
    ]
    for r in out.get("rows") or []:
        lines.append(
            f"{str(r.get('key', '')):<28}{r.get('ops', 0):>10}"
            f"{r.get('err', 0):>8}{r.get('bytes', 0):>14}"
            f"{r.get('lat_avg_ms', 0.0):>10.2f}"
            f"{r.get('p99_ms', 0.0):>10.2f}")
    return "\n".join(lines)


def _render_alerts(out: dict) -> str:
    """`ceph alerts status` panel: engine header + one row per
    firing alert / active silence."""
    state = "enabled" if out.get("enabled") else "disabled"
    lines = [
        f"alerts: {state} seed={out.get('seed')} "
        f"tick={out.get('tick', 0)} "
        f"fired={out.get('fired_total', 0)} "
        f"cleared={out.get('cleared_total', 0)} "
        f"digest={str(out.get('journal_digest', ''))[:12]}",
    ]
    firing = out.get("firing") or {}
    if not firing:
        lines.append("no alerts firing")
    else:
        lines.append(f"{'ALERT':<36}{'CHECK':<20}{'SEV':>5}"
                     f"{'VALUE':>10}")
        for name in sorted(firing):
            r = firing[name] or {}
            lines.append(
                f"{name:<36}{str(r.get('check', '')):<20}"
                f"{str(r.get('severity', '')):>5}"
                f"{float(r.get('value', 0.0)):>10.2f}")
    for name in sorted(out.get("silences") or {}):
        lines.append(f"silenced: {name}")
    return "\n".join(lines)


def _render_osd_perf(out: dict) -> str:
    """`ceph osd perf` panel: commit latency plus the device-launch
    breakdown the telemetry spine derives from profiler aggregates."""
    lines = [f"{'OSD':<8}{'COMMIT(MS)':>12}{'LAUNCHES':>10}"
             f"{'DISP(MS)':>10}{'COMP(MS)':>10}{'DISP%':>8}"
             f"{'OCC%':>8}{'P99(US)':>10}"]
    for d, r in sorted((out.get("osd_perf") or {}).items()):
        dev = r.get("device") or {}
        lines.append(
            f"{d:<8}{r.get('commit_latency_ms', 0.0):>12.2f}"
            f"{dev.get('launches', 0):>10}"
            f"{dev.get('dispatch_ms_avg', 0.0):>10.2f}"
            f"{dev.get('compute_ms_avg', 0.0):>10.2f}"
            f"{100 * dev.get('dispatch_overhead_ratio', 0.0):>8.1f}"
            f"{100 * dev.get('occupancy_ratio', 1.0):>8.1f}"
            f"{dev.get('p99_us', 0.0):>10.0f}")
    return "\n".join(lines)


def _render(prefix: str, out) -> str | None:
    """Human panels for the classic read commands (reference ceph.in
    plain-format output); None ⇒ caller falls back to JSON."""
    if prefix == "status":
        pgs = " ".join(f"{n} {s}" for s, n in
                       sorted(out.get("pg_states", {}).items()))
        lines = [
            "  cluster:",
            f"    health: {out.get('health')}",
        ]
        for chk in out.get("checks", []):
            lines.append(f"            {chk['code']}: "
                         f"{chk['summary']}")
        lines += [
            "",
            "  services:",
            f"    mon: quorum {out.get('quorum')} "
            f"(leader {out.get('leader')})",
            f"    osd: {out.get('num_up_osds')}/"
            f"{out.get('num_osds')} up (epoch "
            f"{out.get('osdmap_epoch')})",
            "",
            "  data:",
            f"    pools:   {len(out.get('pools', []))} pools, "
            f"{out.get('num_pgs')} pgs",
            f"    objects: {out.get('num_objects')} objects",
            f"    pgs:     {pgs}",
        ]
        return "\n".join(lines)
    if prefix == "df":
        lines = ["--- POOLS ---",
                 f"{'NAME':<16}{'ID':>4}{'PGS':>6}{'OBJECTS':>10}"
                 f"{'USED':>12}{'LOGICAL':>12}{'RATIO':>7}"]
        for p in out.get("pools", []):
            ratio = p.get("compress_ratio", 1.0)
            logical = p.get("bytes_logical", p["bytes_used"])
            dr = p.get("dedup_ratio")
            tail = f" dedup {dr:.2f}x" if dr is not None else ""
            lines.append(f"{p['name']:<16}{p['id']:>4}"
                         f"{p['pg_num']:>6}{p['objects']:>10}"
                         f"{p['bytes_used']:>12}{logical:>12}"
                         f"{ratio:>6.2f}x{tail}")
        lines.append(f"TOTAL objects={out.get('total_objects')} "
                     f"used={out.get('total_bytes_used')}B "
                     f"logical={out.get('total_bytes_logical')}B")
        dd = out.get("dedup") or {}
        if dd.get("chunks"):
            lines.append(
                f"DEDUP chunks={dd['chunks']} refs={dd.get('refs')} "
                f"stored={dd.get('stored_bytes')}B "
                f"referenced={dd.get('referenced_bytes')}B "
                f"ratio={dd.get('ratio', 1.0):.2f}x")
        return "\n".join(lines)
    if prefix == "osd df":
        lines = [f"{'ID':>4}{'UP':>6}{'PGS':>6}{'OPS':>10}"]
        for n in out.get("nodes", []):
            lines.append(f"{n['osd']:>4}{str(n['up']):>6}"
                         f"{n['num_pgs']:>6}{n['ops']:>10}")
        return "\n".join(lines)
    return None


if __name__ == "__main__":
    sys.exit(main())
