"""blackbox-tool — offline reader for a daemon's flight recorder.

The port's copy of ``ceph_tpu.tools.blackbox_tool``.

Post-mortem companion to ``core.flight_recorder``: parse a (possibly
dead) daemon's black-box sidecar straight from the raw bytes — no
mount, no daemon, no cluster — and print the reconstructed timeline
or the crash summary.  Tolerates a torn tail the same way WAL replay
does (the damage is reported, never fatal)::

    blackbox_tool --path <wal>.bbox --op timeline [--tail N] [--json]
    blackbox_tool --path <wal>.bbox --op info [--json]

``--op timeline`` flattens boot/mark/event/snap/close records into
wall-clock-stamped lines (rebased from the writer's monotonic clock
via the boot records).  ``--op info`` prints the crash summary a
reviving daemon would post as its crash report: identity, last
events, and the armed crash point if the injector announced one
before death.  After a crash+revive the dead incarnation lives at
``<path>.crash`` — point ``--path`` there to autopsy it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core import flight_recorder


def _fmt_entry(e: dict) -> str:
    stamp = e.get("stamp", 0.0)
    kind = e.get("type", "?")
    rest = {k: v for k, v in e.items() if k not in ("type", "stamp")}
    if kind == "boot":
        body = (f"daemon={rest.get('daemon')} pid={rest.get('pid')} "
                f"nonce={rest.get('nonce')}"
                + (" (rotated)" if rest.get("rotated") else ""))
    elif kind == "mark":
        extra = {k: v for k, v in rest.items() if k != "name"}
        body = rest.get("name", "?") + (
            " " + json.dumps(extra, sort_keys=True, default=str)
            if extra else "")
    elif kind == "event":
        extra = {k: v for k, v in rest.items() if k != "name"}
        body = rest.get("name", "?") + (
            " " + json.dumps(extra, sort_keys=True, default=str)
            if extra else "")
    elif kind == "snap":
        bits = []
        if "spans" in rest:
            bits.append(f"spans={rest['spans']}")
        if "clog" in rest:
            bits.append(f"clog={len(rest['clog'])}")
        if "perf_delta" in rest:
            bits.append(
                f"perf_delta={len(rest['perf_delta'])} sections")
        if "crash_injector" in rest:
            bits.append("crash_injector")
        if "profiler" in rest:
            bits.append("profiler")
        body = " ".join(bits) or "(empty)"
    elif kind == "torn_tail":
        body = json.dumps(rest.get("tail", {}), sort_keys=True)
    else:
        body = json.dumps(rest, sort_keys=True, default=str) \
            if rest else ""
    return f"{stamp:17.6f}  {kind:<9s} {body}".rstrip()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="blackbox-tool",
                                description=__doc__)
    p.add_argument("--path", required=True,
                   help="the black-box sidecar (<wal>.bbox, or "
                        "<wal>.bbox.crash for a dead incarnation)")
    p.add_argument("--op", choices=["timeline", "info"],
                   default="timeline")
    p.add_argument("--tail", type=int, metavar="N",
                   help="only the last N timeline entries")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.path) \
            and not os.path.exists(args.path + ".old"):
        print(f"no black box at {args.path!r}", file=sys.stderr)
        return 1
    if args.op == "info":
        info = flight_recorder.crash_info(args.path)
        if args.json:
            print(json.dumps(info, indent=1, sort_keys=True,
                             default=str))
        else:
            cp = info.get("crash_point")
            print(f"daemon:      {info.get('daemon')}")
            print(f"pid:         {info.get('pid')}")
            print(f"nonce:       {info.get('nonce')}")
            print(f"records:     {info.get('records')}")
            print(f"clean_close: {info.get('clean_close')}")
            print(f"tail:        {info.get('tail', {}).get('status')}")
            print("crash_point: " + (
                f"{cp['point']} (occurrence {cp['n']})" if cp
                else "none recorded"))
        return 0
    entries = flight_recorder.timeline(args.path)
    if args.tail:
        entries = entries[-args.tail:]
    if args.json:
        print(json.dumps(entries, indent=1, default=str))
    else:
        for e in entries:
            print(_fmt_entry(e))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:      # e.g. `... --op timeline | head`
        sys.exit(141)
