"""CRUSH map text language — compile/decompile (`CrushCompiler` analog).

Reference: ``src/crush/CrushCompiler.cc`` + ``src/tools/crushtool.cc``
(SURVEY.md §3.3).  The text form round-trips through `CrushMap`:

    # begin crush map
    tunable choose_total_tries 50
    device 0 osd.0 class hdd
    type 0 osd
    type 1 host
    host node-a {
        id -2
        alg straw2
        hash 0  # rjenkins1
        item osd.0 weight 1.00000
    }
    rule replicated_rule {
        id 0
        type replicated
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }
    # end crush map

Weights are printed 16.16-fixed rendered to 5 decimals, as the reference
does.  ``step take <root> class <c>`` resolves to the class shadow tree
at compile time (see `CrushMap.class_shadow`).
"""

from __future__ import annotations

import io
import re

from .map import Bucket, CrushMap, Rule, Step, Tunables

BUCKET_ALGS = ("uniform", "list", "tree", "straw", "straw2")
_HASH_NAMES = {0: "rjenkins1"}
_HASH_IDS = {"rjenkins1": 0}

TUNABLE_NAMES = (
    "choose_local_tries", "choose_local_fallback_tries",
    "choose_total_tries", "chooseleaf_descend_once", "chooseleaf_vary_r",
    "chooseleaf_stable", "straw_calc_version", "allowed_bucket_algs",
)


class CompileError(ValueError):
    pass


def _strip_comments(text: str) -> list[list[str]]:
    """Lines -> token lists, '#' to end-of-line removed, blanks dropped."""
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            # allow `name {` and `}` braces to be their own tokens
            line = line.replace("{", " { ").replace("}", " } ")
            out.append(line.split())
    return out


def weight_to_float(w16: int) -> float:
    return w16 / 0x10000


def float_to_weight(f: float) -> int:
    return int(round(float(f) * 0x10000))


def compile_crushmap(text: str) -> CrushMap:
    lines = _strip_comments(text)
    cmap = CrushMap(types={})
    name_to_id: dict[str, int] = {}
    pending_rules: list[tuple[Rule, list[list[str]]]] = []

    i = 0

    def block(start: int) -> tuple[list[list[str]], int]:
        """Collect lines between `{` (on lines[start]) and matching `}`."""
        if lines[start][-1] != "{":
            raise CompileError(f"expected '{{' at: {' '.join(lines[start])}")
        body = []
        j = start + 1
        while j < len(lines) and lines[j] != ["}"]:
            body.append(lines[j])
            j += 1
        if j >= len(lines):
            raise CompileError("unterminated block")
        return body, j + 1

    while i < len(lines):
        tok = lines[i]
        head = tok[0]
        if head == "tunable":
            name, val = tok[1], int(tok[2])
            if name not in TUNABLE_NAMES:
                raise CompileError(f"unknown tunable {name!r}")
            setattr(cmap.tunables, name, val)
            i += 1
        elif head == "device":
            num = int(tok[1])
            dev_name = tok[2]
            cmap.names[num] = dev_name
            name_to_id[dev_name] = num
            cmap.max_devices = max(cmap.max_devices, num + 1)
            if len(tok) >= 5 and tok[3] == "class":
                cmap.device_classes[num] = tok[4]
            i += 1
        elif head == "type":
            cmap.types[int(tok[1])] = tok[2]
            i += 1
        elif head == "rule":
            body, i = block(i)
            pending_rules.append((Rule(id=-1, name=tok[1], steps=[]), body))
        elif head in cmap.types.values():
            # bucket block: "<typename> <name> {"
            body, i = block(i)
            type_id = next(t for t, n in cmap.types.items() if n == head)
            b = Bucket(id=0, type=type_id)
            bname = tok[1]
            items: list[tuple[str, int | None]] = []
            for bl in body:
                if bl[0] == "id":
                    if len(bl) >= 4 and bl[2] == "class":
                        continue  # per-class shadow id annotation: derived
                    b.id = int(bl[1])
                elif bl[0] == "alg":
                    if bl[1] not in BUCKET_ALGS:
                        raise CompileError(f"unknown bucket alg {bl[1]!r}")
                    b.alg = bl[1]
                elif bl[0] == "hash":
                    b.hash = _HASH_NAMES.get(int(bl[1]), bl[1])
                elif bl[0] == "item":
                    w = None
                    for key, val in zip(bl[2::2], bl[3::2]):
                        if key == "weight":
                            w = float_to_weight(float(val))
                    items.append((bl[1], w))
                elif bl[0] == "weight":
                    pass  # informational
                else:
                    raise CompileError(
                        f"unknown bucket line: {' '.join(bl)}")
            if b.id >= 0:
                raise CompileError(f"bucket {bname!r} missing negative id")
            for item_name, w in items:
                if item_name not in name_to_id:
                    raise CompileError(
                        f"bucket {bname!r} references unknown item"
                        f" {item_name!r}")
                iid = name_to_id[item_name]
                b.items.append(iid)
                if b.alg == "uniform":
                    b.item_weight = w if w is not None else b.item_weight
                else:
                    if w is None:
                        w = cmap.bucket(iid).weight if iid < 0 else 0x10000
                    b.weights.append(w)
            cmap.add_bucket(b)
            cmap.names[b.id] = bname
            name_to_id[bname] = b.id
        else:
            raise CompileError(f"unparsable line: {' '.join(tok)}")

    # rules second pass (they may reference any bucket)
    for rule, body in pending_rules:
        for bl in body:
            if bl[0] == "id" or bl[0] == "ruleset":  # ruleset: legacy alias
                rule.id = int(bl[1])
            elif bl[0] == "type":
                rule.type = bl[1]
            elif bl[0] == "min_size":
                rule.min_size = int(bl[1])
            elif bl[0] == "max_size":
                rule.max_size = int(bl[1])
            elif bl[0] == "step":
                rule.steps.append(
                    _parse_step(bl[1:], cmap, name_to_id))
            else:
                raise CompileError(f"unknown rule line: {' '.join(bl)}")
        if rule.id < 0:
            rule.id = len(cmap.rules)
        cmap.rules.append(rule)
    cmap.rules.sort(key=lambda r: r.id)
    return cmap


def _parse_step(tok: list[str], cmap: CrushMap,
                name_to_id: dict[str, int]) -> Step:
    op = tok[0]
    if op == "take":
        target = tok[1]
        if target not in name_to_id:
            raise CompileError(f"step take: unknown bucket {target!r}")
        tid = name_to_id[target]
        if len(tok) >= 4 and tok[2] == "class":
            shadow = cmap.class_shadow(tid, tok[3])
            return Step("take", shadow, orig=tid, cls=tok[3])
        return Step("take", tid)
    if op == "emit":
        return Step("emit")
    if op in ("choose", "chooseleaf"):
        mode = tok[1]              # firstn | indep
        if mode not in ("firstn", "indep"):
            raise CompileError(f"step {op}: bad mode {mode!r}")
        num = int(tok[2])
        if tok[3] != "type":
            raise CompileError(f"step {op}: expected 'type', got {tok[3]!r}")
        tname = tok[4]
        type_id = next((t for t, n in cmap.types.items() if n == tname), None)
        if type_id is None:
            raise CompileError(f"step {op}: unknown type {tname!r}")
        return Step(f"{op}_{mode}", num, type_id)
    if op.startswith("set_"):
        if op[4:] not in (
                "choose_tries", "chooseleaf_tries", "choose_local_tries",
                "choose_local_fallback_tries", "chooseleaf_vary_r",
                "chooseleaf_stable"):
            raise CompileError(f"unknown set step {op!r}")
        return Step(op, int(tok[1]))
    raise CompileError(f"unknown step op {op!r}")


def decompile_crushmap(cmap: CrushMap) -> str:
    out = io.StringIO()
    w = out.write
    w("# begin crush map\n")
    for name in TUNABLE_NAMES:
        w(f"tunable {name} {getattr(cmap.tunables, name)}\n")
    w("\n# devices\n")
    for i in range(cmap.max_devices):
        name = cmap.names.get(i, f"osd.{i}")
        cls = cmap.device_classes.get(i)
        w(f"device {i} {name}" + (f" class {cls}" if cls else "") + "\n")
    w("\n# types\n")
    for tid in sorted(cmap.types):
        w(f"type {tid} {cmap.types[tid]}\n")
    w("\n# buckets\n")
    # emit depth-first so every referenced child precedes its parent,
    # skipping class-shadow clones (regenerated at compile time)
    shadow_ids = {sid for per in cmap._shadow_cache.values()
                  for sid in per.values() if sid is not None}
    emitted: set[int] = set()

    def emit_bucket(bid: int):
        if bid in emitted or bid in shadow_ids:
            return
        b = cmap.bucket(bid)
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        emitted.add(bid)
        w(f"{cmap.types[b.type]} {cmap.names.get(bid, f'bucket{bid}')} {{\n")
        w(f"\tid {bid}\n")
        w(f"\t# weight {weight_to_float(b.weight):.5f}\n")
        w(f"\talg {b.alg}\n")
        w(f"\thash {_HASH_IDS.get(b.hash, 0)}\t# {b.hash}\n")
        for idx, item in enumerate(b.items):
            iw = (b.item_weight if b.alg == "uniform" else b.weights[idx])
            w(f"\titem {cmap.names.get(item, f'item{item}')} "
              f"weight {weight_to_float(iw):.5f}\n")
        w("}\n")

    for row in range(len(cmap.buckets) - 1, -1, -1):
        if cmap.buckets[row] is not None:
            emit_bucket(-1 - row)
    w("\n# rules\n")
    for rule in cmap.rules:
        w(f"rule {rule.name} {{\n")
        w(f"\tid {rule.id}\n")
        w(f"\ttype {rule.type}\n")
        w(f"\tmin_size {rule.min_size}\n")
        w(f"\tmax_size {rule.max_size}\n")
        for s in rule.steps:
            w("\tstep " + _step_text(s, cmap) + "\n")
        w("}\n")
    w("\n# end crush map\n")
    return out.getvalue()


def crushmap_to_dict(cmap: CrushMap) -> dict:
    """Portable 'compiled map' form (the reference's binary crush map is
    a bespoke encoding; this framework's compiled form is versioned JSON —
    see the codec module for the binary bufferlist analog)."""
    shadow_ids = {sid for per in cmap._shadow_cache.values()
                  for sid in per.values() if sid is not None}
    return {
        "version": 1,
        "tunables": {n: getattr(cmap.tunables, n) for n in TUNABLE_NAMES},
        "max_devices": cmap.max_devices,
        "types": {str(t): n for t, n in cmap.types.items()},
        "names": {str(i): n for i, n in cmap.names.items()
                  if i not in shadow_ids},
        "device_classes": {str(i): c for i, c in
                           cmap.device_classes.items()},
        "buckets": [
            None if b is None or b.id in shadow_ids else {
                "id": b.id, "type": b.type, "alg": b.alg, "hash": b.hash,
                "items": b.items, "weights": b.weights,
                "item_weight": b.item_weight,
            } for b in cmap.buckets],
        "rules": [{
            "id": r.id, "name": r.name, "type": r.type,
            "min_size": r.min_size, "max_size": r.max_size,
            "steps": [{"op": s.op, "arg1": s.arg1, "arg2": s.arg2,
                       "orig": s.orig, "cls": s.cls} for s in r.steps],
        } for r in cmap.rules],
        "choose_args": {str(b): a for b, a in cmap.choose_args.items()},
    }


def crushmap_from_dict(d: dict) -> CrushMap:
    cmap = CrushMap(
        tunables=Tunables(**d["tunables"]),
        max_devices=d["max_devices"],
        types={int(t): n for t, n in d["types"].items()},
        names={int(i): n for i, n in d["names"].items()},
        device_classes={int(i): c for i, c in d["device_classes"].items()},
        choose_args={int(b): a for b, a in d.get("choose_args", {}).items()},
    )
    for b in d["buckets"]:
        if b is not None:
            cmap.add_bucket(Bucket(
                id=b["id"], type=b["type"], alg=b["alg"], hash=b["hash"],
                items=list(b["items"]), weights=list(b["weights"]),
                item_weight=b["item_weight"]))
    # trim trailing None rows left by skipped shadow clones
    while cmap.buckets and cmap.buckets[-1] is None:
        cmap.buckets.pop()
    for r in d["rules"]:
        steps = []
        for s in r["steps"]:
            step = Step(s["op"], s["arg1"], s["arg2"])
            if s.get("cls") is not None:
                # re-resolve the class shadow against the rebuilt map
                step.orig, step.cls = s["orig"], s["cls"]
                step.arg1 = cmap.class_shadow(step.orig, step.cls)
            steps.append(step)
        cmap.rules.append(Rule(id=r["id"], name=r["name"], steps=steps,
                               type=r["type"], min_size=r["min_size"],
                               max_size=r["max_size"]))
    return cmap


def _step_text(s: Step, cmap: CrushMap) -> str:
    if s.op == "take":
        if s.cls is not None:
            name = cmap.names.get(s.orig, str(s.orig))
            return f"take {name} class {s.cls}"
        return f"take {cmap.names.get(s.arg1, str(s.arg1))}"
    if s.op == "emit":
        return "emit"
    m = re.fullmatch(r"(choose|chooseleaf)_(firstn|indep)", s.op)
    if m:
        return (f"{m.group(1)} {m.group(2)} {s.arg1} "
                f"type {cmap.types.get(s.arg2, str(s.arg2))}")
    if s.op.startswith("set_"):
        return f"{s.op} {s.arg1}"
    raise CompileError(f"cannot decompile step {s.op!r}")
