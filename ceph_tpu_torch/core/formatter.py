"""Formatter — structured output for CLIs and admin commands.

The port's copy of ``ceph_tpu.core.formatter``.

Reference behavior re-created (``src/common/Formatter.{h,cc}``;
SURVEY.md §3.1): a push API (open_object/open_array/dump_*/close) that
every command handler writes against once, rendered as JSON, XML or an
aligned table depending on the user's ``--format``.
"""

from __future__ import annotations

import io
import json
from xml.sax.saxutils import escape


class Formatter:
    """Abstract push-API; `flush()` renders."""

    @staticmethod
    def create(fmt: str) -> "Formatter":
        if fmt in ("json", "json-pretty"):
            return JSONFormatter(pretty=fmt == "json-pretty")
        if fmt == "xml":
            return XMLFormatter()
        if fmt == "table":
            return TableFormatter()
        raise ValueError(f"unknown format {fmt!r}")

    # subclasses implement:
    def open_object(self, name: str | None = None): ...
    def close_object(self): ...
    def open_array(self, name: str | None = None): ...
    def close_array(self): ...
    def dump(self, name: str | None, value): ...

    # convenience
    def dump_int(self, name, value):
        self.dump(name, int(value))

    def dump_float(self, name, value):
        self.dump(name, float(value))

    def dump_string(self, name, value):
        self.dump(name, str(value))

    def dump_bool(self, name, value):
        self.dump(name, bool(value))

    def flush(self) -> str:
        raise NotImplementedError


class JSONFormatter(Formatter):
    def __init__(self, pretty: bool = False):
        self._root = None
        self._stack: list = []
        self._pretty = pretty

    def _attach(self, name, node):
        if not self._stack:
            self._root = node
        else:
            top = self._stack[-1]
            if isinstance(top, list):
                top.append(node)
            else:
                top[name if name is not None else ""] = node
        return node

    def open_object(self, name=None):
        self._stack.append(self._attach(name, {}))

    def close_object(self):
        popped = self._stack.pop()
        assert isinstance(popped, dict), "close_object on array"

    def open_array(self, name=None):
        self._stack.append(self._attach(name, []))

    def close_array(self):
        popped = self._stack.pop()
        assert isinstance(popped, list), "close_array on object"

    def dump(self, name, value):
        self._attach(name, value)

    def flush(self) -> str:
        assert not self._stack, "unclosed sections at flush"
        return json.dumps(self._root, indent=2 if self._pretty else None,
                          sort_keys=False)


class XMLFormatter(Formatter):
    def __init__(self):
        self._out = io.StringIO()
        self._stack: list[str] = []

    def open_object(self, name=None):
        tag = name or "object"
        self._out.write(f"<{tag}>")
        self._stack.append(tag)

    def close_object(self):
        self._out.write(f"</{self._stack.pop()}>")

    def open_array(self, name=None):
        tag = name or "array"
        self._out.write(f"<{tag}>")
        self._stack.append(tag)

    def close_array(self):
        self._out.write(f"</{self._stack.pop()}>")

    def dump(self, name, value):
        tag = name or "item"
        sval = ("true" if value else "false") if isinstance(value, bool) \
            else str(value)
        self._out.write(f"<{tag}>{escape(sval)}</{tag}>")

    def flush(self) -> str:
        assert not self._stack, "unclosed sections at flush"
        return self._out.getvalue()


class TableFormatter(Formatter):
    """Flat rows → aligned columns (the `--format table` of CLIs):
    open_object per row inside one array; nested structure flattens
    with dotted names."""

    def __init__(self):
        self._rows: list[dict] = []
        self._prefix: list[str] = []
        self._row: dict | None = None

    def open_object(self, name=None):
        if self._row is None:
            self._row = {}
        elif name:
            self._prefix.append(name)

    def close_object(self):
        if self._prefix:
            self._prefix.pop()
        elif self._row is not None:
            self._rows.append(self._row)
            self._row = None

    def open_array(self, name=None):
        if name:
            self._prefix.append(name)

    def close_array(self):
        if self._prefix:
            self._prefix.pop()

    def dump(self, name, value):
        if self._row is None:
            self._row = {}
            standalone = True
        else:
            standalone = False
        key = ".".join(self._prefix + [name or "value"])
        self._row[key] = value
        if standalone:
            self._rows.append(self._row)
            self._row = None

    def flush(self) -> str:
        if self._row is not None:
            self._rows.append(self._row)
            self._row = None
        if not self._rows:
            return ""
        cols: list[str] = []
        for row in self._rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in
                                   self._rows)) for c in cols}
        lines = ["  ".join(c.upper().ljust(widths[c]) for c in cols)]
        for row in self._rows:
            lines.append("  ".join(
                str(row.get(c, "")).ljust(widths[c]) for c in cols))
        return "\n".join(lines)
