"""Typed, layered configuration — md_config_t / ConfigProxy analog.

The port's copy of ``ceph_tpu.core.config``.

Reference behavior re-created (``src/common/config.{h,cc}``,
``src/common/options*``; SURVEY.md §3.1, §6.6):

- options are declared once with type, default, bounds/enum, level
  (basic/advanced/dev), description and see_also — introspectable via
  ``help()``;
- values layer by precedence: compiled default < conf file < mon
  config-db < environment < command line < runtime injectargs; reads
  see the highest-precedence source that has the key;
- observers register per-key and get callbacks on effective-value
  changes (the live-update mechanism daemons rely on).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable


class Level(enum.Enum):
    BASIC = "basic"
    ADVANCED = "advanced"
    DEV = "dev"


# precedence, low → high (reference CONF_DEFAULT..CONF_OVERRIDE)
SOURCES = ("default", "file", "mon", "env", "cmdline", "override")


class ConfigError(Exception):
    pass


@dataclass
class Option:
    name: str
    type: type                   # int | float | str | bool
    default: Any
    desc: str = ""
    level: Level = Level.ADVANCED
    min: Any = None
    max: Any = None
    enum_allowed: tuple = ()
    see_also: tuple = ()

    def validate(self, value):
        try:
            if self.type is bool and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            else:
                value = self.type(value)
        except (TypeError, ValueError) as e:
            raise ConfigError(f"{self.name}: bad value {value!r}: {e}")
        if self.min is not None and value < self.min:
            raise ConfigError(f"{self.name}: {value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ConfigError(f"{self.name}: {value} > max {self.max}")
        if self.enum_allowed and value not in self.enum_allowed:
            raise ConfigError(
                f"{self.name}: {value!r} not in {self.enum_allowed}")
        return value


class ConfigProxy:
    def __init__(self, options: list[Option] | None = None):
        self._schema: dict[str, Option] = {}
        self._values: dict[str, dict[str, Any]] = {}  # name → source → val
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        for opt in options or []:
            self.register(opt)

    # -- schema ------------------------------------------------------------
    def register(self, opt: Option):
        if opt.name in self._schema:
            raise ConfigError(f"option {opt.name!r} already registered")
        self._schema[opt.name] = opt

    def register_many(self, opts):
        for o in opts:
            self.register(o)

    def help(self, name: str) -> dict:
        opt = self._opt(name)
        return {
            "name": opt.name, "type": opt.type.__name__,
            "default": opt.default, "desc": opt.desc,
            "level": opt.level.value, "min": opt.min, "max": opt.max,
            "enum": list(opt.enum_allowed), "see_also": list(opt.see_also),
        }

    def keys(self):
        return sorted(self._schema)

    def _opt(self, name: str) -> Option:
        if name not in self._schema:
            raise ConfigError(f"unknown option {name!r}")
        return self._schema[name]

    # -- values ------------------------------------------------------------
    def get(self, name: str):
        opt = self._opt(name)
        layers = self._values.get(name, {})
        for src in reversed(SOURCES):
            if src in layers:
                return layers[src]
        return opt.default

    def __getitem__(self, name: str):
        return self.get(name)

    def set(self, name: str, value, source: str = "override"):
        if source not in SOURCES or source == "default":
            raise ConfigError(f"bad source {source!r}")
        opt = self._opt(name)
        before = self.get(name)
        self._values.setdefault(name, {})[source] = opt.validate(value)
        after = self.get(name)
        if after != before:
            for cb in self._observers.get(name, []):
                cb(name, after)

    def rm(self, name: str, source: str):
        layers = self._values.get(name, {})
        before = self.get(name)
        layers.pop(source, None)
        after = self.get(name)
        if after != before:
            for cb in self._observers.get(name, []):
                cb(name, after)

    def source_of(self, name: str) -> str:
        layers = self._values.get(name, {})
        for src in reversed(SOURCES):
            if src in layers:
                return src
        return "default"

    # -- bulk loading ------------------------------------------------------
    def load_file(self, path: str):
        """ini-ish ceph.conf: `key = value` lines, [sections] ignored
        beyond [global] scoping (single-daemon framework)."""
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].split(";", 1)[0].strip()
                if not line or line.startswith("["):
                    continue
                if "=" not in line:
                    raise ConfigError(f"bad conf line: {line!r}")
                key, val = (s.strip() for s in line.split("=", 1))
                key = key.replace(" ", "_")
                if key in self._schema:
                    self.set(key, val, "file")

    def injectargs(self, args: str):
        """Runtime `ceph tell ... injectargs '--k v --k2 v2'` analog."""
        toks = args.split()
        i = 0
        while i < len(toks):
            tok = toks[i]
            if not tok.startswith("--"):
                raise ConfigError(f"expected --option, got {tok!r}")
            key = tok[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                key = key.replace("-", "_")  # normalize KEY only —
                # values (paths, profiles) may legitimately contain '-'
            else:
                key = key.replace("-", "_")
                i += 1
                if i >= len(toks):
                    raise ConfigError(f"--{key} missing value")
                val = toks[i]
            self.set(key, val, "override")
            i += 1

    # -- observers ---------------------------------------------------------
    def add_observer(self, name: str, cb: Callable[[str, Any], None]):
        self._opt(name)
        self._observers.setdefault(name, []).append(cb)

    def diff(self) -> dict[str, Any]:
        """Non-default effective values (``ceph config diff``)."""
        out = {}
        for name in self._schema:
            val = self.get(name)
            if val != self._schema[name].default:
                out[name] = {"value": val, "source": self.source_of(name)}
        return out
