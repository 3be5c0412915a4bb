"""CephContext — the per-process service singleton.

The port's copy of ``ceph_tpu.core.context``.

Reference behavior re-created (``src/common/ceph_context.{h,cc}``,
``src/global/global_init.cc``; SURVEY.md §3.1): one object owning the
config proxy, log, perf-counter collection, admin socket and timers,
handed to every subsystem.  ``global_init`` wires the built-in admin
commands (`perf dump`, `config show/set/get`, `log dump`, `version`).
"""

from __future__ import annotations

import os
import tempfile

from . import options
from .admin_socket import AdminSocket
from .config import ConfigProxy
from .log import Log
from .perf_counters import PerfCountersCollection
from .threading_utils import Finisher, SafeTimer

VERSION = "ceph-tpu 0.1"


class CephContext:
    def __init__(self, name: str = "client", conf: ConfigProxy | None = None,
                 admin_socket_path: str | None = None):
        self.name = name
        self.conf = conf if conf is not None else ConfigProxy(
            options.build_options())
        self.log = Log()
        self.perf = PerfCountersCollection()
        self.timer = SafeTimer(f"{name}-timer")
        self.finisher = Finisher(f"{name}-finisher")
        # the port's own prefix: both packages' contexts of one name
        # in one process would otherwise bind the same path
        path = admin_socket_path or os.path.join(
            tempfile.gettempdir(),
            f"ceph_tpu_torch-{name}-{os.getpid()}.asok")
        self.admin = AdminSocket(path)
        self._register_builtin_commands()
        self._started = False

    def start_service_threads(self):
        if not self._started:
            self.admin.start()
            self._started = True

    def shutdown(self):
        if self._started:
            self.admin.shutdown()
            self._started = False
        self.timer.shutdown()
        self.finisher.shutdown()

    def __enter__(self):
        self.start_service_threads()
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- builtin admin commands -------------------------------------------
    def _register_builtin_commands(self):
        self.admin.register(
            "version", lambda cmd: {"version": VERSION}, "show version")
        self.admin.register(
            "perf dump", lambda cmd: self.perf.dump(),
            "dump perfcounters")
        self.admin.register(
            "perf schema", lambda cmd: self.perf.schema(),
            "dump perfcounters schema")
        self.admin.register(
            "config show", lambda cmd: {
                k: self.conf.get(k) for k in self.conf.keys()},
            "dump current config")
        self.admin.register(
            "config get", lambda cmd: {
                cmd["var"]: self.conf.get(cmd["var"])},
            "get one option")
        self.admin.register(
            "config set",
            lambda cmd: (self.conf.set(cmd["var"], cmd["val"]),
                         {"success": True})[1],
            "set one option (runtime override)")
        self.admin.register(
            "config diff", lambda cmd: self.conf.diff(),
            "non-default options")
        self.admin.register(
            "log dump", lambda cmd: {
                "dumped": self.log.dump_recent()}, "dump recent log ring")
