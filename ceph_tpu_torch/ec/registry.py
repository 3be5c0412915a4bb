"""Plugin registry — port of ``ceph_tpu.ec.registry``.

Registers ``jerasure``, ``isa``, ``lrc``, ``shec``, ``clay`` and
``torch_cuda``, the port's name for jerasure's RS math on the CUDA
engine (an exact alias, as ceph_tpu's ``jax_tpu`` is).  Every factory
takes the profile and ``device``.
"""

from __future__ import annotations

import threading
from typing import Callable

from .interface import ECError, ECProfile, ErasureCodeInterface

_PLUGINS: dict[str, Callable[..., ErasureCodeInterface]] = {}
_BUILTINS_LOADED = False
_LOAD_LOCK = threading.Lock()


def register_plugin(name: str,
                    factory: Callable[..., ErasureCodeInterface]):
    _PLUGINS[name] = factory


def list_plugins() -> list[str]:
    _load_builtin()
    return sorted(_PLUGINS)


def _load_builtin():
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    # the flag flips only after every builtin is registered, so a
    # racing caller never sees a half-empty registry
    with _LOAD_LOCK:
        if _BUILTINS_LOADED:
            return
        from .clay import ErasureCodeClay
        from .isa import ErasureCodeIsa
        from .jerasure import ErasureCodeJerasure
        from .lrc import ErasureCodeLrc
        from .shec import ErasureCodeShec
        register_plugin("jerasure", ErasureCodeJerasure)
        register_plugin("clay", ErasureCodeClay)
        register_plugin("isa", ErasureCodeIsa)
        register_plugin("lrc", ErasureCodeLrc)
        register_plugin("shec", ErasureCodeShec)
        register_plugin("torch_cuda", ErasureCodeJerasure)
        _BUILTINS_LOADED = True


def create_erasure_code(profile, device=None) -> ErasureCodeInterface:
    """Factory: profile (dict | ECProfile | iterable of k=v) -> plugin
    whose engine runs on ``device`` (``None`` → the card)."""
    _load_builtin()
    if not isinstance(profile, ECProfile):
        profile = ECProfile.parse(profile)
    factory = _PLUGINS.get(profile.plugin)
    if factory is None:
        raise ECError(
            f"unknown erasure-code plugin {profile.plugin!r}"
            f" (available: {sorted(_PLUGINS)})")
    return factory(profile, device=device)
