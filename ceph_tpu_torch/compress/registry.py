"""Codec registry — port of ``ceph_tpu.compress.registry``.

The same names as ``ceph_tpu``'s (``none``, ``rle``, ``rle_jax``,
``zlib``), so that the ``algo`` of a header written by either package
resolves in the other.  ``rle_jax`` stays an alias of ``rle``: it names
the device-batched hybrid in ``ceph_tpu``, and here it runs on K9.
"""

from __future__ import annotations

import threading
from typing import Callable

from .codec import Codec, CodecError

_CODECS: dict[str, Callable[[], Codec]] = {}
_BUILTINS_LOADED = False
_LOAD_LOCK = threading.Lock()


def register_codec(name: str, factory: Callable[[], Codec]):
    _CODECS[name] = factory


def list_codecs() -> list[str]:
    _load_builtin()
    return sorted(_CODECS)


def _load_builtin():
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    # the flag flips only after every builtin is registered, so a
    # racing caller never sees a half-empty registry
    with _LOAD_LOCK:
        if _BUILTINS_LOADED:
            return
        from .codec import PassthroughCodec, RleCodec, ZlibCodec
        register_codec("none", PassthroughCodec)
        register_codec("rle", RleCodec)
        register_codec("rle_jax", RleCodec)
        register_codec("zlib", ZlibCodec)
        _BUILTINS_LOADED = True


def create_codec(name: str) -> Codec:
    _load_builtin()
    factory = _CODECS.get(name)
    if factory is None:
        raise CodecError(f"unknown compression codec {name!r}"
                         f" (available: {sorted(_CODECS)})")
    return factory()
