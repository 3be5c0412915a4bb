"""Storage-efficiency subsystem of the port: inline compression and
dedup fingerprints (port of ``ceph_tpu.compress``).

The codec registry (``registry``), the device-batched RLE hybrid codec
on K9 (``codec``), gear-hash content-defined chunking on K8 with
batched CRC-32C fingerprints on K6 (``chunker``) and the dedup index
conventions (``dedup``).  The batch engine's ``comp`` lane
(``osd.batch_engine``) is their consumer.
"""

from .codec import Codec, CodecError
from .registry import create_codec, list_codecs, register_codec
from .chunker import Chunker, fingerprint, fingerprints_batch
from . import dedup

__all__ = ["Codec", "CodecError", "create_codec", "list_codecs",
           "register_codec", "Chunker", "fingerprint",
           "fingerprints_batch", "dedup"]
