"""CephX-analog authentication: keyed tickets, session keys, signing.

The port's copy of ``ceph_tpu.core.auth``.

Reference behavior re-created (``src/auth/``, ``src/auth/cephx/``;
SURVEY.md §3.1): a Kerberos-like scheme —

- every entity (client.admin, osd.3, mon.) holds a shared secret in a
  keyring;
- the auth server (monitor) issues a *ticket*: a service-readable blob
  carrying the session key + caps, sealed under the SERVICE's secret,
  plus the session key sealed under the CLIENT's secret — so the mon
  never re-participates in client↔service connections;
- the client proves ticket possession with an *authorizer* (nonce
  challenge under the session key); both peers then sign messages with
  the session key.

Crypto here is AES-128-GCM (authenticated encryption — the reference's
"secure mode" uses AES-GCM too) and HMAC-SHA256 truncated to 8 bytes
for per-frame signatures (reference signatures are 8 bytes).
"""

from __future__ import annotations

import hmac
import hashlib
import json
import os
import time
from dataclasses import dataclass, field

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:         # environment without pyca/cryptography
    AESGCM = None


class AuthError(Exception):
    pass


def _hmac_stream(secret: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    ctr = 0
    while len(out) < n:
        out += hmac.new(secret, nonce + ctr.to_bytes(8, "big") + b"ks",
                        hashlib.sha256).digest()
        ctr += 1
    return bytes(out[:n])


class CryptoKey:
    """An AES key, 16/24/32 bytes (reference CryptoKey, type
    CEPH_CRYPTO_AES; RBD at-rest encryption wraps 32-byte DEKs).

    When pyca/cryptography is unavailable the AEAD degrades to an
    HMAC-SHA256 CTR stream + 16-byte HMAC tag: same nonce/tag framing
    and tamper detection, interoperable only with itself — a
    dependency gate, not a second supported cipher suite.
    """

    def __init__(self, secret: bytes | None = None, created: float = 0.0):
        self.secret = secret if secret is not None else os.urandom(16)
        if len(self.secret) not in (16, 24, 32):
            raise AuthError("key must be 16/24/32 bytes")
        self.created = created or time.time()

    def _seal(self, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
        ct = bytes(a ^ b for a, b in zip(
            plaintext, _hmac_stream(self.secret, nonce, len(plaintext))))
        tag = hmac.new(self.secret, nonce + aad + ct,
                       hashlib.sha256).digest()[:16]
        return ct + tag

    def _unseal(self, nonce: bytes, blob: bytes, aad: bytes) -> bytes:
        if len(blob) < 16:
            raise AuthError("ciphertext too short")
        ct, tag = blob[:-16], blob[-16:]
        want = hmac.new(self.secret, nonce + aad + ct,
                        hashlib.sha256).digest()[:16]
        if not hmac.compare_digest(tag, want):
            raise AuthError("decrypt failed: bad tag")
        return bytes(a ^ b for a, b in zip(
            ct, _hmac_stream(self.secret, nonce, len(ct))))

    def encrypt(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        nonce = os.urandom(12)
        if AESGCM is None:
            return nonce + self._seal(nonce, plaintext, aad)
        return nonce + AESGCM(self.secret).encrypt(nonce, plaintext, aad)

    def decrypt(self, blob: bytes, aad: bytes = b"") -> bytes:
        if len(blob) < 13:
            raise AuthError("ciphertext too short")
        if AESGCM is None:
            return self._unseal(blob[:12], blob[12:], aad)
        try:
            return AESGCM(self.secret).decrypt(blob[:12], blob[12:], aad)
        except Exception as e:
            raise AuthError(f"decrypt failed: {e}") from e

    def sign(self, data: bytes) -> bytes:
        """8-byte message signature (msgr frame signing)."""
        return hmac.new(self.secret, data, hashlib.sha256).digest()[:8]

    def verify(self, data: bytes, sig: bytes) -> bool:
        return hmac.compare_digest(self.sign(data), sig)

    def to_str(self) -> str:
        import base64
        return base64.b64encode(self.secret).decode()

    @classmethod
    def from_str(cls, s: str) -> "CryptoKey":
        import base64
        return cls(base64.b64decode(s))


@dataclass
class EntityAuth:
    key: CryptoKey
    caps: dict[str, str] = field(default_factory=dict)  # service → capstr


class KeyRing:
    """entity name → (key, caps); the mon's KeyServer store and each
    daemon's local keyring file."""

    def __init__(self):
        self._entries: dict[str, EntityAuth] = {}

    def add(self, entity: str, key: CryptoKey | None = None,
            caps: dict[str, str] | None = None) -> CryptoKey:
        ea = EntityAuth(key or CryptoKey(), caps or {})
        self._entries[entity] = ea
        return ea.key

    def get(self, entity: str) -> EntityAuth:
        if entity not in self._entries:
            raise AuthError(f"no key for entity {entity!r}")
        return self._entries[entity]

    def __contains__(self, entity: str) -> bool:
        return entity in self._entries

    def entities(self) -> list[str]:
        return sorted(self._entries)

    # keyring file format (ini-ish, like the reference's)
    def dump(self) -> str:
        out = []
        for name in sorted(self._entries):
            ea = self._entries[name]
            out.append(f"[{name}]")
            out.append(f"\tkey = {ea.key.to_str()}")
            for svc, cap in sorted(ea.caps.items()):
                out.append(f'\tcaps {svc} = "{cap}"')
        return "\n".join(out) + "\n"

    @classmethod
    def load(cls, text: str) -> "KeyRing":
        kr = cls()
        entity = None
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("[") and line.endswith("]"):
                entity = line[1:-1]
                kr._entries[entity] = EntityAuth(CryptoKey())
            elif "=" in line and entity:
                key, val = (s.strip() for s in line.split("=", 1))
                if key == "key":
                    kr._entries[entity].key = CryptoKey.from_str(val)
                elif key.startswith("caps "):
                    kr._entries[entity].caps[key[5:].strip()] = \
                        val.strip('"')
        return kr


TICKET_TTL = 3600.0


class AuthServer:
    """Mon-side CephxServiceHandler: issues tickets from the keyring."""

    def __init__(self, keyring: KeyRing,
                 service_keys: dict[str, CryptoKey]):
        self.keyring = keyring
        self.service_keys = service_keys   # service name → rotating key

    def handle_auth_request(self, entity: str, service: str) -> dict:
        """→ {enc_session_key, ticket}: session key sealed for the
        client; ticket (session key + caps + expiry) sealed for the
        service."""
        ea = self.keyring.get(entity)
        if service not in self.service_keys:
            raise AuthError(f"unknown service {service!r}")
        session = CryptoKey()
        expires = time.time() + TICKET_TTL
        ticket_payload = json.dumps({
            "entity": entity,
            "session_key": session.to_str(),
            "caps": ea.caps.get(service, ""),
            "expires": expires,
        }).encode()
        return {
            "enc_session_key": ea.key.encrypt(
                json.dumps({"session_key": session.to_str(),
                            "expires": expires}).encode(),
                aad=service.encode()),
            "ticket": self.service_keys[service].encrypt(
                ticket_payload, aad=b"ticket"),
        }


class AuthClient:
    """Client-side CephxClientHandler."""

    def __init__(self, entity: str, key: CryptoKey):
        self.entity = entity
        self.key = key

    def open_session(self, reply: dict, service: str):
        blob = self.key.decrypt(reply["enc_session_key"],
                                aad=service.encode())
        info = json.loads(blob.decode())
        return SessionTicket(self.entity,
                             CryptoKey.from_str(info["session_key"]),
                             reply["ticket"], info["expires"])


@dataclass
class SessionTicket:
    entity: str
    session_key: CryptoKey
    ticket: bytes
    expires: float

    def make_authorizer(self, nonce: bytes) -> dict:
        """Challenge proof presented when connecting to the service."""
        return {"entity": self.entity, "ticket": self.ticket,
                "proof": self.session_key.sign(nonce)}


class ServiceVerifier:
    """Service-side ticket check (each OSD/MDS holds its service key)."""

    def __init__(self, service: str, key: CryptoKey):
        self.service = service
        self.key = key

    def verify_authorizer(self, authorizer: dict,
                          nonce: bytes) -> tuple[str, CryptoKey, str]:
        """→ (entity, session_key, caps); raises AuthError on forgery
        or expiry."""
        payload = json.loads(
            self.key.decrypt(authorizer["ticket"], aad=b"ticket"))
        if payload["expires"] < time.time():
            raise AuthError("ticket expired")
        if payload["entity"] != authorizer["entity"]:
            raise AuthError("ticket entity mismatch")
        session = CryptoKey.from_str(payload["session_key"])
        if not session.verify(nonce, authorizer["proof"]):
            raise AuthError("bad authorizer proof")
        return payload["entity"], session, payload["caps"]


class ClusterAuth:
    """Shared-secret security bundle for one cluster — the deployment
    analog of a keyring file installed on every host (reference: each
    daemon's on-disk keyring + the mon KDC; ``src/auth/cephx/``).

    One service key; every daemon derives a `verifier()` for its
    accepting side and a pre-issued `ticket(entity)` for its
    connecting side, so any daemon can authenticate to any other.
    Pair with ``Messenger(mode="secure")`` for AES-GCM frame
    encryption keyed by the per-connection session key.
    """

    SERVICE = "cluster"

    def __init__(self, secret: bytes | None = None):
        self.key = CryptoKey(secret)

    def verifier(self) -> ServiceVerifier:
        return ServiceVerifier(self.SERVICE, self.key)

    def ticket(self, entity: str,
               ttl: float = TICKET_TTL) -> SessionTicket:
        session = CryptoKey()
        expires = time.time() + ttl
        blob = json.dumps({
            "entity": entity,
            "session_key": session.to_str(),
            "caps": "allow *",
            "expires": expires,
        }).encode()
        return SessionTicket(entity, session,
                             self.key.encrypt(blob, aad=b"ticket"),
                             expires)

    def msgr_kwargs(self, entity: str, mode: str = "secure") -> dict:
        """Keyword bundle for ``Messenger(entity, **kwargs)``.  The
        ticket is a FACTORY (re-minted per connection attempt): a
        static ticket would expire after TICKET_TTL and leave every
        later reconnect permanently refused."""
        return {"verifier": self.verifier(),
                "session_ticket": lambda: self.ticket(entity),
                "mode": mode}
