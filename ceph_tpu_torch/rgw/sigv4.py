"""AWS Signature Version 4 for the S3 frontend.

The port's copy of ``ceph_tpu.rgw.sigv4``.

Reference behavior re-created (``src/rgw/rgw_auth_s3.cc`` /
``rgw_rest_s3.cc`` SigV4 path; SURVEY.md §3.9): requests carry
``Authorization: AWS4-HMAC-SHA256 Credential=<ak>/<scope>,
SignedHeaders=..., Signature=...``; the server canonicalizes the
request exactly as the client did, re-derives the signing key from
the user's secret key, and compares signatures.  Both halves (client
signer, server verifier) live here so they cannot drift.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from urllib.parse import quote

ALGORITHM = "AWS4-HMAC-SHA256"
REGION = "default"
SERVICE = "s3"
UNSIGNED = "UNSIGNED-PAYLOAD"
# generous skew window (reference: rgw SIGV4 allows 15 min)
MAX_SKEW_S = 900.0


class SigError(Exception):
    pass


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _signing_key(secret: str, date: str) -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, REGION)
    k = _hmac(k, SERVICE)
    return _hmac(k, "aws4_request")


def _canonical_query(query: dict[str, str]) -> str:
    return "&".join(
        f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}"
        for k, v in sorted(query.items()))


def _canonical_request(method: str, path: str, query: dict,
                       headers: dict[str, str],
                       signed_headers: list[str],
                       payload_hash: str) -> str:
    canon_uri = quote(path if path.startswith("/") else "/" + path,
                      safe="/-_.~")
    canon_headers = "".join(
        f"{h}:{' '.join(str(headers.get(h, '')).split())}\n"
        for h in signed_headers)
    return "\n".join([
        method.upper(), canon_uri, _canonical_query(query),
        canon_headers, ";".join(signed_headers), payload_hash])


def _string_to_sign(amz_date: str, scope: str,
                    canonical: str) -> str:
    return "\n".join([
        ALGORITHM, amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])


def sign(method: str, path: str, query: dict[str, str],
         headers: dict[str, str], body: bytes, access_key: str,
         secret_key: str, now: float | None = None) -> dict[str, str]:
    """→ the headers to add: x-amz-date, x-amz-content-sha256,
    Authorization.  `headers` must already include `host`."""
    t = time.gmtime(now if now is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = amz_date[:8]
    payload_hash = hashlib.sha256(body).hexdigest()
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = sorted({"host", "x-amz-date", "x-amz-content-sha256"})
    scope = f"{date}/{REGION}/{SERVICE}/aws4_request"
    canonical = _canonical_request(method, path, query, hdrs, signed,
                                   payload_hash)
    sts = _string_to_sign(amz_date, scope, canonical)
    sig = hmac.new(_signing_key(secret_key, date), sts.encode(),
                   hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"{ALGORITHM} Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"),
    }


def verify(method: str, path: str, query: dict[str, str],
           headers: dict[str, str], body: bytes,
           secret_for_access_key, now: float | None = None,
           allow_unsigned_payload: bool = False) -> str:
    """Authenticate one request → the access key id that signed it.

    `secret_for_access_key(ak)` → secret string or None (unknown).
    Raises SigError on any failure — missing/garbled header, unknown
    key, stale date, payload hash mismatch, or signature mismatch.
    """
    hdrs = {k.lower(): v for k, v in headers.items()}
    authz = hdrs.get("authorization", "")
    if not authz.startswith(ALGORITHM):
        raise SigError("missing or non-SigV4 Authorization header")
    try:
        fields = dict(
            part.strip().split("=", 1)
            for part in authz[len(ALGORITHM):].split(","))
        cred = fields["Credential"]
        signed = fields["SignedHeaders"].split(";")
        their_sig = fields["Signature"]
        access_key, date, region, service, term = cred.split("/")
    except (ValueError, KeyError) as e:
        raise SigError(f"malformed Authorization header: {e}") \
            from None
    if (region, service, term) != (REGION, SERVICE, "aws4_request"):
        raise SigError(f"bad credential scope {cred!r}")
    amz_date = hdrs.get("x-amz-date", "")
    if not amz_date.startswith(date):
        raise SigError("x-amz-date does not match credential date")
    try:
        import calendar
        ts = calendar.timegm(time.strptime(amz_date,
                                           "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise SigError("bad x-amz-date") from None
    wall = now if now is not None else time.time()
    if abs(wall - ts) > MAX_SKEW_S:
        raise SigError("request time skew too large")
    payload_hash = hdrs.get("x-amz-content-sha256", "")
    if payload_hash == UNSIGNED:
        # with the payload unhashed, a captured signature authorizes
        # an arbitrary replacement body for the whole skew window and
        # there is no TLS layer here to compensate; no in-repo client
        # sends it, so it is rejected unless explicitly opted in
        if not allow_unsigned_payload:
            raise SigError("UNSIGNED-PAYLOAD not permitted")
    elif payload_hash != hashlib.sha256(body).hexdigest():
        raise SigError("payload hash mismatch")
    secret = secret_for_access_key(access_key)
    if secret is None:
        raise SigError(f"unknown access key {access_key!r}")
    scope = f"{date}/{REGION}/{SERVICE}/aws4_request"
    canonical = _canonical_request(method, path, query, hdrs, signed,
                                   payload_hash)
    sts = _string_to_sign(amz_date, scope, canonical)
    ours = hmac.new(_signing_key(secret, date), sts.encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(ours, their_sig):
        raise SigError("signature mismatch")
    return access_key
