"""The port's SigV4 (``ceph_tpu_torch.rgw.sigv4``) against ceph_tpu's.

200 seeded cases made with numpy: methods; paths with reserved, escaped
and non-ASCII characters; queries with empty values and repeated keys
(parsed as the gateway parses them: the first value of a key wins);
headers with mixed case and inner whitespace; ``UNSIGNED-PAYLOAD`` and
hex payload hashes; dates from 1971 to 2099.  For each case the port's
``_canonical_request``, ``_string_to_sign`` and ``sign`` equal
ceph_tpu's exactly, and each package's ``verify`` accepts the other's
signature and refuses it after one flipped byte.  Tolerance: exact
strings.
"""

import hashlib
from urllib.parse import parse_qs, quote

import numpy as np
import pytest

from ceph_tpu.rgw import sigv4 as R
from ceph_tpu_torch.rgw import sigv4 as P

PKGS = {"ceph_tpu": R, "port": P}
N_CASES = 200
METHODS = ["GET", "PUT", "POST", "DELETE", "HEAD", "get", "Put"]
# path pieces: plain, reserved, already escaped, spaces, non-ASCII
PIECES = ["bucket", "key", "a b", "x+y", "semi;colon", "eq=ual", "amp&",
          "q?mark", "pct%20", "tilde~", "dot.", "_under-", "ünïcödé",
          "日本", "emoji\U0001f600", "star*", "paren()", "comma,", "'quote'",
          ""]
QKEYS = ["uploadId", "partNumber", "versionId", "versions", "policy",
         "prefix", "a b", "ü", "x-id", "list-type"]
QVALS = ["", "1", "00000001", "a/b", "a b", "ü", "=", "&", "~_-.", "+"]
HEADERS = ["Content-Type", "X-Amz-Meta-Foo", "x-rgw-tenant", "Range",
           "X-Amz-Storage-Class", "content-md5"]


def cases():
    rng = np.random.default_rng(20151)
    out = []
    for i in range(N_CASES):
        method = METHODS[rng.integers(len(METHODS))]
        segs = [PIECES[j] for j in rng.integers(0, len(PIECES),
                                                size=rng.integers(0, 4))]
        path = "/" + "/".join(segs)
        if rng.random() < 0.2:
            path = path.lstrip("/")            # no leading slash
        # a query string with repeated keys and empty values, parsed as
        # the gateway parses it (the first value of a key wins)
        pairs = [(QKEYS[rng.integers(len(QKEYS))],
                  QVALS[rng.integers(len(QVALS))])
                 for _ in range(rng.integers(0, 5))]
        qs = "&".join(f"{quote(k)}={quote(v)}" if v or rng.random() < 0.5
                      else quote(k) for k, v in pairs)
        query = {k: v[0] for k, v in
                 parse_qs(qs, keep_blank_values=True).items()}
        headers = {"Host": f"127.0.0.1:{rng.integers(1024, 65536)}"}
        for h in rng.choice(HEADERS, size=rng.integers(0, 3),
                            replace=False):
            name = "".join(c.upper() if rng.random() < 0.5 else c.lower()
                           for c in h)
            inner = "  \t ".join(["v", str(rng.integers(100))])
            headers[name] = f" {inner}  " if rng.random() < 0.5 else inner
        body = rng.integers(0, 256, size=rng.integers(0, 300),
                            dtype=np.uint8).tobytes()
        payload_hash = (R.UNSIGNED if rng.random() < 0.25
                        else hashlib.sha256(body).hexdigest())
        now = float(rng.integers(365 * 86400, 4102444800))
        out.append((i, method, path, query, headers, body, payload_hash,
                    now))
    return out


CASES = cases()


def ids(case):
    return f"case{case[0]}"


def canonical_inputs(mod, case):
    """The signer's own view of one case: lower-cased headers with its
    date and payload hash, the signed list, the scope."""
    _i, method, path, query, headers, _body, payload_hash, now = case
    import time
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = sorted(hdrs)
    scope = f"{amz_date[:8]}/{mod.REGION}/{mod.SERVICE}/aws4_request"
    return method, path, query, hdrs, signed, payload_hash, amz_date, scope


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_canonical_request_string_to_sign_and_sign_match(case):
    got = {}
    for pkg, mod in PKGS.items():
        (method, path, query, hdrs, signed, payload_hash, amz_date,
         scope) = canonical_inputs(mod, case)
        canonical = mod._canonical_request(method, path, query, hdrs,
                                           signed, payload_hash)
        sts = mod._string_to_sign(amz_date, scope, canonical)
        _i, method, path, query, headers, body, _ph, now = case
        signed_hdrs = mod.sign(method, path.split("?")[0] or "/", query,
                               headers, body, "AKIDEXAMPLE",
                               "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
                               now=now)
        got[pkg] = (canonical, sts, signed_hdrs,
                    mod._canonical_query(query))
    assert got["port"] == got["ceph_tpu"]
    canonical, sts, signed_hdrs, _cq = got["port"]
    # the case's own answer, so equal-but-wrong cannot pass
    assert canonical.split("\n")[0] == case[1].upper()
    assert sts.endswith(hashlib.sha256(canonical.encode()).hexdigest())
    assert signed_hdrs["x-amz-content-sha256"] == \
        hashlib.sha256(case[5]).hexdigest()


SECRET = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
KEYS = {"AKIDEXAMPLE": SECRET}


def signed_request(mod, case):
    """→ (path, query, headers, body) signed by ``mod``: ``sign`` for a
    hex payload hash; for ``UNSIGNED-PAYLOAD`` the same steps by hand
    (``sign`` always hashes the body)."""
    _i, method, path, query, headers, body, payload_hash, now = case
    path = path.split("?")[0] or "/"
    if payload_hash != mod.UNSIGNED:
        hdrs = dict(headers)
        hdrs.update(mod.sign(method, path, query, headers, body,
                             "AKIDEXAMPLE", SECRET, now=now))
        return path, query, hdrs, body
    import hmac
    (method, _p, query, hdrs, signed, payload_hash, amz_date,
     scope) = canonical_inputs(mod, case)
    signed = sorted({"host", "x-amz-date", "x-amz-content-sha256"})
    canonical = mod._canonical_request(method, path, query, hdrs, signed,
                                       payload_hash)
    sts = mod._string_to_sign(amz_date, scope, canonical)
    sig = hmac.new(mod._signing_key(SECRET, amz_date[:8]), sts.encode(),
                   hashlib.sha256).hexdigest()
    out = dict(headers)
    out.update({"x-amz-date": amz_date, "x-amz-content-sha256": payload_hash,
                "Authorization": (
                    f"{mod.ALGORITHM} Credential=AKIDEXAMPLE/{scope}, "
                    f"SignedHeaders={';'.join(signed)}, Signature={sig}")})
    return path, query, out, body


def flip_signature(headers):
    """One hex digit of the signature changed."""
    out = dict(headers)
    authz = out["Authorization"]
    last = authz[-1]
    out["Authorization"] = authz[:-1] + ("0" if last != "0" else "1")
    return out


@pytest.mark.parametrize("signer,verifier",
                         [("ceph_tpu", "port"), ("port", "ceph_tpu")])
def test_verify_accepts_the_other_package_and_refuses_a_flip(signer,
                                                             verifier):
    sm, vm = PKGS[signer], PKGS[verifier]
    unsigned = 0
    for case in CASES:
        method, now = case[1], case[7]
        path, query, hdrs, body = signed_request(sm, case)
        allow = hdrs["x-amz-content-sha256"] == vm.UNSIGNED
        unsigned += allow
        assert vm.verify(method, path, query, hdrs, body, KEYS.get,
                         now=now, allow_unsigned_payload=allow) \
            == "AKIDEXAMPLE", case[0]
        with pytest.raises(vm.SigError, match="signature mismatch"):
            vm.verify(method, path, query, flip_signature(hdrs), body,
                      KEYS.get, now=now, allow_unsigned_payload=allow)
        if allow:
            # refused unless the verifier opts in
            with pytest.raises(vm.SigError, match="UNSIGNED"):
                vm.verify(method, path, query, hdrs, body, KEYS.get,
                          now=now)
        elif body:
            # one flipped body byte breaks the payload hash
            bad = bytes([body[0] ^ 1]) + body[1:]
            with pytest.raises(vm.SigError, match="payload hash"):
                vm.verify(method, path, query, hdrs, bad, KEYS.get,
                          now=now)
    assert 0 < unsigned < len(CASES)
