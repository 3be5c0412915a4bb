"""The port's object gateway against ceph_tpu's, on the CPU.

One ``MiniCluster`` of each package, side by side: one mon, four OSDs
on WALStores with upstream's 20 s heartbeat grace; the port's on
``device="cpu"`` (the kernels' plain versions).  Each starts its
gateway with ``start_rgw(require_auth=True, stripe_size=4096)`` on an
EC data pool (k=2 m=1 ``jerasure reed_sol_van``, pg_num 4, rule 1,
min_size 2 = k, so that its PGs serve reads with one shard down;
upstream's EC default k + 1 is the pool's whole width here) and the
replicated meta pool.  ``secrets.token_hex``, ``secrets.token_urlsafe``
and ``uuid.uuid4`` are seeded with one stream per package for the
gateway's callers only, so both gateways mint the same keys, bucket
generations, tokens and upload ids.

One script goes to both: users through ``radosgw-admin`` (its output
compared), buckets, PUT/GET/HEAD/DELETE, listings, 404 and 409,
versioning with delete markers and ``ListObjectVersions``, multipart
(striped and unstriped parts, listed parts and uploads, abort,
complete), a bucket policy's allow and deny, an STS session token,
Swift auth with a PUT and GET over the same namespace, lifecycle through
``lifecycle_pass(now=...)``, and refusals (unsigned, a bad signature,
an unknown key, tenant isolation).  The tests then compare every reply
(status, body, ``ETag``/``x-amz-version-id``/``Content-Length`` and the
other named headers), every omap row of ``.rgw.meta``, every object
name and byte of ``.rgw.data``, every OSD's store of the data pool,
each package's ``S3Client`` against the other's gateway, and degraded
GETs of every object with one OSD down, then its revive.

ceph_tpu's gateway lists with the port's pinned pgls
(``test_torch_cluster.pin_pgls``).

Tolerance: exact.  Masked, and nothing else: the time fields ``mtime``
and ``expires`` of omap rows and JSON replies, and the host and port in
Swift's ``X-Storage-Url``.  Every wait polls against a deadline of at
least 10 s; no assertion is on elapsed time.  The tests of the class
run in file order on one pair of clusters.
"""

import base64
import hashlib
import http.client
import json
import random
import secrets
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from ceph_tpu.rgw import gateway as RGW
from ceph_tpu.tools import radosgw_admin as RADMIN
from ceph_tpu.vstart import MiniCluster as RMiniCluster
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.rgw import gateway as PGW
from ceph_tpu_torch.scrub.crc32c import crc32c
from ceph_tpu_torch.tools import radosgw_admin as PADMIN
from ceph_tpu_torch.vstart import MiniCluster as PMiniCluster
from test_torch_cluster import pin_pgls

torch.set_num_threads(1)

K, M = 2, 1
N_OSDS = 4
KILL = 1
STRIPE = 4096
PROFILE = ["k=2", "m=1", "plugin=jerasure", "technique=reed_sol_van"]
DATA_POOL_OPTS = {"pool_type": "erasure", "erasure_code_profile": "k2m1",
                  "pg_num": 4, "rule": 1, "min_size": K}
OSD_CONFIG = {"osd_heartbeat_grace": 20.0}
PKGS = {"ceph_tpu": (RMiniCluster, {}, RGW, RADMIN),
        "port": (PMiniCluster, {"device": "cpu"}, PGW, PADMIN)}
# lifecycle runs at a fixed "now": three days after the script
LC_AFTER_S = 3 * 86400.0
# the reply headers compared (Date and Server are the clock's and the
# interpreter's)
HEADERS = ("ETag", "x-amz-version-id", "Content-Length", "Content-Type",
           "X-Object-Size", "X-Auth-Token", "X-Storage-Url", "Retry-After")
TIME_FIELDS = ("mtime", "expires")


def wait_for(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


class SeededStreams:
    """``secrets.token_hex``/``token_urlsafe`` and ``uuid.uuid4`` drawn
    from one seeded stream per package when the caller is that
    package's ``rgw.gateway``; every other caller gets the real ones."""

    def __init__(self, seed):
        self.rngs = {pkg: random.Random(seed) for pkg in PKGS}
        self.real = (secrets.token_hex, secrets.token_urlsafe, uuid.uuid4)

    def _rng(self):
        name = sys._getframe(2).f_globals.get("__name__", "")
        if not name.endswith(".rgw.gateway"):
            return None
        return self.rngs["port" if name.startswith("ceph_tpu_torch.")
                         else "ceph_tpu"]

    def token_hex(self, nbytes=None):
        rng = self._rng()
        if rng is None:
            return self.real[0](nbytes)
        return rng.randbytes(nbytes or 32).hex()

    def token_urlsafe(self, nbytes=None):
        rng = self._rng()
        if rng is None:
            return self.real[1](nbytes)
        return base64.urlsafe_b64encode(
            rng.randbytes(nbytes or 32)).rstrip(b"=").decode()

    def uuid4(self):
        rng = self._rng()
        if rng is None:
            return self.real[2]()
        return uuid.UUID(bytes=rng.randbytes(16), version=4)


def mask(obj):
    """Time fields of a JSON value replaced by a marker."""
    if isinstance(obj, dict):
        return {k: ("<t>" if k in TIME_FIELDS else mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask(v) for v in obj]
    return obj


def mask_bytes(raw: bytes):
    try:
        val = json.loads(raw)
    except ValueError:
        return raw
    return mask(val) if isinstance(val, (dict, list)) else raw


def reply(status, headers, body):
    """A reply as compared: status, the named headers, the body with
    its time fields masked (and then its length, which counts the
    digits of the time)."""
    hdrs = {h: headers[h] for h in HEADERS if h in headers}
    if "X-Storage-Url" in hdrs:
        hdrs["X-Storage-Url"] = "/" + hdrs["X-Storage-Url"].split(
            "/", 3)[-1]
    masked = mask_bytes(body)
    if masked != mask_bytes(body.replace(b'"expires"', b'"x"')):
        hdrs["Content-Length"] = "<t>"
    return status, hdrs, masked


def raw(port, method, path, headers=None, body=b""):
    """One plain HTTP request (the Swift dialect and the unsigned
    client), → the reply as compared."""
    con = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        con.request(method, path, body=body or None, headers=headers or {})
        resp = con.getresponse()
        return reply(resp.status, dict(resp.getheaders()), resp.read())
    finally:
        con.close()


def payload(seed, n):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


class Side:
    """One package's cluster, gateway and script helpers."""

    def __init__(self, pkg, cluster, rados, gw):
        self.pkg, self.c, self.r, self.gw = pkg, cluster, rados, gw
        _mc, _kw, self.mod, self.admin_mod = PKGS[pkg]
        self.store = gw.store
        self.mon = ",".join(f"{a.host}:{a.port}"
                            for a in cluster.monmap.mons.values())
        self.out = []           # the script's replies, in order
        self.keys = {}          # uid → user json

    def client(self, uid=None, secret=None, mod=None):
        mod = mod or self.mod
        if uid is None:
            return mod.S3Client("127.0.0.1", self.gw.port)
        user = self.keys[uid]
        return mod.S3Client("127.0.0.1", self.gw.port, user["access_key"],
                            secret or user["secret_key"])

    def s3(self, cl, method, path, body=b""):
        rep = reply(*cl._req(method, path, body))
        self.out.append(("s3", method, path, rep))
        return rep

    def swift(self, method, path, headers=None, body=b""):
        rep = raw(self.gw.port, method, path, headers, body)
        self.out.append(("swift", method, path, rep))
        return rep

    def admin(self, *argv):
        lines = []

        def capture(*a, file=None, **_k):
            lines.append(("err" if file is sys.stderr else "out",
                          " ".join(str(x) for x in a)))

        self.admin_mod.print = capture
        try:
            rc = self.admin_mod.main(["-m", self.mon, *argv])
        finally:
            del self.admin_mod.print
        self.out.append(("admin", argv, rc, lines))
        return rc, lines

    def note(self, what, value):
        self.out.append(("store", what, mask(value)))
        return value


def script(s: Side):
    """The S3, Swift and admin script; replies land in ``s.out``."""
    bodies = {"k1": payload(1, 100), "k2": payload(2, 5000),
              "dir/k3": b"", "sp%20ace": payload(3, 777)}
    # users (radosgw-admin, as the operator runs it)
    for argv in (("user", "create", "--uid", "alice", "--display-name",
                  "Alice"),
                 ("user", "create", "--uid", "bob"),
                 ("user", "create", "--uid", "carol"),
                 ("user", "create", "--uid", "alice"),     # exists
                 ("user", "list"), ("user", "info", "--uid", "alice"),
                 ("user", "info", "--uid", "nobody"),
                 ("user", "rm", "--uid", "carol"),
                 ("user", "rm", "--uid", "carol"),
                 ("user", "list"), ("bucket", "list")):
        rc, lines = s.admin(*argv)
        if argv[:2] == ("user", "create") and rc == 0:
            user = json.loads(lines[0][1])
            s.keys[user["uid"]] = user
    alice, bob, anon = s.client("alice"), s.client("bob"), s.client()
    # buckets and objects
    s.s3(alice, "GET", "/")
    for path in ("/b1", "/b1", "/swift", "/lc.x", "/b2", "/b3"):
        s.s3(alice, "PUT", path)
    s.s3(bob, "PUT", "/bobb")
    for k, body in bodies.items():
        s.s3(alice, "PUT", f"/b1/{k}", body)
    for k in (*bodies, "missing"):
        s.s3(alice, "GET", f"/b1/{k}")
        s.s3(alice, "HEAD", f"/b1/{k}")
    s.s3(alice, "GET", "/b1")
    s.s3(alice, "GET", "/nobucket")
    s.s3(alice, "PUT", "/nobucket/k")
    s.s3(alice, "DELETE", "/b1")                       # 409, not empty
    s.s3(alice, "PUT", "/b1/k2", payload(4, 6000))     # overwrite
    s.s3(alice, "GET", "/b1/k2")
    s.s3(alice, "DELETE", "/b1/k2")
    s.s3(alice, "GET", "/b1/k2")
    s.s3(alice, "GET", "/")
    # versioning with delete markers
    s.s3(alice, "PUT", "/b2?versioning",
         b"<VersioningConfiguration><Status>Enabled</Status>"
         b"</VersioningConfiguration>")
    vids = []
    for i in range(3):
        st, hdrs, _ = s.s3(alice, "PUT", "/b2/v", payload(10 + i, 300 + i))
        vids.append(hdrs["x-amz-version-id"])
    s.s3(alice, "PUT", "/b2/other", payload(13, 50))
    for vid in vids:
        s.s3(alice, "GET", f"/b2/v?versionId={vid}")
    _st, hdrs, _ = s.s3(alice, "DELETE", "/b2/v")       # delete marker
    marker = hdrs["x-amz-version-id"]
    s.s3(alice, "GET", "/b2/v")
    s.s3(alice, "HEAD", "/b2/v")
    s.s3(alice, "GET", "/b2?versions")
    s.s3(alice, "GET", "/b2")
    s.s3(alice, "GET", f"/b2/v?versionId={marker}")
    s.s3(alice, "DELETE", f"/b2/v?versionId={marker}")  # newest returns
    s.s3(alice, "GET", "/b2/v")
    s.s3(alice, "DELETE", f"/b2/v?versionId={vids[0]}")
    s.s3(alice, "GET", "/b2?versions")
    # multipart: striped (> stripe_size) and unstriped parts
    _st, _h, body = s.s3(alice, "POST", "/b1/mp1?uploads")
    up = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    parts = {1: payload(20, 3 * STRIPE + 100), 2: payload(21, 3000)}
    for n, data in parts.items():
        s.s3(alice, "PUT", f"/b1/mp1?partNumber={n}&uploadId={up}", data)
    parts[1] = payload(22, 2 * STRIPE + 7)               # re-upload, shrunk
    s.s3(alice, "PUT", f"/b1/mp1?partNumber=1&uploadId={up}", parts[1])
    s.s3(alice, "PUT", f"/b1/mp1?partNumber=0&uploadId={up}", b"x")
    s.s3(alice, "PUT", "/b1/mp1?partNumber=1&uploadId=nosuchupload", b"x")
    s.note("list_parts", s.store.list_parts("b1", up))
    _st, _h, body = s.s3(alice, "POST", "/b1/mp2?uploads")
    up2 = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    s.s3(alice, "PUT", f"/b1/mp2?partNumber=1&uploadId={up2}",
         payload(23, 2 * STRIPE))
    s.s3(alice, "GET", "/b1?uploads")
    s.s3(alice, "DELETE", f"/b1/mp2?uploadId={up2}")     # abort
    _st, _h, body = s.s3(alice, "POST", "/b1/mp3?uploads")
    up3 = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    s.s3(alice, "POST", f"/b1/mp3?uploadId={up3}")       # no parts: 400
    s.s3(alice, "DELETE", f"/b1/mp3?uploadId={up3}")
    s.s3(alice, "GET", "/b1?uploads")
    s.s3(alice, "POST", f"/b1/mp1?uploadId={up}")        # complete
    s.s3(alice, "GET", "/b1/mp1")
    s.s3(alice, "HEAD", "/b1/mp1")
    s.s3(alice, "GET", "/b1?uploads")
    s.s3(alice, "GET", "/b1")
    # a bucket policy: allow bob to read b1's objects, nothing else
    s.s3(bob, "GET", "/b1/k1")
    s.s3(alice, "PUT", "/b1?policy", b"{not json")
    s.s3(alice, "GET", "/b1?policy")
    policy = {"Statement": [{"Effect": "Allow",
                             "Principal": {"AWS": ["bob"]},
                             "Action": ["s3:GetObject"],
                             "Resource": ["arn:aws:s3:::b1/*"]}]}
    s.s3(alice, "PUT", "/b1?policy", json.dumps(policy).encode())
    s.s3(alice, "GET", "/b1?policy")
    s.s3(bob, "GET", "/b1/k1")
    s.s3(bob, "HEAD", "/b1/mp1")
    s.s3(bob, "PUT", "/b1/k9", b"denied")
    s.s3(bob, "GET", "/b1")
    s.s3(bob, "GET", "/b1?policy")
    s.s3(bob, "DELETE", "/b1/k1")
    s.s3(alice, "DELETE", "/b1?policy")
    s.s3(bob, "GET", "/b1/k1")
    # an STS session token
    _st, _h, creds = s.s3(alice, "POST",
                          "/?Action=GetSessionToken&DurationSeconds=900")
    tmp = s.mod.S3Client("127.0.0.1", s.gw.port, creds["access_key"],
                         creds["secret_key"])
    s.s3(tmp, "GET", "/b1/k1")
    s.s3(tmp, "PUT", "/b1/sts", payload(30, 64))
    s.s3(tmp, "GET", "/")
    s.s3(tmp, "POST", "/?Action=GetSessionToken")        # not from temp
    s.s3(alice, "POST", "/?Action=GetSessionToken&DurationSeconds=-1")
    # Swift tempauth and the same namespace
    alice_key = s.keys["alice"]["secret_key"]
    s.swift("GET", "/auth/v1.0", {"X-Auth-User": "alice",
                                  "X-Auth-Key": "wrong"})
    _st, hdrs, _ = s.swift("GET", "/auth/v1.0", {"X-Auth-User": "alice",
                                                 "X-Auth-Key": alice_key})
    tok = {"X-Auth-Token": hdrs["X-Auth-Token"]}
    s.swift("PUT", "/swift/v1/b1/sw1", tok, payload(31, 900))
    s.swift("GET", "/swift/v1/b1/sw1", tok)
    s.swift("HEAD", "/swift/v1/b1/sw1", tok)
    s.s3(alice, "GET", "/b1/sw1")
    s.swift("GET", "/swift/v1/b1/k1", tok)
    s.swift("GET", "/swift/v1/b1", tok)
    s.swift("GET", "/swift/v1", tok)
    s.swift("PUT", "/swift/v1/swc", tok)
    s.swift("HEAD", "/swift/v1/swc", tok)
    s.swift("DELETE", "/swift/v1/swc", tok)
    s.swift("DELETE", "/swift/v1/b1", tok)               # 409
    s.swift("GET", "/swift/v1")                          # no token
    s.swift("GET", "/swift/v1/b1", {"X-Auth-Token": "AUTH_tkbogus"})
    # lifecycle: expiration by prefix, at a fixed "now"
    for k, seed in (("logs/a", 40), ("logs/b", 41), ("keep", 42)):
        s.s3(alice, "PUT", f"/b3/{k}", payload(seed, 200))
    s.s3(alice, "PUT", "/b2/lcv", payload(43, 120))
    s.s3(alice, "PUT", "/b3?lifecycle",
         b"<LifecycleConfiguration><Rule><ID>r1</ID><Prefix>logs/</Prefix>"
         b"<Expiration><Days>1</Days></Expiration></Rule>"
         b"</LifecycleConfiguration>")
    s.s3(alice, "PUT", "/b2?lifecycle",
         b"<LifecycleConfiguration><Rule><ID>v</ID><Prefix>lc</Prefix>"
         b"<Expiration><Days>2</Days></Expiration></Rule>"
         b"</LifecycleConfiguration>")
    s.s3(alice, "PUT", "/b3?lifecycle&x", b"<not xml")
    s.s3(alice, "GET", "/b3?lifecycle")
    s.note("lifecycle_pass", s.store.lifecycle_pass(
        now=time.time() + LC_AFTER_S))
    s.s3(alice, "GET", "/b3")
    s.s3(alice, "GET", "/b2/lcv")
    s.s3(alice, "GET", "/b2?versions")
    # refusals: unsigned, a bad signature, an unknown key, other tenants
    s.s3(anon, "GET", "/b1/k1")
    s.s3(anon, "PUT", "/b1/anon", b"x")
    s.s3(anon, "GET", "/")
    s.s3(s.client("alice", secret="not-the-secret"), "GET", "/b1/k1")
    s.s3(s.mod.S3Client("127.0.0.1", s.gw.port, "AKNOSUCHKEY", "x"),
         "GET", "/b1/k1")
    s.s3(bob, "GET", "/")
    s.s3(alice, "GET", "/")
    s.s3(bob, "DELETE", "/b1")
    s.s3(bob, "GET", "/b2?versions")
    s.s3(alice, "GET", "/bobb")
    # the admin tool after the traffic
    for argv in (("bucket", "list"), ("bucket", "stats", "--bucket", "b1"),
                 ("bucket", "stats", "--bucket", "b2"),
                 ("bucket", "stats", "--bucket", "nobucket"),
                 ("object", "rm", "--bucket", "b1", "--object", "dir/k3"),
                 ("bucket", "rm", "--bucket", "bobb"),
                 ("bucket", "rm", "--bucket", "b3"),
                 ("bucket", "rm", "--bucket", "b3", "--purge-objects"),
                 ("bucket", "list")):
        s.admin(*argv)
    s.s3(alice, "GET", "/b1")


def live_objects(s: Side):
    """{(bucket, key, version id or None): bytes} of every object the
    script leaves readable."""
    out = {}
    for b in s.store.list_buckets():
        for k in s.store.list_objects(b):
            out[b, k, None] = s.store.get_object(b, k)[0]
        for e in s.store.list_versions(b):
            if not e.get("delete_marker"):
                out[b, e["key"], e["version_id"]] = s.store.get_object(
                    b, e["key"], e["version_id"])[0]
    return out


def settled(s: Side):
    """Every PG clean on its primary and every OSD and the client on
    one map epoch."""
    epoch = s.r.objecter.osdmap.epoch
    for osd in s.c.osds.values():
        with osd.lock:
            if osd.osdmap.epoch != epoch or any(
                    pg.state != "active+clean"
                    for pg in osd.pgs.values() if pg.is_primary):
                return False
    return True


def map_spread(s: Side):
    """The gateway's client and every live OSD on one epoch, with
    ``KILL`` down in it."""
    m = s.store.rados.objecter.osdmap
    return not m.is_up(KILL) and all(
        osd.osdmap.epoch == m.epoch for osd in s.c.osds.values())


def meta_rows(s: Side):
    io = s.store.meta
    return {oid: {k: mask_bytes(bytes(v))
                  for k, v in io.omap_get(oid).items()}
            for oid in sorted(io.list_objects())}


def data_objects(s: Side):
    io = s.store.data
    return {oid: bytes(io.read(oid)) for oid in sorted(io.list_objects())}


def data_pool_stores(s: Side):
    """{osd: {(cid, oid): (data, size, hinfo)}} of the data pool's
    collections."""
    pool = s.store.data.pool_id
    views = {}
    for i, osd in sorted(s.c.osds.items()):
        st, view = osd.store, {}
        with osd.lock:
            for cid in st.list_collections():
                if not cid.startswith(f"{pool}."):
                    continue
                for oid in st.list_objects(cid):
                    try:
                        meta = json.loads(bytes(st.getattr(cid, oid, "_")))
                    except KeyError:
                        meta = {}
                    view[cid, oid] = (bytes(st.read(cid, oid)),
                                      meta.get("size"), meta.get("hinfo"))
        views[i] = view
    return views


@pytest.fixture(scope="class")
def pair():
    """{pkg: Side}, both gateways started on seeded streams."""
    streams = SeededStreams(15)
    sides, clusters = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(secrets, "token_hex", streams.token_hex)
        mp.setattr(secrets, "token_urlsafe", streams.token_urlsafe)
        mp.setattr(uuid, "uuid4", streams.uuid4)
        try:
            for pkg, (mc, kw, _mod, _adm) in PKGS.items():
                c = mc(n_mons=1, n_osds=N_OSDS, osd_config=OSD_CONFIG, **kw)
                clusters.append(c)
                c.start()
                r = c.rados()
                rc, outs, _ = r.mon_command({
                    "prefix": "osd erasure-code-profile set",
                    "name": "k2m1", "profile": PROFILE})
                assert rc == 0, outs
                # the gateway lists pools (multipart uploads; the
                # tests' reads of both pools) with the pinned pgls
                gr = c.rados()
                if pkg == "ceph_tpu":
                    pin_pgls(gr.objecter)
                gw = c.start_rgw(rados=gr, require_auth=True,
                                 stripe_size=STRIPE,
                                 data_pool_opts=DATA_POOL_OPTS)
                sides[pkg] = s = Side(pkg, c, r, gw)
                c.wait_for_clean(timeout=120)
                assert wait_for(lambda: settled(s), timeout=60), pkg
            yield sides
        finally:
            for c in clusters:
                c.stop()


class TestGatewayAgainstCephTpu:
    def test_data_pool_is_erasure_on_rule_1(self, pair):
        got = {}
        for pkg, s in pair.items():
            rc, _outs, dump = s.r.mon_command({"prefix": "osd dump"})
            assert rc == 0
            pools = {p["name"]: p for p in dump["pools"]}
            data = pools[".rgw.data"]
            rc, _outs, prof = s.r.mon_command({
                "prefix": "osd erasure-code-profile get",
                "name": data["erasure_code_profile"]})
            got[pkg] = (data["type"], data["crush_rule"], data["size"],
                        data["min_size"], data["pg_num"], prof,
                        pools[".rgw.meta"]["type"])
        assert got["port"] == got["ceph_tpu"]
        _type, rule, size, min_size, pg_num, prof, _meta = got["port"]
        assert (rule, size, min_size, pg_num) == (1, K + M, K, 4)
        assert (prof["k"], prof["m"]) == (str(K), str(M))

    def test_script_replies_match(self, pair):
        for s in pair.values():
            script(s)
        assert len(pair["port"].out) == len(pair["ceph_tpu"].out)
        for got, want in zip(pair["port"].out, pair["ceph_tpu"].out):
            assert got == want
        # the script's own answers, so equal-but-wrong cannot pass
        out = {}            # the first reply to each request
        for e in pair["port"].out:
            if e[0] in ("s3", "swift"):
                out.setdefault(e[:3], e[-1])
        assert out["s3", "GET", "/b1/k1"] == (
            200, {"ETag": f'"{hashlib.md5(payload(1, 100)).hexdigest()}"',
                  "Content-Length": "100",
                  "Content-Type": "application/octet-stream"},
            payload(1, 100))
        parts = [payload(22, 2 * STRIPE + 7), payload(21, 3000)]
        etag = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                    for p in parts)).hexdigest() + "-2"
        assert out["s3", "GET", "/b1/mp1"][1]["ETag"] == f'"{etag}"'
        assert out["s3", "GET", "/b1/mp1"][2] == b"".join(parts)
        assert out["s3", "PUT", "/b1/k9"][0] == 403
        gets = [e[-1] for e in pair["port"].out
                if e[:3] == ("s3", "GET", "/b2/v")]
        assert [g[0] for g in gets] == [404, 200]     # marker, removed
        assert gets[1][2] == payload(12, 302)
        assert out["swift", "GET", "/swift/v1/b1/sw1"][2] == \
            payload(31, 900)
        assert out["s3", "GET", "/b1/sw1"][2] == payload(31, 900)
        assert out["s3", "GET", "/b3"][2].count(b"<Key>") == 1
        lc = [e for e in pair["port"].out if e[1] == "lifecycle_pass"]
        assert lc == [("store", "lifecycle_pass", 3)]
        rows = next(e[2] for e in pair["port"].out
                    if e[1] == "list_parts")
        assert [len(p.get("stripes", [])) for p in rows] == [3, 0]

    def test_meta_pool_rows_match(self, pair):
        for s in pair.values():
            assert wait_for(lambda: settled(s), timeout=60), s.pkg
        rows = {pkg: meta_rows(s) for pkg, s in pair.items()}
        assert rows["port"] == rows["ceph_tpu"]
        users = rows["port"][PGW.USERS_OID]
        assert sorted(k for k in users if "\x00" not in k) == \
            ["alice", "bob"]
        assert any(k.startswith("bilog.index.b1.") for k in rows["port"])

    def test_data_pool_objects_match(self, pair):
        objs = {pkg: data_objects(s) for pkg, s in pair.items()}
        assert objs["port"] == objs["ceph_tpu"]
        live = live_objects(pair["port"])
        assert live == live_objects(pair["ceph_tpu"])
        assert live["b1", "mp1", None] == \
            payload(22, 2 * STRIPE + 7) + payload(21, 3000)
        # the striped part's stripes are RADOS objects of their own
        assert sum("\x00_mp_" in o and o.rsplit("\x00", 1)[-1][0] == "s"
                   for o in objs["port"]) == 3

    def test_data_pool_stores_match(self, pair):
        views = {pkg: data_pool_stores(s) for pkg, s in pair.items()}
        assert views["port"] == views["ceph_tpu"]
        # every shard and hinfo is the CPU re-encode's
        s = pair["port"]
        ec = create_erasure_code({"plugin": "jerasure",
                                  "technique": "reed_sol_van", "k": K,
                                  "m": M}, device="cpu")
        m = next(iter(s.c.osds.values())).osdmap
        pool = s.store.data.pool_id
        n_shards = 0
        for oid, data in data_objects(s).items():
            enc = ec.encode(set(range(K + M)), data)
            pgid = m.raw_pg_to_pg(m.object_locator_to_pg(oid, pool))
            for sh, osd in enumerate(m.pg_to_up_acting_osds(pgid)[2]):
                got, size, hinfo = views["port"][osd][f"{pgid}s{sh}", oid]
                assert got == bytes(np.asarray(enc[sh])), (oid, sh)
                assert size == len(data) and hinfo == crc32c(got)
                n_shards += 1
        assert n_shards > 0

    def test_clients_cross_packages(self, pair):
        """Each package's ``S3Client`` against the other's gateway gives
        the replies of the gateway's own client."""
        def run(s, mod):
            alice = s.client("alice", mod=mod)
            bob = s.client("bob", mod=mod)
            got = [reply(*alice._req(m, p, b)) for m, p, b in (
                ("GET", "/", b""), ("GET", "/b1", b""),
                ("GET", "/b1/k1", b""), ("HEAD", "/b1/mp1", b""),
                ("GET", "/b1/mp1", b""), ("GET", "/b2?versions", b""),
                ("GET", "/b1?uploads", b""),
                ("PUT", "/b1/cross", payload(50, 5 * STRIPE)),
                ("GET", "/b1/cross", b""), ("DELETE", "/b1/cross", b""),
                ("GET", "/b1/cross", b""))]
            got.append(reply(*bob._req("GET", "/b1/k1")))
            got.append(mod.S3Client("127.0.0.1", s.gw.port).head("b1", "k1"))
            for cl in (alice, bob):
                cl.close()
            return got

        got = {(pkg, client): run(s, PKGS[client][2])
               for pkg, s in pair.items() for client in PKGS}
        want = got["ceph_tpu", "ceph_tpu"]
        for key, replies in got.items():
            assert replies == want, key
        assert want[2][2] == payload(1, 100) and want[8][2] == \
            payload(50, 5 * STRIPE)
        assert (want[10][0], want[11][0], want[12]) == (404, 403, 403)

    def test_degraded_gets_and_revive(self, pair):
        want = live_objects(pair["ceph_tpu"])
        got = {}
        for pkg, s in pair.items():
            s.c.kill_osd(KILL)
            # the operator's `ceph osd down`, not the 20 s grace
            rc, outs, _ = s.r.mon_command({"prefix": "osd down",
                                           "ids": [KILL]})
            assert rc == 0, outs
            s.c.wait_for_osd_down(KILL, timeout=30)
            # the gateway's client on the live OSDs' epoch first: a GET
            # sent on the older map waits out the Objecter's resend
            assert wait_for(lambda: map_spread(s), timeout=60), pkg
            alice = s.client("alice")
            replies = {}
            for (b, k, vid) in sorted(want, key=str):
                path = f"/{b}/{k}" + (f"?versionId={vid}" if vid else "")
                replies[b, k, vid] = reply(*alice._req("GET", path))
            got[pkg] = replies
            alice.close()
            s.c.revive_osd(KILL)
            s.c.wait_for_clean(timeout=120)
            assert wait_for(lambda: settled(s), timeout=60), pkg
        assert got["port"] == got["ceph_tpu"]
        assert {key: rep[2] for key, rep in got["port"].items()} == want
        assert all(rep[0] == 200 for rep in got["port"].values())
        views = {pkg: data_pool_stores(s) for pkg, s in pair.items()}
        assert views["port"] == views["ceph_tpu"]
