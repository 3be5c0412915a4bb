"""RGW gateway — an S3-dialect REST frontend over RADOS.

The port's copy of ``ceph_tpu.rgw.gateway``.

Reference behavior re-created (``src/rgw/``: ``rgw_main.cc`` REST
frontend, ``rgw_op.cc`` op layer, ``rgw_rados.cc`` store; SURVEY.md
§3.9), reduced to the core S3 data path:

- buckets: ``PUT/DELETE /bucket``, ``GET /bucket`` lists keys
  (XML ListBucketResult like S3); the bucket index is **sharded**
  across N omap objects by key hash (the reference's ``cls_rgw``
  sharded bucket index): writes touch only the key's shard under a
  per-shard lock — concurrent PUTs to different shards do not
  serialize — and listings merge all shards;
- objects: ``PUT/GET/HEAD/DELETE /bucket/key``; bytes live in RADOS
  objects ``<bucket>_<key>`` in the ``.rgw.data`` pool, metadata
  (size, etag) in the bucket index;
- ``GET /`` lists buckets (ListAllMyBucketsResult);
- **multipart upload** (reference ``rgw_op.cc`` InitMultipart/
  PutObj/CompleteMultipart + the RGW manifest): ``POST ?uploads`` →
  UploadId, ``PUT ?partNumber&uploadId`` stores each part as its own
  RADOS object, complete writes a MANIFEST index entry (parts are
  never rewritten — GET concatenates), abort removes the parts;
  multipart ETags are S3-style ``md5(part-digests)-N``;
- **versioning** (reference ``rgw_rados.cc`` olh/versioning): ``PUT
  ?versioning`` enables per-bucket; each PUT then mints a version id,
  old versions stay readable via ``?versionId=``, DELETE without a
  version writes a delete marker, ``GET ?versions`` lists all.

ETags are MD5 hex like S3.  With ``require_auth=True`` the gateway
enforces SigV4 signatures, per-user keys, bucket ownership, and
IAM-style bucket policies (``?policy``); STS session tokens
(``?Action=GetSessionToken``) mint temporary credentials.  A **Swift
frontend** (``/auth/v1.0`` tempauth + ``/swift/v1/...``) serves the
same buckets/objects as the S3 dialect.
"""

from __future__ import annotations

import asyncio
import hashlib
import http.client
import io
import json
import math
import socket
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from xml.sax.saxutils import escape as _xesc
from http.server import BaseHTTPRequestHandler

from ..core.lockdep import Mutex
from ..osdc.librados import ObjectNotFound

DATA_POOL = ".rgw.data"
META_POOL = ".rgw.meta"
BUCKETS_OID = "buckets"          # omap: bucket name → meta json
USERS_OID = "users"              # omap: uid → user json, ak\0<key> → uid


DEFAULT_INDEX_SHARDS = 16       # reference rgw_override_bucket_index_max_shards
# dedicated ?policy subresource actions (reference rgw_iam_policy
# s3:{Get,Put,Delete}BucketPolicy): never satisfied by s3:* grants
POLICY_ACTIONS = frozenset({
    "s3:GetBucketPolicy", "s3:PutBucketPolicy",
    "s3:DeleteBucketPolicy"})


def _index_oid(bucket: str) -> str:
    """Legacy (pre-sharding) single index object; buckets whose meta
    row carries no num_shards keep using it."""
    return f"index.{bucket}"


def _shard_oid(bucket: str, shard: int) -> str:
    return f"index.{bucket}.{shard:04x}"


def _data_oid(bucket: str, key: str) -> str:
    return f"{bucket}\x00{key}"


def _version_oid(bucket: str, key: str, vid: str) -> str:
    return f"{bucket}\x00{key}\x00v{vid}"


def _versions_oid(bucket: str) -> str:
    return f"versions.{bucket}"


def _mp_oid(bucket: str, upload_id: str) -> str:
    # NUL separator: bucket names may contain dots, so a dotted
    # prefix match would bleed across buckets
    return f"multipart.{bucket}\x00{upload_id}"


def _part_oid(bucket: str, upload_id: str, n: int) -> str:
    return f"{bucket}\x00_mp_{upload_id}\x00{n:05d}"


def _stripe_oid(bucket: str, upload_id: str, n: int, j: int) -> str:
    """One stripe of a striped multipart part (reference the RGW
    manifest's rgw_obj_stripe_size layout: big parts split into
    fixed-size tail stripes)."""
    return f"{_part_oid(bucket, upload_id, n)}\x00s{j:04d}"


class RGWStore:
    """The op layer (reference rgw_op.cc + rgw_rados.cc, trimmed)."""

    def __init__(self, rados, *, stripe_size: int = 0,
                 data_pool_opts: dict | None = None):
        self.rados = rados
        # stripe_size: multipart part bodies above this split into
        # stripe_size RADOS objects written CONCURRENTLY via the aio
        # path — on an EC data pool the stripes land in the batch
        # engine's encode lane together and coalesce into megabatch
        # launches (0 = never stripe)
        self.stripe_size = int(stripe_size)
        for pool, opts in ((DATA_POOL, data_pool_opts or {}),
                           (META_POOL, {})):
            try:
                rados.create_pool(pool, **{
                    "pg_num": 8, "size": 2, **opts})
            except Exception:
                pass        # exists
        self.meta = rados.open_ioctx(META_POOL)
        self.data = rados.open_ioctx(DATA_POOL)
        # the frontend is a ThreadingHTTPServer: index/version-seq
        # read-modify-writes must not interleave (the reference gets
        # this atomicity from cls_rgw ops executing on the OSD).
        # Named lockdep mutexes; lock ORDER is shard → verseq, and
        # ordering violations against other named mutexes fail
        # deterministically under tests
        self._lock = Mutex("rgwstore")          # buckets/multipart misc
        self._locks_guard = threading.Lock()    # protects the maps below
        self._shard_locks: dict[tuple, Mutex] = {}
        self._ver_locks: dict[str, Mutex] = {}

    def _drop_parts(self, meta: dict | None):
        """Remove a manifest's part objects (nothing else references
        them once their manifest row is replaced/deleted)."""
        for p in (meta or {}).get("parts", []):
            try:
                self.data.remove(p)
            except Exception:
                pass

    # -- sharded bucket index ----------------------------------------------
    # (reference cls_rgw: per-shard index objects whose omap ops run
    # server-side; here the shard objects live in the meta pool and a
    # per-shard host-side lock provides the RMW atomicity)
    def _bucket_shards(self, bucket: str) -> int:
        """Shard count from the bucket meta row; 0 ⇒ legacy single
        index object (pre-sharding buckets keep working).  Read fresh
        each time (single-row server-side fetch): caching here raced
        create_bucket and went permanently stale across RGWStore
        instances (gateway vs sync daemon vs radosgw-admin)."""
        try:
            row = self.meta.omap_get(BUCKETS_OID,
                                     keys=[bucket]).get(bucket)
        except ObjectNotFound:
            row = None
        return (int(json.loads(bytes(row)).get("num_shards", 0))
                if row else 0)

    def _key_shard(self, bucket: str, key: str) -> int:
        n = self._bucket_shards(bucket)
        return (zlib.crc32(key.encode()) % n) if n else 0

    def _key_index_oid(self, bucket: str, key: str) -> str:
        n = self._bucket_shards(bucket)
        if not n:
            return _index_oid(bucket)
        return _shard_oid(bucket, zlib.crc32(key.encode()) % n)

    def _all_index_oids(self, bucket: str) -> list[str]:
        n = self._bucket_shards(bucket)
        if not n:
            return [_index_oid(bucket)]
        return [_shard_oid(bucket, s) for s in range(n)]

    def _index_get(self, bucket: str, key: str) -> dict | None:
        return self._index_get_at(
            self._key_index_oid(bucket, key), key)

    def _index_set(self, bucket: str, key: str, meta: dict):
        self._index_set_at(self._key_index_oid(bucket, key), key,
                           meta)

    def _index_rm(self, bucket: str, key: str):
        oid = self._key_index_oid(bucket, key)
        self.meta.omap_rm_keys(oid, [key])
        self._bilog_append(oid, {"op": "del", "key": key})

    def _shard_lock(self, bucket: str, key: str):
        """The write lock for `key`'s index shard: PUT/DELETE on
        different shards proceed concurrently."""
        return self._key_index_ref(bucket, key)[1]

    def _key_index_ref(self, bucket: str, key: str):
        """→ (shard oid, shard lock) with ONE bucket-meta fetch —
        the write paths resolve this once per op instead of paying
        three identical single-row round trips."""
        n = self._bucket_shards(bucket)
        shard = (zlib.crc32(key.encode()) % n) if n else 0
        oid = _shard_oid(bucket, shard) if n else _index_oid(bucket)
        sid = (bucket, shard)
        with self._locks_guard:
            lk = self._shard_locks.get(sid)
            if lk is None:
                lk = self._shard_locks[sid] = Mutex("rgw-shard")
        return oid, lk

    def _index_get_at(self, oid: str, key: str) -> dict | None:
        try:
            row = self.meta.omap_get(oid, keys=[key]).get(key)
        except ObjectNotFound:
            return None
        return json.loads(bytes(row)) if row else None

    def _index_set_at(self, oid: str, key: str, meta: dict):
        self.meta.omap_set(oid, {key: json.dumps(meta).encode()})
        rec = {"op": "put", "key": key,
               "etag": meta.get("etag", "")}
        if meta.get("delete_marker"):
            rec["op"] = "del"          # current version is a marker
        self._bilog_append(oid, rec)

    # -- bucket index log (reference rgw bilog: cls_rgw bi_log_*) ----------
    # Every index-row mutation appends an entry to the shard's log so
    # multisite data sync can consume per-shard deltas instead of
    # re-listing buckets.  The log is capped (reference: bilog trim);
    # a consumer that falls behind the cap sees a seq gap and falls
    # back to full sync for that bucket.
    _BILOG_KEEP = 512
    _BILOG_TRIM_EVERY = 64

    @staticmethod
    def _bilog_oid(index_oid: str) -> str:
        return f"bilog.{index_oid}"

    def _bilog_append(self, index_oid: str, rec: dict):
        oid = self._bilog_oid(index_oid)
        try:
            rows = self.meta.omap_get(oid, keys=["head", "tail"])
            head = int(rows.get("head", b"0"))
            tail = int(rows.get("tail", b"0"))
        except ObjectNotFound:
            head = tail = 0
        head += 1
        self.meta.omap_set(oid, {
            f"e{head:016d}": json.dumps(rec).encode(),
            "head": str(head).encode()})
        if head % self._BILOG_TRIM_EVERY == 0:
            # entry keys are deterministic, so the cap-trim computes
            # the dead window from the persisted tail instead of
            # re-reading the whole log on the object-write hot path
            floor = head - self._BILOG_KEEP
            if floor > tail:
                self.meta.omap_rm_keys(oid, [
                    f"e{s:016d}" for s in range(tail + 1, floor + 1)])
                self.meta.omap_set(oid, {
                    "tail": str(floor).encode()})

    def bilog_shards(self, bucket: str) -> int:
        """Number of index shards (1 for legacy unsharded buckets)."""
        return self._bucket_shards(bucket) or 1

    def _bilog_shard_oid(self, bucket: str, shard: int) -> str:
        n = self._bucket_shards(bucket)
        ioid = _shard_oid(bucket, shard) if n else _index_oid(bucket)
        return self._bilog_oid(ioid)

    def bilog_head(self, bucket: str, shard: int) -> int:
        try:
            rows = self.meta.omap_get(
                self._bilog_shard_oid(bucket, shard), keys=["head"])
        except ObjectNotFound:
            return 0
        return int(rows.get("head", b"0"))

    def bilog_entries(self, bucket: str, shard: int,
                      after: int = 0) -> list[tuple[int, dict]]:
        """Shard log entries with seq > after, in order."""
        try:
            rows = self.meta.omap_get(
                self._bilog_shard_oid(bucket, shard))
        except ObjectNotFound:
            return []
        out = []
        for k, v in rows.items():
            if k.startswith("e") and int(k[1:]) > after:
                out.append((int(k[1:]), json.loads(bytes(v))))
        return sorted(out)

    def bilog_trim(self, bucket: str, shard: int, upto: int):
        """Drop consumed entries (reference: radosgw-admin bilog trim
        / the sync-driven trim once every peer passed `upto`)."""
        oid = self._bilog_shard_oid(bucket, shard)
        try:
            rows = self.meta.omap_get(oid, keys=["tail"])
            tail = int(rows.get("tail", b"0"))
        except ObjectNotFound:
            return
        if upto > tail:
            self.meta.omap_rm_keys(oid, [
                f"e{s:016d}" for s in range(tail + 1, upto + 1)])
            self.meta.omap_set(oid, {"tail": str(upto).encode()})

    def _ver_lock(self, bucket: str):
        """Version-sequence lock (one per bucket); always taken INSIDE
        the key's shard lock when both are needed."""
        with self._locks_guard:
            lk = self._ver_locks.get(bucket)
            if lk is None:
                lk = self._ver_locks[bucket] = Mutex("rgw-verseq")
        return lk

    # -- users (reference RGWUserAdminOp / rgw_user.cc) --------------------
    # stored in the meta pool: "users" omap uid → user json, plus an
    # access-key → uid row for O(1) SigV4 lookup
    def create_user(self, uid: str, display_name: str = "") -> dict:
        import secrets
        with self._lock:
            try:
                rows = self.meta.omap_get(USERS_OID)
            except ObjectNotFound:
                rows = {}
            if uid in rows:
                return json.loads(bytes(rows[uid]))
            user = {
                "uid": uid,
                "display_name": display_name or uid,
                "access_key": secrets.token_hex(10).upper(),
                "secret_key": secrets.token_urlsafe(30),
            }
            self.meta.omap_set(USERS_OID, {
                uid: json.dumps(user).encode(),
                f"ak\x00{user['access_key']}": uid.encode(),
            })
        return user

    def get_user(self, uid: str) -> dict | None:
        try:
            row = self.meta.omap_get(USERS_OID, keys=[uid]).get(uid)
        except ObjectNotFound:
            return None
        return json.loads(bytes(row)) if row else None

    def list_users(self) -> list[dict]:
        try:
            rows = self.meta.omap_get(USERS_OID)
        except ObjectNotFound:
            return []
        return sorted((json.loads(bytes(v)) for k, v in rows.items()
                       if not k.startswith("ak\x00")),
                      key=lambda u: u["uid"])

    def remove_user(self, uid: str) -> bool:
        with self._lock:
            user = self.get_user(uid)
            if user is None:
                return False
            self.meta.omap_rm_keys(USERS_OID, [
                uid, f"ak\x00{user['access_key']}"])
        return True

    def secret_for_access_key(self, access_key: str) -> str | None:
        """SigV4 verifier hook: access key → secret key (single-row
        server-side fetches, not a full user-table scan)."""
        found = self.resolve_access_key(access_key)
        return found[1] if found else None

    def resolve_access_key(self, access_key: str
                           ) -> tuple[str, str, bool] | None:
        """→ (uid, secret, is_temporary) for a permanent or
        unexpired temporary (STS) access key; None otherwise.
        Expired temporary rows are pruned on sight so the user table
        cannot grow without bound."""
        import time as _time
        tkey = f"tmp\x00{access_key}"
        try:
            tmp_row = self.meta.omap_get(USERS_OID,
                                         keys=[tkey]).get(tkey)
        except ObjectNotFound:
            tmp_row = None
        if tmp_row is not None:
            creds = json.loads(bytes(tmp_row))
            if creds["expires"] < _time.time():
                try:
                    self.meta.omap_rm_keys(USERS_OID, [tkey])
                except ObjectNotFound:
                    pass
                return None     # expired session token
            return creds["uid"], creds["secret_key"], True
        akey = f"ak\x00{access_key}"
        try:
            uid_row = self.meta.omap_get(USERS_OID,
                                         keys=[akey]).get(akey)
        except ObjectNotFound:
            return None
        if uid_row is None:
            return None
        uid = bytes(uid_row).decode()
        user = self.get_user(uid)
        return (uid, user["secret_key"], False) if user else None

    # -- buckets -----------------------------------------------------------
    def create_bucket(self, bucket: str,
                      index_shards: int = DEFAULT_INDEX_SHARDS,
                      owner: str | None = None) -> bool:
        if bucket == "swift":
            # reserved: /swift/v1 is the Swift dialect mount; an S3
            # bucket of that name would have its keys hijacked
            return False
        if bucket.startswith("lc.") or bucket.startswith("policy."):
            # these namespaces share the buckets omap; a literal
            # "lc.x"/"policy.x" bucket would collide and poison the
            # lifecycle pass / policy lookups
            return False
        if self.bucket_exists(bucket):
            return True     # re-create keeps the existing shard count
        import secrets
        # a fresh incarnation token: multisite sync markers recorded
        # against a deleted+recreated bucket of the same name must
        # not be trusted (its bilog seqs restarted from zero)
        row = {"name": bucket, "num_shards": index_shards,
               "gen": secrets.token_hex(8)}
        if owner:
            row["owner"] = owner
        self.meta.omap_set(BUCKETS_OID, {
            bucket: json.dumps(row).encode()})
        return True

    def _bucket_row(self, bucket: str) -> dict | None:
        """The bucket's meta row, or None when the bucket does not
        exist — one single-key omap read (bucket_exists() fetches the
        whole omap; the per-request auth path must not)."""
        try:
            raw = self.meta.omap_get(BUCKETS_OID,
                                     keys=[bucket]).get(bucket)
        except ObjectNotFound:
            return None
        return json.loads(bytes(raw)) if raw else None

    def bucket_owner(self, bucket: str) -> str | None:
        row = self._bucket_row(bucket)
        return row.get("owner") if row else None

    def bucket_gen(self, bucket: str) -> str | None:
        """Incarnation token minted at create (None for legacy rows)."""
        row = self._bucket_row(bucket)
        return row.get("gen") if row else None

    # -- bucket policies (reference rgw IAM-ish policies) ------------------
    def set_bucket_policy(self, bucket: str, policy: dict):
        self.meta.omap_set(BUCKETS_OID, {
            f"policy.{bucket}": json.dumps(policy).encode()})

    def get_bucket_policy(self, bucket: str) -> dict | None:
        key = f"policy.{bucket}"
        try:
            raw = self.meta.omap_get(BUCKETS_OID, keys=[key]).get(key)
        except ObjectNotFound:
            return None
        if not raw:
            return None
        try:
            return json.loads(bytes(raw))
        except ValueError:
            # a directly-written non-JSON row must fail closed (deny
            # in authorize), not 500 the request handler
            return None

    def delete_bucket_policy(self, bucket: str):
        self.meta.omap_rm_keys(BUCKETS_OID, [f"policy.{bucket}"])

    def _set_bucket_owner(self, bucket: str, owner: str):
        # under _lock, re-reading the row first: a concurrent
        # delete_bucket (also under _lock) must not have its row
        # resurrected by this read-modify-write
        with self._lock:
            row = self._bucket_row(bucket)
            if row is None:
                return
            row["owner"] = owner
            self.meta.omap_set(BUCKETS_OID, {
                bucket: json.dumps(row).encode()})

    def authorize(self, uid: str | None, action: str, bucket: str,
                  key: str = "") -> bool:
        """IAM-style decision (reference rgw_iam_policy evaluation,
        reduced): the bucket owner may do everything; otherwise the
        bucket policy's Allow statements decide — Principal "*" or a
        listed uid, Action exact or "s3:*" (the dedicated
        *BucketPolicy actions require an exact grant), Resource "*",
        the bare bucket arn for bucket-level requests, or
        arn/key / arn/* for object-level requests.

        Buckets with no recorded owner (created pre-auth or via an
        untokened Swift path) are claimed by the first authenticated
        caller rather than staying world-writable."""
        row = self._bucket_row(bucket)
        owner = row.get("owner") if row else None
        if uid is not None and owner is None and row is not None:
            self._set_bucket_owner(bucket, uid)
            owner = uid
        if uid is not None and (owner is None or owner == uid):
            return True
        policy = self.get_bucket_policy(bucket)
        if not isinstance(policy, dict):
            return False
        statements = policy.get("Statement", [])
        if not isinstance(statements, list):
            return False
        arn_bucket = f"arn:aws:s3:::{bucket}"
        for st in statements:
            # stored policies are validated at PUT time, but older or
            # directly-written rows must fail closed, not 500
            if not isinstance(st, dict) or st.get("Effect") != "Allow":
                continue
            principal = st.get("Principal", {})
            allowed = principal in ("*", {"AWS": "*"})
            if not allowed and isinstance(principal, dict):
                aws = principal.get("AWS", [])
                aws = ([aws] if isinstance(aws, str)
                       else aws if isinstance(aws, list) else [])
                allowed = uid is not None and uid in aws
            if not allowed:
                continue
            actions = st.get("Action", [])
            actions = ([actions] if isinstance(actions, str)
                       else actions if isinstance(actions, list)
                       else [])
            if action in POLICY_ACTIONS:
                # reading/rewriting the policy itself is never
                # implied by s3:* — an object-scope grantee must not
                # be able to escalate to policy control
                if action not in actions:
                    continue
            elif action not in actions and "s3:*" not in actions:
                continue
            resources = st.get("Resource", [])
            resources = ([resources] if isinstance(resources, str)
                         else resources if isinstance(resources, list)
                         else [])
            for res in resources:
                if res == "*":
                    return True
                if key:
                    # object-level request: bucket-only ARNs do not
                    # match, and bucket/* matches objects only
                    if res in (f"{arn_bucket}/{key}",
                               f"{arn_bucket}/*"):
                        return True
                elif res == arn_bucket:
                    # bucket-level request: requires the bare bucket
                    # ARN — bucket/* grants object access only (AWS
                    # semantics: a privilege escalation otherwise)
                    return True
        return False

    # -- STS (reference rgw STS GetSessionToken) ---------------------------
    def sts_get_session_token(self, uid: str,
                              duration_s: float = 3600.0) -> dict:
        import secrets
        import time as _time
        creds = {
            "access_key": "TMP" + secrets.token_hex(8).upper(),
            "secret_key": secrets.token_urlsafe(30),
            "uid": uid,
            "expires": _time.time() + min(max(duration_s, 60.0),
                                          12 * 3600.0),
        }
        self.meta.omap_set(USERS_OID, {
            f"tmp\x00{creds['access_key']}":
                json.dumps(creds).encode()})
        return creds

    # -- swift tempauth tokens ---------------------------------------------
    def swift_issue_token(self, uid: str) -> str:
        import secrets
        import time as _time
        token = "AUTH_tk" + secrets.token_hex(16)
        self.meta.omap_set(USERS_OID, {
            f"swtok\x00{token}": json.dumps({
                "uid": uid,
                "expires": _time.time() + 3600.0}).encode()})
        return token

    def swift_token_uid(self, token: str) -> str | None:
        import time as _time
        key = f"swtok\x00{token}"
        try:
            row = self.meta.omap_get(USERS_OID, keys=[key]).get(key)
        except ObjectNotFound:
            return None
        if row is None:
            return None
        info = json.loads(bytes(row))
        if info["expires"] < _time.time():
            try:
                self.meta.omap_rm_keys(USERS_OID, [key])
            except ObjectNotFound:
                pass
            return None
        return info["uid"]

    def delete_bucket(self, bucket: str) -> bool:
        if self.list_objects(bucket):
            return False            # 409 BucketNotEmpty
        # (list_objects raises on cluster outage, so an unreachable
        # index can never masquerade as an empty bucket here)
        oids = self._all_index_oids(bucket)
        with self._lock:       # excludes _set_bucket_owner's RMW
            self.meta.omap_rm_keys(BUCKETS_OID,
                                   [bucket, f"lc.{bucket}",
                                    f"policy.{bucket}"])
        for oid in {*oids, _index_oid(bucket)}:
            for o in (oid, self._bilog_oid(oid)):
                try:
                    self.meta.remove(o)
                except Exception:
                    pass
        return True

    def bucket_exists(self, bucket: str) -> bool:
        try:
            rows = self.meta.omap_get(BUCKETS_OID)
        except ObjectNotFound:
            return False        # nothing registered yet
        return bucket in rows and not bucket.startswith(("lc.", "policy."))

    def list_buckets_for(self, uid: str | None) -> list[str]:
        """Account listing: only the caller's buckets (plus unowned
        pre-auth buckets) — the reference's per-tenant listing; other
        tenants' bucket NAMES must not leak."""
        out = []
        try:
            rows = self.meta.omap_get(BUCKETS_OID)
        except ObjectNotFound:
            return []
        for b, raw in rows.items():
            if b.startswith(("lc.", "policy.")):
                continue
            owner = json.loads(bytes(raw)).get("owner")
            if owner is None or owner == uid:
                out.append(b)
        return sorted(out)

    def list_buckets(self) -> list[str]:
        try:
            return sorted(b for b in self.meta.omap_get(BUCKETS_OID)
                          if not b.startswith(("lc.", "policy.")))
        except ObjectNotFound:
            return []

    # -- lifecycle ---------------------------------------------------------
    # (reference RGWLC: per-bucket rules in a lifecycle omap; a
    # worker pass expires objects whose mtime passed the rule's age)
    def set_lifecycle(self, bucket: str, rules: list[dict]):
        """rules: [{"id", "prefix", "days"}] — expiration only."""
        self.meta.omap_set(BUCKETS_OID, {
            f"lc.{bucket}": json.dumps(rules).encode()})

    def get_lifecycle(self, bucket: str) -> list[dict]:
        try:
            raw = self.meta.omap_get(BUCKETS_OID).get(f"lc.{bucket}")
        except ObjectNotFound:
            return []
        return json.loads(bytes(raw)) if raw else []

    def lifecycle_pass(self, now: float | None = None) -> int:
        """Expire objects per the buckets' rules; → number expired
        (reference RGWLC::process)."""
        import time as _time
        now = _time.time() if now is None else now
        expired = 0
        for bucket in self.list_buckets():
            try:
                rules = self.get_lifecycle(bucket)
                if not rules:
                    continue
                for key, meta in list(
                        self.list_objects(bucket).items()):
                    mtime = float(meta.get("mtime", now))
                    for rule in rules:
                        if not key.startswith(
                                rule.get("prefix", "")):
                            continue
                        age_limit = float(rule["days"]) * 86400.0
                        if now - mtime < age_limit:
                            continue
                        if self._expire_if_unchanged(bucket, key,
                                                     mtime):
                            expired += 1
                        break
            except Exception:   # noqa: BLE001 — one poisoned bucket
                continue        # must not stop the whole pass
        return expired

    def _expire_if_unchanged(self, bucket: str, key: str,
                             mtime: float) -> bool:
        """Expire `key` only if its mtime still equals the snapshot
        the lifecycle scan saw — re-check AND removal in ONE critical
        section, so a racing PUT (which takes the same lock) can never
        have its brand-new object expired out from under it."""
        with self._shard_lock(bucket, key):
            cur = self._index_get(bucket, key)
            if cur is None or cur.get("delete_marker") or \
                    float(cur.get("mtime", -1.0)) != mtime:
                return False
            if self.versioning_enabled(bucket):
                # expiration writes a delete marker; older versions
                # stay readable via ?versionId=
                self._write_delete_marker_locked(bucket, key)
            else:
                self._remove_current_locked(bucket, key, cur)
        return True

    # -- versioning --------------------------------------------------------
    def set_versioning(self, bucket: str, enabled: bool):
        # merge into the existing meta row: overwriting would drop
        # num_shards and silently re-route the index to the legacy oid
        try:
            raw = self.meta.omap_get(BUCKETS_OID,
                                     keys=[bucket]).get(bucket)
        except ObjectNotFound:
            raw = None
        row = json.loads(bytes(raw)) if raw else {"name": bucket}
        row["versioning"] = enabled
        self.meta.omap_set(BUCKETS_OID, {
            bucket: json.dumps(row).encode()})

    def versioning_enabled(self, bucket: str) -> bool:
        try:
            row = self.meta.omap_get(BUCKETS_OID,
                                     keys=[bucket]).get(bucket)
        except ObjectNotFound:
            return False
        return bool(row and json.loads(bytes(row)).get("versioning"))

    def _next_version_id(self, bucket: str) -> str:
        try:
            rows = self.meta.omap_get(_versions_oid(bucket))
        except ObjectNotFound:
            rows = {}
        seq = int(rows.get("_seq", b"0")) + 1
        self.meta.omap_set(_versions_oid(bucket), {
            "_seq": str(seq).encode()})
        return f"{seq:08d}"

    def list_versions(self, bucket: str) -> list[dict]:
        """All versions (newest first per key), delete markers
        included (reference ListObjectVersions)."""
        try:
            rows = self.meta.omap_get(_versions_oid(bucket))
        except ObjectNotFound:
            return []
        out = []
        for k, v in rows.items():
            if k == "_seq":
                continue
            key, _, vid = k.rpartition("\x00")
            out.append({"key": key, "version_id": vid,
                        **json.loads(bytes(v))})
        cur = self._raw_index(bucket)
        for e in out:
            m = cur.get(e["key"])
            e["is_latest"] = bool(
                m and m.get("version_id") == e["version_id"])
        return sorted(out, key=lambda e: (e["key"],
                                          e["version_id"]),
                      reverse=True)

    # -- objects -----------------------------------------------------------
    def put_object(self, bucket: str, key: str, body: bytes) -> tuple:
        """→ (etag, version_id|None)."""
        import time as _time
        etag = hashlib.md5(body).hexdigest()
        meta = {"size": len(body), "etag": etag,
                "mtime": _time.time()}
        vid = None
        oid, lk = self._key_index_ref(bucket, key)
        with lk:
            old = self._index_get_at(oid, key)
            if self.versioning_enabled(bucket):
                with self._ver_lock(bucket):
                    vid = self._next_version_id(bucket)
                    meta["version_id"] = vid
                    self.data.write_full(
                        _version_oid(bucket, key, vid), body)
                    self.meta.omap_set(_versions_oid(bucket), {
                        f"{key}\x00{vid}":
                            json.dumps(meta).encode()})
                old = None   # prior version still references its parts
            else:
                self.data.write_full(_data_oid(bucket, key), body)
            self._index_set_at(oid, key, meta)
        self._drop_parts(old)   # replaced unversioned manifest
        return etag, vid

    def _read_payload(self, bucket: str, key: str,
                      meta: dict) -> bytes:
        if "parts" in meta:
            # multipart manifest: concatenate part objects
            return b"".join(
                bytes(self.data.read(p)) for p in meta["parts"])
        if meta.get("version_id"):
            return bytes(self.data.read(
                _version_oid(bucket, key, meta["version_id"])))
        return bytes(self.data.read(_data_oid(bucket, key)))

    def get_object(self, bucket: str, key: str,
                   version_id: str | None = None) -> tuple[bytes, dict]:
        meta = self.head_object(bucket, key, version_id)
        return self._read_payload(bucket, key, meta), meta

    def head_object(self, bucket: str, key: str,
                    version_id: str | None = None) -> dict:
        if version_id is not None:
            try:
                rows = self.meta.omap_get(_versions_oid(bucket))
            except ObjectNotFound:
                raise KeyError(key) from None
            row = rows.get(f"{key}\x00{version_id}")
            if row is None:
                raise KeyError(key)
            meta = json.loads(bytes(row))
            if meta.get("delete_marker"):
                raise KeyError(key)
            return meta
        meta = self._index_get(bucket, key)
        if meta is None:
            raise KeyError(key)
        if meta.get("delete_marker"):
            raise KeyError(key)   # current version is a delete marker
        return meta

    def delete_object(self, bucket: str, key: str,
                      version_id: str | None = None):
        if version_id is not None:
            # permanent removal of one version (reference: deleting a
            # specific versionId bypasses the delete-marker machinery)
            with self._shard_lock(bucket, key), self._ver_lock(bucket):
                try:
                    rows = self.meta.omap_get(_versions_oid(bucket))
                    vmeta = json.loads(bytes(
                        rows[f"{key}\x00{version_id}"]))
                except (ObjectNotFound, KeyError):
                    vmeta = {}
                self.meta.omap_rm_keys(_versions_oid(bucket),
                                       [f"{key}\x00{version_id}"])
                try:
                    self.data.remove(
                        _version_oid(bucket, key, version_id))
                except Exception:
                    pass
                self._drop_parts(vmeta)   # multipart version: parts go
                # if it was the current version, expose the newest
                # survivor
                cur = self._index_get(bucket, key)
                if cur and cur.get("version_id") == version_id:
                    survivors = [e for e in self.list_versions(bucket)
                                 if e["key"] == key]
                    if survivors:
                        newest = survivors[0]
                        self._index_set(bucket, key, {
                            k2: v2 for k2, v2 in newest.items()
                            if k2 not in ("key", "is_latest")})
                    else:
                        self._index_rm(bucket, key)
            return None
        if self.versioning_enabled(bucket):
            # delete marker becomes the current version; older
            # versions stay readable via ?versionId=
            with self._shard_lock(bucket, key):
                vid = self._write_delete_marker_locked(bucket, key)
            return vid
        with self._shard_lock(bucket, key):
            try:
                meta = self.head_object(bucket, key)
            except KeyError:
                meta = {}
            self._remove_current_locked(bucket, key, meta)
        return None

    def _write_delete_marker_locked(self, bucket: str,
                                    key: str) -> str:
        """Caller holds the key's shard lock."""
        with self._ver_lock(bucket):
            vid = self._next_version_id(bucket)
            marker = {"size": 0, "etag": "", "version_id": vid,
                      "delete_marker": True}
            self.meta.omap_set(_versions_oid(bucket), {
                f"{key}\x00{vid}": json.dumps(marker).encode()})
        self._index_set(bucket, key, marker)
        return vid

    def _remove_current_locked(self, bucket: str, key: str,
                               meta: dict):
        """Remove the current unversioned object — index row,
        manifest parts, data — with the caller holding the key's
        shard lock through ALL of it: a racing PUT (same lock) can
        otherwise re-create the data object between our index removal
        and data removal and have its fresh bytes deleted under a
        live index row."""
        self._index_rm(bucket, key)
        self._drop_parts(meta)
        try:
            self.data.remove(_data_oid(bucket, key))
        except Exception:   # noqa: BLE001 — data oid may be absent
            pass

    # -- multipart upload --------------------------------------------------
    # (reference rgw_op.cc: RGWInitMultipart / RGWPutObj with
    # uploadId / RGWCompleteMultipart / RGWAbortMultipart; parts are
    # first-class RADOS objects referenced by the completed object's
    # manifest, never copied)
    def initiate_multipart(self, bucket: str, key: str) -> str:
        import uuid
        upload_id = uuid.uuid4().hex[:16]
        self.meta.omap_set(_mp_oid(bucket, upload_id), {
            "_key": key.encode()})
        return upload_id

    def _part_row_oids(self, bucket: str, upload_id: str, k: str,
                       row: bytes | dict | None) -> list[str]:
        """Every data oid a part row references (striped or not)."""
        if row is None:
            return []
        meta = (row if isinstance(row, dict)
                else json.loads(bytes(row)))
        return (meta.get("stripes")
                or [_part_oid(bucket, upload_id, int(k))])

    def put_part(self, bucket: str, upload_id: str, part_num: int,
                 body: bytes) -> str:
        if not 1 <= part_num <= 10000:
            raise ValueError("part number out of range")
        rows = self.meta.omap_get(_mp_oid(bucket, upload_id),
                                  keys=[f"{part_num:05d}"])  # raises
        old = rows.get(f"{part_num:05d}")
        etag = hashlib.md5(body).hexdigest()
        meta = {"size": len(body), "etag": etag}
        ss = self.stripe_size
        if ss > 0 and len(body) > ss:
            # stripe the part across stripe_size RADOS objects and
            # write them CONCURRENTLY: the aio writes arrive at the
            # OSDs together, so on an EC/compressing data pool they
            # coalesce in the batch engine instead of round-tripping
            # the device once per stripe
            oids = [_stripe_oid(bucket, upload_id, part_num, j)
                    for j in range((len(body) + ss - 1) // ss)]
            comps = [self.data.aio_write_full(o, body[j * ss:
                                                      (j + 1) * ss])
                     for j, o in enumerate(oids)]
            for c in comps:
                if not c.wait_for_complete(30.0):
                    raise TimeoutError("stripe write timed out")
                if c.rc != 0:
                    raise OSError(c.rc, "stripe write failed")
            meta["stripes"] = oids
            new_oids = set(oids)
        else:
            self.data.write_full(
                _part_oid(bucket, upload_id, part_num), body)
            new_oids = {_part_oid(bucket, upload_id, part_num)}
        # a re-uploaded part may shrink (fewer stripes) or switch
        # layout: remove the previous upload's now-orphaned oids
        for o in self._part_row_oids(bucket, upload_id,
                                     f"{part_num:05d}", old):
            if o not in new_oids:
                try:
                    self.data.remove(o)
                except Exception:
                    pass
        self.meta.omap_set(_mp_oid(bucket, upload_id), {
            f"{part_num:05d}": json.dumps(meta).encode()})
        return etag

    def list_parts(self, bucket: str, upload_id: str) -> list[dict]:
        rows = self.meta.omap_get(_mp_oid(bucket, upload_id))
        return [{"part": int(k), **json.loads(bytes(v))}
                for k, v in sorted(rows.items()) if k != "_key"]

    def complete_multipart(self, bucket: str, upload_id: str) -> str:
        rows = self.meta.omap_get(_mp_oid(bucket, upload_id))
        key = bytes(rows.pop("_key")).decode()
        parts = sorted((int(k), json.loads(bytes(v)))
                       for k, v in rows.items())
        if not parts:
            raise ValueError("no parts uploaded")
        # S3 multipart etag: md5 over the concatenated part digests,
        # suffixed with the part count
        digest = hashlib.md5(b"".join(
            bytes.fromhex(m["etag"]) for _, m in parts)).hexdigest()
        etag = f"{digest}-{len(parts)}"
        import time as _time
        manifest = {
            "size": sum(m["size"] for _, m in parts),
            "etag": etag,
            "mtime": _time.time(),
            # striped parts flatten into the manifest in stripe order
            # — GET/_drop_parts walk one flat oid list either way
            "parts": [o for n, m in parts
                      for o in (m.get("stripes")
                                or [_part_oid(bucket, upload_id, n)])],
        }
        oid, lk = self._key_index_ref(bucket, key)
        with lk:
            old = self._index_get_at(oid, key)
            if self.versioning_enabled(bucket):
                with self._ver_lock(bucket):
                    vid = self._next_version_id(bucket)
                    manifest["version_id"] = vid
                    self.meta.omap_set(_versions_oid(bucket), {
                        f"{key}\x00{vid}":
                            json.dumps(manifest).encode()})
                old = None   # prior version keeps its parts
            self._index_set_at(oid, key, manifest)
            self.meta.remove(_mp_oid(bucket, upload_id))
        self._drop_parts(old)
        return etag

    def abort_multipart(self, bucket: str, upload_id: str):
        try:
            rows = self.meta.omap_get(_mp_oid(bucket, upload_id))
        except ObjectNotFound:
            return
        for k, v in rows.items():
            if k == "_key":
                continue
            for o in self._part_row_oids(bucket, upload_id, k, v):
                try:
                    self.data.remove(o)
                except Exception:
                    pass
        self.meta.remove(_mp_oid(bucket, upload_id))

    def list_multipart_uploads(self, bucket: str) -> list[dict]:
        out = []
        pre = f"multipart.{bucket}\x00"
        for o in self.meta.list_objects():
            if o.startswith(pre):
                try:
                    key = bytes(self.meta.omap_get(o)["_key"]).decode()
                except (ObjectNotFound, KeyError):
                    continue
                out.append({"upload_id": o[len(pre):], "key": key})
        return sorted(out, key=lambda u: u["upload_id"])

    def _raw_index(self, bucket: str) -> dict[str, dict]:
        """Merged view of every index shard (listings; reference
        cls_rgw list merges shard results the same way)."""
        out: dict[str, dict] = {}
        for oid in self._all_index_oids(bucket):
            try:
                idx = self.meta.omap_get(oid)
            except ObjectNotFound:
                continue
            for k, v in idx.items():
                out[k] = json.loads(bytes(v))
        return out

    def list_objects(self, bucket: str) -> dict[str, dict]:
        """Visible objects only: keys whose current version is a
        delete marker are absent (S3 listings hide them; they'd also
        wedge delete_bucket's emptiness check forever)."""
        return {k: m for k, m in self._raw_index(bucket).items()
                if not m.get("delete_marker")}


def _xml_list_bucket(bucket: str, objs: dict[str, dict]) -> bytes:
    rows = "".join(
        f"<Contents><Key>{_xesc(k)}</Key><Size>{m['size']}</Size>"
        f"<ETag>&quot;{m['etag']}&quot;</ETag></Contents>"
        for k, m in sorted(objs.items()))
    return (f'<?xml version="1.0"?><ListBucketResult>'
            f"<Name>{_xesc(bucket)}</Name>{rows}</ListBucketResult>"
            ).encode()


def _xml_list_versions(bucket: str, versions: list[dict]) -> bytes:
    rows = []
    for e in versions:
        tag = ("DeleteMarker" if e.get("delete_marker")
               else "Version")
        rows.append(
            f"<{tag}><Key>{_xesc(e['key'])}</Key>"
            f"<VersionId>{e['version_id']}</VersionId>"
            f"<IsLatest>{str(e['is_latest']).lower()}</IsLatest>"
            f"<Size>{e.get('size', 0)}</Size></{tag}>")
    return (f'<?xml version="1.0"?><ListVersionsResult>'
            f"<Name>{_xesc(bucket)}</Name>{''.join(rows)}"
            f"</ListVersionsResult>").encode()


def _xml_list_buckets(names: list[str]) -> bytes:
    rows = "".join(f"<Bucket><Name>{_xesc(n)}</Name></Bucket>"
                   for n in names)
    return (f'<?xml version="1.0"?><ListAllMyBucketsResult>'
            f"<Buckets>{rows}</Buckets></ListAllMyBucketsResult>"
            ).encode()


class _Handler(BaseHTTPRequestHandler):
    store: RGWStore = None      # set by RGWService
    require_auth = False        # set by RGWService(require_auth=True)
    allow_unsigned_payload = False   # opt-in; see sigv4.verify
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):   # quiet
        pass

    @staticmethod
    def _action_of(method: str, key: str | None,
                   query: dict | None = None) -> str:
        if not key and query is not None and "policy" in query:
            # the ?policy subresource has dedicated IAM actions —
            # authorizing it as List/Create/DeleteBucket let any
            # s3:ListBucket grantee read the principal list
            return {"GET": "s3:GetBucketPolicy",
                    "PUT": "s3:PutBucketPolicy",
                    "DELETE": "s3:DeleteBucketPolicy"}.get(
                        method, "s3:Unknown")
        if key:
            return {"GET": "s3:GetObject", "HEAD": "s3:GetObject",
                    "PUT": "s3:PutObject", "POST": "s3:PutObject",
                    "DELETE": "s3:DeleteObject"}.get(method,
                                                     "s3:Unknown")
        return {"GET": "s3:ListBucket", "HEAD": "s3:ListBucket",
                "PUT": "s3:CreateBucket", "POST": "s3:PutObject",
                "DELETE": "s3:DeleteBucket"}.get(method,
                                                 "s3:Unknown")

    def _deny(self, msg: str) -> bool:
        self._reply(403, f"<Error><Code>AccessDenied</Code>"
                         f"<Message>{_xesc(msg)}</Message>"
                         f"</Error>".encode())
        return False

    def _tag_tenant(self, uid: str | None):
        """Stamp this worker thread's RADOS ops with the caller's
        tenant: the tag rides every MOSDOp as ``qos_client`` and keys
        the OSDs' mClock per-client streams, so QoS isolation follows
        the TENANT (all its connections together), not the gateway's
        shared client entity.  Unauthenticated deployments can tag
        via the ``x-rgw-tenant`` header (test/bench hook)."""
        tag = uid or self.headers.get("x-rgw-tenant")
        if tag:
            try:
                self.store.rados.set_qos_tag(f"rgw:{tag}")
            except Exception:   # noqa: BLE001 — QoS tagging is
                pass            # advisory, never fails a request

    def _check_auth(self, body: bytes) -> bool:
        ok = self._check_auth_inner(body)
        if ok:
            self._tag_tenant(getattr(self, "_auth_uid", None))
        return ok

    def _check_auth_inner(self, body: bytes) -> bool:
        """Auth + authorization gate (reference rgw_auth_s3.cc +
        rgw_iam_policy): a signed request resolves to its user; an
        UNSIGNED request proceeds as anonymous and may only do what a
        bucket policy explicitly grants.  A present-but-invalid
        signature is always 403.  → True when the request may
        proceed; self._auth_uid carries the caller identity."""
        self._auth_uid = None
        self._auth_temp = False
        if not self.require_auth:
            return True
        from . import sigv4
        path = self.path.split("?", 1)[0]
        hdrs = dict(self.headers.items())
        has_authz = any(k.lower() == "authorization" for k in hdrs)
        if has_authz:
            resolved: dict = {}

            def lookup(ak: str):
                found = self.store.resolve_access_key(ak)
                if found is not None:
                    resolved[ak] = found
                    return found[1]
                return None

            try:
                ak = sigv4.verify(
                    self.command, path, self._query(), hdrs, body,
                    lookup,
                    allow_unsigned_payload=self.allow_unsigned_payload)
            except sigv4.SigError as e:
                return self._deny(str(e))
            self._auth_uid = resolved[ak][0]
            self._auth_temp = resolved[ak][2]
        bucket, key = self._parse()
        if bucket is None:
            # account-level ops (list buckets, STS) need identity
            if self._auth_uid is None:
                return self._deny("authentication required")
            return True
        action = self._action_of(self.command, key, self._query())
        if not self.store.authorize(self._auth_uid, action, bucket,
                                    key or ""):
            return self._deny(
                f"{action} on {bucket!r} denied for "
                f"{self._auth_uid or 'anonymous'}")
        return True

    def _reply(self, code: int, body: bytes = b"",
               ctype: str = "application/xml", headers: dict = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        # HEAD responses are bodyless by spec: writing the error XML
        # would desync the next response on a keep-alive connection
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _parse(self):
        path = self.path.split("?", 1)[0].strip("/")
        if not path:
            return None, None
        parts = path.split("/", 1)
        return parts[0], parts[1] if len(parts) > 1 else None

    def _query(self) -> dict:
        if "?" not in self.path:
            return {}
        from urllib.parse import parse_qs
        q = parse_qs(self.path.split("?", 1)[1],
                     keep_blank_values=True)
        return {k: v[0] for k, v in q.items()}

    def handle_one_request(self):
        try:
            super().handle_one_request()
        except (TimeoutError, ConnectionError, OSError):
            # cluster outage mid-op: drop the connection rather than
            # fabricate 404s (clients retry)
            self.close_connection = True

    # -- Swift frontend (reference rgw_rest_swift.cc + tempauth) -----------
    # /auth/v1.0 issues an X-Auth-Token against the SAME user table
    # the S3 side uses; /swift/v1[/container[/object]] maps onto the
    # same buckets/objects, so both dialects see one namespace.
    def _swift_route(self) -> bool:
        """→ True when this request was a Swift/auth request and has
        been fully handled."""
        path = self.path.split("?", 1)[0]
        if path == "/auth/v1.0" and "X-Auth-User" in self.headers:
            # tempauth clients always send X-Auth-User; without it
            # this is an S3 op on an object literally named v1.0 in a
            # bucket named auth — let it through
            self._swift_auth()
            return True
        if path == "/swift/v1" or path.startswith("/swift/v1/"):
            self._swift_op(path[len("/swift/v1"):].strip("/"))
            return True
        return False

    def _swift_auth(self):
        uid = self.headers.get("X-Auth-User", "")
        key = self.headers.get("X-Auth-Key", "")
        user = self.store.get_user(uid)
        if user is None or user["secret_key"] != key:
            return self._reply(401)
        token = self.store.swift_issue_token(uid)
        host = self.headers.get("Host", "")
        return self._reply(200, headers={
            "X-Auth-Token": token,
            "X-Storage-Url": f"http://{host}/swift/v1"})

    def _swift_identity(self) -> tuple[bool, str | None]:
        """→ (authorized-to-proceed, uid)."""
        if not self.require_auth:
            return True, None
        token = self.headers.get("X-Auth-Token", "")
        uid = self.store.swift_token_uid(token) if token else None
        return uid is not None or not token, uid

    def _swift_op(self, rest: str):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ok, uid = self._swift_identity()
        if not ok:
            return self._reply(401)
        self._tag_tenant(uid)
        parts = rest.split("/", 1) if rest else []
        container = parts[0] if parts else None
        obj = parts[1] if len(parts) > 1 else None
        method = self.command
        if self.require_auth and container is not None:
            action = self._action_of(method, obj)
            if not self.store.authorize(uid, action, container,
                                        obj or ""):
                return self._reply(403)
        if container is None:
            if uid is None and self.require_auth:
                # account-level ops (incl. the bucket listing) need a
                # token — same bar as the S3 side's 403
                return self._reply(401)
            if method == "GET":
                names = "\n".join(
                    self.store.list_buckets_for(uid)
                    if self.require_auth
                    else self.store.list_buckets())
                return self._reply(200, (names + "\n").encode()
                                   if names else b"",
                                   ctype="text/plain")
            return self._reply(400)
        if obj is None:
            if method == "PUT":
                if not self.store.create_bucket(container,
                                                owner=uid):
                    return self._reply(400)
                return self._reply(201)
            if method == "GET":
                if not self.store.bucket_exists(container):
                    return self._reply(404)
                names = "\n".join(sorted(
                    self.store.list_objects(container)))
                return self._reply(200, (names + "\n").encode()
                                   if names else b"",
                                   ctype="text/plain")
            if method == "HEAD":
                return self._reply(
                    204 if self.store.bucket_exists(container)
                    else 404)
            if method == "DELETE":
                if not self.store.bucket_exists(container):
                    return self._reply(404)
                return self._reply(
                    204 if self.store.delete_bucket(container)
                    else 409)
            return self._reply(400)
        if method == "PUT":
            if not self.store.bucket_exists(container):
                return self._reply(404)
            etag, _vid = self.store.put_object(container, obj, body)
            return self._reply(201, headers={"ETag": etag})
        if method in ("GET", "HEAD"):
            try:
                data, meta = self.store.get_object(container, obj)
            except (KeyError, ObjectNotFound):
                return self._reply(404)
            if method == "HEAD":
                return self._reply(200, headers={
                    "ETag": meta["etag"],
                    "Content-Length": str(meta["size"])})
            return self._reply(200, data,
                               ctype="application/octet-stream")
        if method == "DELETE":
            try:
                self.store.head_object(container, obj)
            except (KeyError, ObjectNotFound):
                return self._reply(404)
            self.store.delete_object(container, obj)
            return self._reply(204)
        return self._reply(400)

    def do_PUT(self):
        if self._swift_route():
            return
        bucket, key = self._parse()
        q = self._query()
        # always drain the request body first: replying while unread
        # bytes sit on a keep-alive connection desyncs the stream
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._check_auth(body):
            return
        if bucket is None:
            return self._reply(400)
        if key is None:
            if "versioning" in q:
                if not self.store.bucket_exists(bucket):
                    return self._reply(404)
                self.store.set_versioning(
                    bucket, b"Enabled" in body)
                return self._reply(200)
            if "policy" in q:
                if not self.store.bucket_exists(bucket):
                    return self._reply(404)
                try:
                    policy = json.loads(body.decode())
                except (ValueError, UnicodeDecodeError):
                    return self._reply(400)
                if not isinstance(policy, dict) or not isinstance(
                        policy.get("Statement", []), list) or not all(
                        isinstance(st, dict)
                        for st in policy.get("Statement", [])):
                    return self._reply(400)
                self.store.set_bucket_policy(bucket, policy)
                return self._reply(204)
            if "lifecycle" in q:
                if not self.store.bucket_exists(bucket):
                    return self._reply(404)
                import xml.etree.ElementTree as ET
                try:
                    root = ET.fromstring(body.decode())
                    rules = []
                    for rule in root.iter("Rule"):
                        days = rule.findtext(".//Days")
                        if days is None:
                            continue
                        rules.append({
                            "id": rule.findtext("ID") or "",
                            "prefix": rule.findtext(".//Prefix")
                            or rule.findtext("Prefix") or "",
                            "days": int(float(days))})
                except ET.ParseError:
                    return self._reply(400)
                self.store.set_lifecycle(bucket, rules)
                return self._reply(200)
            if not self.store.create_bucket(
                    bucket, owner=getattr(self, "_auth_uid", None)):
                return self._reply(400)
            return self._reply(200)
        if not self.store.bucket_exists(bucket):
            return self._reply(404)
        if "partNumber" in q and "uploadId" in q:
            try:
                etag = self.store.put_part(
                    bucket, q["uploadId"], int(q["partNumber"]), body)
            except ObjectNotFound:
                return self._reply(404)
            except ValueError:
                return self._reply(400)
            return self._reply(200, headers={"ETag": f'"{etag}"'})
        etag, vid = self.store.put_object(bucket, key, body)
        hdrs = {"ETag": f'"{etag}"'}
        if vid:
            hdrs["x-amz-version-id"] = vid
        return self._reply(200, headers=hdrs)

    def do_POST(self):
        if self._swift_route():
            return
        bucket, key = self._parse()
        q = self._query()
        if bucket is None and q.get("Action") == "GetSessionToken":
            length = int(self.headers.get("Content-Length", 0))
            sts_body = self.rfile.read(length)
            if not self._check_auth(sts_body):
                return
            if getattr(self, "_auth_temp", False):
                # a leaked session token must not launder itself into
                # rolling credentials (AWS STS refuses this too)
                return self._deny(
                    "GetSessionToken requires permanent credentials")
            import math
            try:
                duration = float(q.get("DurationSeconds", 3600))
            except ValueError:
                return self._reply(400)
            if not math.isfinite(duration) or duration <= 0:
                return self._reply(400)
            creds = self.store.sts_get_session_token(
                self._auth_uid, duration)
            return self._reply(
                200, json.dumps(creds).encode(),
                ctype="application/json")
        length = int(self.headers.get("Content-Length", 0))
        post_body = self.rfile.read(length)  # CompleteMultipartUpload
        # XML: the part list is authoritative server-side (we
        # complete with every uploaded part, in part-number order)
        if not self._check_auth(post_body):
            return
        if bucket is None or key is None:
            return self._reply(400)
        if not self.store.bucket_exists(bucket):
            return self._reply(404)
        if "uploads" in q:
            upload_id = self.store.initiate_multipart(bucket, key)
            xml = (f'<?xml version="1.0"?>'
                   f"<InitiateMultipartUploadResult>"
                   f"<Bucket>{_xesc(bucket)}</Bucket>"
                   f"<Key>{_xesc(key)}</Key>"
                   f"<UploadId>{upload_id}</UploadId>"
                   f"</InitiateMultipartUploadResult>").encode()
            return self._reply(200, xml)
        if "uploadId" in q:
            try:
                etag = self.store.complete_multipart(
                    bucket, q["uploadId"])
            except ObjectNotFound:
                return self._reply(404)
            except ValueError:
                return self._reply(400)
            xml = (f'<?xml version="1.0"?>'
                   f"<CompleteMultipartUploadResult>"
                   f"<ETag>&quot;{etag}&quot;</ETag>"
                   f"</CompleteMultipartUploadResult>").encode()
            return self._reply(200, xml)
        return self._reply(400)

    def do_GET(self):
        if self._swift_route():
            return
        bucket, key = self._parse()
        q = self._query()
        if not self._check_auth(b""):
            return
        if bucket is None:
            names = (self.store.list_buckets_for(self._auth_uid)
                     if self.require_auth
                     else self.store.list_buckets())
            return self._reply(200, _xml_list_buckets(names))
        if key is None:
            if not self.store.bucket_exists(bucket):
                return self._reply(404)
            if "policy" in q:
                policy = self.store.get_bucket_policy(bucket)
                if policy is None:
                    return self._reply(404)
                return self._reply(200, json.dumps(policy).encode(),
                                   ctype="application/json")
            if "versions" in q:
                return self._reply(200, _xml_list_versions(
                    bucket, self.store.list_versions(bucket)))
            if "lifecycle" in q:
                rules = self.store.get_lifecycle(bucket)
                rows = "".join(
                    f"<Rule><ID>{_xesc(r.get('id', ''))}</ID>"
                    f"<Prefix>{_xesc(r.get('prefix', ''))}</Prefix>"
                    f"<Expiration><Days>{r['days']}</Days>"
                    f"</Expiration></Rule>" for r in rules)
                return self._reply(200, (
                    '<?xml version="1.0"?>'
                    f"<LifecycleConfiguration>{rows}"
                    "</LifecycleConfiguration>").encode())
            if "uploads" in q:
                ups = self.store.list_multipart_uploads(bucket)
                rows = "".join(
                    f"<Upload><Key>{_xesc(u['key'])}</Key>"
                    f"<UploadId>{u['upload_id']}</UploadId></Upload>"
                    for u in ups)
                return self._reply(200, (
                    f'<?xml version="1.0"?>'
                    f"<ListMultipartUploadsResult>{rows}"
                    f"</ListMultipartUploadsResult>").encode())
            return self._reply(200, _xml_list_bucket(
                bucket, self.store.list_objects(bucket)))
        try:
            body, meta = self.store.get_object(
                bucket, key, q.get("versionId"))
        except KeyError:
            return self._reply(404)
        hdrs = {"ETag": f'"{meta["etag"]}"'}
        if meta.get("version_id"):
            hdrs["x-amz-version-id"] = meta["version_id"]
        return self._reply(200, body,
                           ctype="application/octet-stream",
                           headers=hdrs)

    def do_HEAD(self):
        if self._swift_route():
            return
        bucket, key = self._parse()
        if not self._check_auth(b""):
            return
        if bucket is None or key is None:
            return self._reply(400)
        try:
            meta = self.store.head_object(bucket, key)
        except KeyError:
            return self._reply(404)
        return self._reply(200, headers={
            "ETag": f'"{meta["etag"]}"',
            "X-Object-Size": str(meta["size"])})

    def do_DELETE(self):
        if self._swift_route():
            return
        bucket, key = self._parse()
        q = self._query()
        if not self._check_auth(b""):
            return
        if bucket is None:
            return self._reply(400)
        if key is None:
            if "policy" in q:
                if not self.store.bucket_exists(bucket):
                    return self._reply(404)
                self.store.delete_bucket_policy(bucket)
                return self._reply(204)
            ok = self.store.delete_bucket(bucket)
            return self._reply(204 if ok else 409)
        if "uploadId" in q:
            self.store.abort_multipart(bucket, q["uploadId"])
            return self._reply(204)
        vid = self.store.delete_object(bucket, key,
                                       q.get("versionId"))
        hdrs = {"x-amz-version-id": vid} if vid else None
        return self._reply(204, headers=hdrs)


class _BufferedSocket:
    """Duck-typed socket for replaying ONE parsed request through a
    `BaseHTTPRequestHandler` off-reactor: the already-read request
    bytes come out of `makefile`, the handler's response bytes land
    in `captured` (the stdlib handler writes via ``sendall`` — its
    default wfile is a ``_SocketWriter`` over the connection)."""

    def __init__(self, raw: bytes):
        self._in = io.BytesIO(raw)
        self._out = bytearray()

    def makefile(self, mode="rb", *a, **kw):
        return self._in

    def sendall(self, data):
        self._out += data

    def settimeout(self, t):
        pass

    def setsockopt(self, *a):
        pass

    def shutdown(self, how):
        pass

    def close(self):
        pass

    @property
    def captured(self) -> bytes:
        return bytes(self._out)


def _one_shot(handler_cls):
    """A handler subclass whose `handle` serves exactly ONE request
    (the front door framed it already) instead of the stdlib's
    read-until-EOF loop — which would always force
    ``close_connection`` when the buffered request runs dry and lose
    the real keep-alive decision.  `parse_request` re-derives
    close_connection from the request's own headers/protocol, so the
    post-run flag is the true verdict."""

    class _OneShot(handler_cls):
        def handle(self):
            self.close_connection = True
            try:
                self.handle_one_request()
            finally:
                # worker threads are pooled: never leak one request's
                # tenant QoS tag into the next tenant's ops
                st = getattr(self, "store", None)
                if st is not None:
                    try:
                        st.rados.set_qos_tag(None)
                    except Exception:   # noqa: BLE001
                        pass

    return _OneShot


_RESP_500 = (b"HTTP/1.1 500 Internal Server Error\r\n"
             b"Content-Length: 0\r\nConnection: close\r\n\r\n")


class _AsyncFrontDoor:
    """The concurrent request front end (reference rgw_asio_frontend:
    a reactor accepting/framing requests + a bounded worker pool
    executing them).  One asyncio loop thread parses HTTP framing
    (header block + Content-Length body) per connection; admitted
    requests run on a `pool_size` executor, at most `max_concurrent`
    in flight (executing + queued).  Saturation answers **503
    SlowDown with Retry-After** immediately instead of letting the
    accept queue build invisible latency — bounded admission is what
    keeps an open-loop load test honest.

    Admission is keyed per tenant (the ``x-rgw-tenant`` tag that also
    rides QoS): at the global ceiling only tenants at or above their
    fair share ``max_concurrent // active_tenants`` are 503'd, so one
    tenant's burst cannot starve everyone else's trickle.  An
    under-share tenant may be admitted slightly past the ceiling; the
    overshoot is bounded by the number of active tenants (each can
    exceed its share by at most the one request being admitted)."""

    def __init__(self, handler_cls, host: str = "127.0.0.1",
                 port: int = 0, *, pool_size: int = 16,
                 max_concurrent: int = 64, retry_after: float = 1.0):
        self._oneshot = _one_shot(handler_cls)
        self.pool_size = max(1, int(pool_size))
        self.max_concurrent = int(max_concurrent)   # 0 = unlimited
        self.retry_after = float(retry_after)
        # bind synchronously so the port is known at construction
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(128)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._pool = ThreadPoolExecutor(
            self.pool_size, thread_name_prefix="rgw-http")
        self._inflight = 0          # loop-thread confined
        self._inflight_t: dict[str, int] = {}   # tenant → in flight
        self.stats = {"accepted": 0, "rejected": 0,
                      "rejected_by_tenant": {}}
        self._loop = asyncio.new_event_loop()
        self._tasks: set = set()
        self._stop_ev = None
        self._thread = threading.Thread(
            target=self._run, name="rgw-frontdoor", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        asyncio.set_event_loop(self._loop)
        self._stop_ev = asyncio.Event()
        try:
            self._loop.run_until_complete(self._serve())
        finally:
            self._loop.close()

    async def _serve(self):
        server = await asyncio.start_server(self._client,
                                            sock=self._sock)
        await self._stop_ev.wait()
        server.close()
        await server.wait_closed()
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    def _canned_503(self, head_only: bool) -> bytes:
        body = (b"<Error><Code>SlowDown</Code>"
                b"<Message>request pool saturated</Message></Error>")
        hdr = (f"HTTP/1.1 503 Slow Down\r\n"
               f"Content-Type: application/xml\r\n"
               f"Content-Length: {len(body)}\r\n"
               f"Retry-After: {max(1, math.ceil(self.retry_after))}"
               f"\r\n\r\n").encode()
        return hdr if head_only else hdr + body

    def _reject(self, tenant: str) -> bool:
        """At the global ceiling: 503 only tenants at/over their fair
        share.  An under-share tenant is admitted (bounded overshoot:
        at most one extra request per active tenant) unless the hard
        absolute ceiling ``max_concurrent + active`` is hit."""
        mine = self._inflight_t.get(tenant, 0)
        active = len(self._inflight_t) \
            + (0 if tenant in self._inflight_t else 1)
        share = max(1, self.max_concurrent // active)
        return (mine >= share
                or self._inflight >= self.max_concurrent + active)

    async def _client(self, reader, writer):
        self._tasks.add(asyncio.current_task())
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError, ConnectionError):
                    break
                length = 0
                for line in head.split(b"\r\n")[1:]:
                    if line[:15].lower() == b"content-length:":
                        try:
                            length = int(line.split(b":", 1)[1])
                        except ValueError:
                            length = 0
                try:
                    body = (await reader.readexactly(length)
                            if length > 0 else b"")
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                method = head.split(b" ", 1)[0].upper()
                tenant = ""
                for line in head.split(b"\r\n")[1:]:
                    if line[:13].lower() == b"x-rgw-tenant:":
                        tenant = line.split(b":", 1)[1].strip() \
                            .decode("latin-1")
                if self.max_concurrent \
                        and self._inflight >= self.max_concurrent \
                        and self._reject(tenant):
                    # the body was drained above, so the connection
                    # stays framed — reject THIS request, keep it
                    self.stats["rejected"] += 1
                    per = self.stats["rejected_by_tenant"]
                    per[tenant] = per.get(tenant, 0) + 1
                    writer.write(self._canned_503(method == b"HEAD"))
                    await writer.drain()
                    continue
                self.stats["accepted"] += 1
                self._inflight += 1
                self._inflight_t[tenant] = \
                    self._inflight_t.get(tenant, 0) + 1
                try:
                    resp, close = await self._loop.run_in_executor(
                        self._pool, self._handle, head + body)
                finally:
                    self._inflight -= 1
                    left = self._inflight_t.get(tenant, 1) - 1
                    if left <= 0:
                        self._inflight_t.pop(tenant, None)
                    else:
                        self._inflight_t[tenant] = left
                writer.write(resp)
                await writer.drain()
                if close:
                    break
        except asyncio.CancelledError:
            pass
        finally:
            self._tasks.discard(asyncio.current_task())
            try:
                writer.close()
            except Exception:   # noqa: BLE001
                pass

    def _handle(self, raw: bytes) -> tuple[bytes, bool]:
        sock = _BufferedSocket(raw)
        try:
            h = self._oneshot(sock, ("127.0.0.1", 0), None)
            close = h.close_connection
        except Exception:   # noqa: BLE001 — a handler crash must
            return _RESP_500, True   # not kill the worker
        out = sock.captured
        if not out:
            return _RESP_500, True
        return out, close

    def shutdown(self):
        if self._thread.is_alive() and self._stop_ev is not None:
            self._loop.call_soon_threadsafe(self._stop_ev.set)
            self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)
        try:
            self._sock.close()
        except OSError:
            pass


class RGWService:
    """The gateway daemon: concurrent HTTP frontend bound to a RADOS
    cluster, plus the lifecycle worker (reference RGWLC thread).
    `pool_size`/`max_concurrent`/`retry_after`/`stripe_size` default
    to the rgw_* option-table values (rgw_frontend_threads,
    rgw_max_concurrent_requests, rgw_retry_after,
    rgw_obj_stripe_size)."""

    LC_INTERVAL = 5.0

    def __init__(self, rados, host: str = "127.0.0.1", port: int = 0,
                 require_auth: bool = False,
                 allow_unsigned_payload: bool = False, *,
                 pool_size: int = 16, max_concurrent: int = 64,
                 retry_after: float = 1.0,
                 stripe_size: int = 4 << 20,
                 data_pool_opts: dict | None = None):
        self.store = RGWStore(rados, stripe_size=stripe_size,
                              data_pool_opts=data_pool_opts)
        handler = type("Handler", (_Handler,), {
            "store": self.store, "require_auth": require_auth,
            "allow_unsigned_payload": allow_unsigned_payload})
        self.frontdoor = _AsyncFrontDoor(
            handler, host, port, pool_size=pool_size,
            max_concurrent=max_concurrent, retry_after=retry_after)
        self.port = self.frontdoor.port

    def start(self):
        self.frontdoor.start()
        self._lc_stop = threading.Event()
        self._lc_thread = threading.Thread(
            target=self._lc_loop, name="rgw-lc", daemon=True)
        self._lc_thread.start()
        return self

    def _lc_loop(self):
        while not self._lc_stop.wait(self.LC_INTERVAL):
            try:
                self.store.lifecycle_pass()
            except Exception:   # noqa: BLE001 — cluster churn; the
                pass            # next pass retries

    def shutdown(self):
        if getattr(self, "_lc_stop", None) is not None:
            self._lc_stop.set()
        self.frontdoor.shutdown()


class S3Client:
    """Tiny S3-dialect client for tests/tools.  With credentials it
    SigV4-signs every request (reference: any AWS SDK client).

    Connections are **keep-alive, one per calling thread**: the old
    fresh-connection-per-request client serialized on the TCP
    handshake and hid the concurrent server's framing behavior.  A
    request that fails on a previously-used connection (the server
    closed an idle keep-alive) retries ONCE on a fresh one; a failure
    on a fresh connection propagates."""

    def __init__(self, host: str, port: int,
                 access_key: str | None = None,
                 secret_key: str | None = None,
                 tenant: str | None = None):
        self.host, self.port = host, port
        self.access_key, self.secret_key = access_key, secret_key
        self.tenant = tenant        # rides x-rgw-tenant (QoS tag)
        self._local = threading.local()

    def _conn(self) -> tuple[http.client.HTTPConnection, bool]:
        """→ (connection, is_reused)."""
        con = getattr(self._local, "con", None)
        if con is not None:
            return con, True
        con = http.client.HTTPConnection(self.host, self.port,
                                         timeout=10)
        self._local.con = con
        return con, False

    def _drop_conn(self, con):
        try:
            con.close()
        except Exception:   # noqa: BLE001
            pass
        self._local.con = None

    def close(self):
        """Close THIS thread's cached connection (pooled threads
        outliving the gateway should drop theirs)."""
        con = getattr(self._local, "con", None)
        if con is not None:
            self._drop_conn(con)

    def _req(self, method: str, path: str, body: bytes = b""):
        headers = {}
        if self.tenant:
            headers["x-rgw-tenant"] = self.tenant
        if self.access_key and self.secret_key:
            from . import sigv4
            from urllib.parse import parse_qs
            raw_path, _, qs = path.partition("?")
            query = {k: v[0] for k, v in
                     parse_qs(qs, keep_blank_values=True).items()}
            headers["Host"] = f"{self.host}:{self.port}"
            headers.update(sigv4.sign(
                method, raw_path, query, headers, body,
                self.access_key, self.secret_key))
        while True:
            con, reused = self._conn()
            try:
                con.request(method, path, body=body or None,
                            headers=headers)
                resp = con.getresponse()
                out = (resp.status, dict(resp.getheaders()),
                       resp.read())
            except (http.client.HTTPException, ConnectionError,
                    TimeoutError, OSError):
                self._drop_conn(con)
                if not reused:
                    raise
                continue    # stale keep-alive: retry once, fresh
            if resp.will_close:
                self._drop_conn(con)
            return out

    def make_bucket(self, b):
        return self._req("PUT", f"/{b}")[0]

    def put(self, b, k, data: bytes):
        st, hdr, _ = self._req("PUT", f"/{b}/{k}", data)
        return st, hdr.get("ETag", "").strip('"')

    def get(self, b, k, version_id=None):
        path = f"/{b}/{k}"
        if version_id:
            path += f"?versionId={version_id}"
        st, hdr, body = self._req("GET", path)
        return st, body

    def head(self, b, k):
        return self._req("HEAD", f"/{b}/{k}")[0]

    def delete(self, b, k=None, version_id=None):
        path = f"/{b}/{k}" if k else f"/{b}"
        if version_id:
            path += f"?versionId={version_id}"
        st, hdr, _ = self._req("DELETE", path)
        return st

    def list(self, b=None):
        return self._req("GET", f"/{b}" if b else "/")

    # -- versioning --------------------------------------------------------
    def set_versioning(self, b, enabled=True):
        body = (b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>" if enabled else
                b"<VersioningConfiguration><Status>Suspended</Status>"
                b"</VersioningConfiguration>")
        return self._req("PUT", f"/{b}?versioning", body)[0]

    def put_versioned(self, b, k, data: bytes):
        st, hdr, _ = self._req("PUT", f"/{b}/{k}", data)
        return st, hdr.get("x-amz-version-id")

    def list_versions(self, b):
        return self._req("GET", f"/{b}?versions")

    def put_lifecycle(self, b, rules):
        rows = "".join(
            f"<Rule><ID>{r.get('id', '')}</ID>"
            f"<Prefix>{r.get('prefix', '')}</Prefix>"
            f"<Expiration><Days>{r['days']}</Days></Expiration>"
            f"</Rule>" for r in rules)
        body = (f"<LifecycleConfiguration>{rows}"
                f"</LifecycleConfiguration>").encode()
        return self._req("PUT", f"/{b}?lifecycle", body)[0]

    def get_lifecycle(self, b):
        return self._req("GET", f"/{b}?lifecycle")

    # -- multipart ---------------------------------------------------------
    def initiate_multipart(self, b, k):
        st, _hdr, body = self._req("POST", f"/{b}/{k}?uploads")
        if st != 200:
            return st, None
        uid = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0]
        return st, uid.decode()

    def put_part(self, b, k, upload_id, n, data: bytes):
        st, hdr, _ = self._req(
            "PUT", f"/{b}/{k}?partNumber={n}&uploadId={upload_id}",
            data)
        return st, hdr.get("ETag", "").strip('"')

    def complete_multipart(self, b, k, upload_id):
        st, _hdr, body = self._req(
            "POST", f"/{b}/{k}?uploadId={upload_id}")
        if st != 200:
            return st, None
        etag = body.split(b"&quot;")[1].decode()
        return st, etag

    def abort_multipart(self, b, k, upload_id):
        return self._req(
            "DELETE", f"/{b}/{k}?uploadId={upload_id}")[0]

    def list_uploads(self, b):
        return self._req("GET", f"/{b}?uploads")
