"""radosgw-admin — offline/administrative ops on the RGW store.

The port's copy of ``ceph_tpu.tools.radosgw_admin``; run it as
``python -m ceph_tpu_torch.tools.radosgw_admin``.

Reference behavior re-created (``src/rgw/rgw_admin.cc``; SURVEY.md
§3.9/§3.10), reduced to the authless gateway's surface: bucket
inventory and surgery straight against the ``.rgw.*`` pools, no
gateway process required (exactly how the reference tool talks to
RADOS directly).

    radosgw-admin -m HOST:PORT[,...] bucket list
    radosgw-admin ... bucket stats --bucket NAME
    radosgw-admin ... bucket rm --bucket NAME [--purge-objects]
    radosgw-admin ... object rm --bucket NAME --object KEY
    radosgw-admin ... user create --uid UID [--display-name NAME]
    radosgw-admin ... user list
    radosgw-admin ... user info --uid UID
    radosgw-admin ... user rm --uid UID
"""

from __future__ import annotations

import argparse
import json
import sys

from ..osdc.librados import Rados
from ..rgw.gateway import RGWStore
from .rados import _monmap_from_addrs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="radosgw-admin",
                                description=__doc__)
    p.add_argument("-m", "--mon", required=True)
    p.add_argument("target", choices=["bucket", "object", "user"])
    p.add_argument("op", choices=["list", "stats", "rm", "create",
                                  "info"])
    p.add_argument("--bucket")
    p.add_argument("--object")
    p.add_argument("--uid")
    p.add_argument("--display-name", default="")
    p.add_argument("--purge-objects", action="store_true")
    a = p.parse_args(argv)

    r = Rados(_monmap_from_addrs(a.mon)).connect()
    try:
        store = RGWStore(r)
        if a.target == "bucket" and a.op == "list":
            print(json.dumps(store.list_buckets(), indent=2))
            return 0
        if a.target == "bucket" and a.op == "stats":
            if not a.bucket:
                raise SystemExit("--bucket required")
            if not store.bucket_exists(a.bucket):
                print(f"no such bucket {a.bucket!r}",
                      file=sys.stderr)
                return 2
            objs = store.list_objects(a.bucket)
            print(json.dumps({
                "bucket": a.bucket,
                "usage": {
                    "num_objects": len(objs),
                    "size": sum(m.get("size", 0)
                                for m in objs.values()),
                },
                "versioning": store.versioning_enabled(a.bucket),
            }, indent=2))
            return 0
        if a.target == "bucket" and a.op == "rm":
            if not a.bucket:
                raise SystemExit("--bucket required")
            if a.purge_objects:
                for key in list(store.list_objects(a.bucket)):
                    store.delete_object(a.bucket, key)
                # purge surviving old versions + markers too
                for e in store.list_versions(a.bucket):
                    store.delete_object(a.bucket, e["key"],
                                        e["version_id"])
            if not store.delete_bucket(a.bucket):
                print("bucket not empty (use --purge-objects)",
                      file=sys.stderr)
                return 2
            return 0
        if a.target == "user":
            # reference RGWUserAdminOp: users + their S3 keypairs
            if a.op == "create":
                if not a.uid:
                    raise SystemExit("--uid required")
                print(json.dumps(store.create_user(
                    a.uid, a.display_name), indent=2))
                return 0
            if a.op == "list":
                print(json.dumps(
                    [u["uid"] for u in store.list_users()], indent=2))
                return 0
            if a.op == "info":
                if not a.uid:
                    raise SystemExit("--uid required")
                user = store.get_user(a.uid)
                if user is None:
                    print(f"no such user {a.uid!r}", file=sys.stderr)
                    return 2
                print(json.dumps(user, indent=2))
                return 0
            if a.op == "rm":
                if not a.uid:
                    raise SystemExit("--uid required")
                return 0 if store.remove_user(a.uid) else 2
        if a.target == "object" and a.op == "rm":
            if not (a.bucket and a.object):
                raise SystemExit("--bucket and --object required")
            store.delete_object(a.bucket, a.object)
            return 0
        raise SystemExit(f"unsupported: {a.target} {a.op}")
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main())
