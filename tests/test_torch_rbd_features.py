"""The port's RBD object map, encryption and migration against
ceph_tpu's, on the CPU.

The pair of clusters of ``test_torch_rbd.py`` (one of each package:
one mon, three OSDs, the EC pool ``ecrbd`` k=2 m=1 on rule 1 with
min_size 2 and the replicated pool ``rbd``), started for this module,
with the same seeded ``os.urandom`` and ``uuid.uuid4``.  Each scenario
is one script fed to both packages: the object map's states through
writes, snapshots, discards and removal; fast-diff (an incremental that
reads only the changed object, a full export from the map, a discard
and a dirty union across snapshots, a flattened clone, a removed middle
snapshot, a failed remove); at-rest encryption (ciphertext at rest,
the passphrase checks, removal without it, read-modify-write, snapshots
and diffs, the format guards); live migration both ways between the
pools (prepare, execute, commit, abort, discard on the target).  The
test compares every return value and each exception's type and message
(the data reads of fast-diff counted), then every OSD's store of both
pools, and the script asserts its own answers in both packages.

Tolerance: exact.  The tests of the module run in file order on one
pair of clusters.
"""

import pytest

from test_torch_rbd import OBJ, ORDER, started_pair, store_views


@pytest.fixture(scope="module")
def pair():
    yield from started_pair(17)


class ReadCounter:
    """An ioctx that counts the reads of one image's data objects."""

    def __init__(self, ioctx, image_name):
        self._io = ioctx
        self._prefix = f"rbd_data.{image_name}."
        self.data_reads = 0

    def __getattr__(self, name):
        return getattr(self._io, name)

    def read(self, oid, *a, **kw):
        if oid.startswith(self._prefix):
            self.data_reads += 1
        return self._io.read(oid, *a, **kw)


def sc_object_map_states(s, p):
    io, rbd = s.ios[p], s.RBD()
    om = s.image_mod
    s.call(rbd.create, io, "om", 8 * OBJ, order=ORDER)
    with s.Image(io, "om") as im:
        assert s.call(im._objmap_enabled)
        s.call(im.write, 0, b"a" * 100)
        s.call(im.write, 3 * OBJ, b"b" * 100)
        m = s.note(bytes(im._objmap_load()))
        assert m[0] == m[3] == om.OM_DIRTY and m[1] == m[7] == om.OM_NONE
        s.call(im.create_snap, "s1")
        m = s.note(bytes(im._objmap_load()))
        assert m[0] == m[3] == om.OM_CLEAN
        frozen = s.note(bytes(im._objmap_load(im._hdr["snaps"]["s1"]["id"])))
        assert frozen[0] == frozen[3] == om.OM_DIRTY
        s.call(im.write, 5 * OBJ, b"c")
        m = s.note(bytes(im._objmap_load()))
        assert m[5] == om.OM_DIRTY and m[0] == om.OM_CLEAN
    s.call(rbd.create, io, "omd", 4 * OBJ, order=ORDER)
    with s.Image(io, "omd") as im:
        s.call(im.write, 0, b"x" * OBJ)
        s.call(im.discard, 0, OBJ)                   # whole object
        assert s.note(bytes(im._objmap_load()))[0] == om.OM_NONE
    s.call(rbd.create, io, "omr", 2 * OBJ, order=ORDER)
    with s.Image(io, "omr") as im:
        s.call(im.write, 0, b"z")
        s.call(im.create_snap, "s")
    assert om._objmap_oid("omr") in io.list_objects()
    s.call(rbd.remove, io, "omr")
    left = [o for o in io.list_objects()
            if o.startswith("rbd_object_map.omr")]
    assert s.note(left) == []
    s.call(rbd.create, io, "noom", 4 * OBJ, order=ORDER, object_map=False)
    with s.Image(io, "noom") as im:
        assert not s.call(im._objmap_enabled)
        s.call(im.write, 0, b"plain")
        assert s.call(im.export_diff)["extents"][0]["off"] == 0


def sc_fast_diff(s, p):
    io, rbd = s.ios[p], s.RBD()
    nobj = 16
    s.call(rbd.create, io, "fd", nobj * OBJ, order=ORDER)
    with s.Image(io, "fd") as im:
        for i in range(nobj):
            s.call(im.write, i * OBJ, bytes([i]) * 100)
        s.call(im.create_snap, "s1")
        s.call(im.write, 11 * OBJ + 11, b"CHANGED")
        s.call(im.create_snap, "s2")
    counter = ReadCounter(io, "fd")
    im2 = s.Image(counter, "fd", snapshot="s2")
    diff = s.call(im2.export_diff, from_snap="s1")
    im2.close()
    assert [e["off"] for e in diff["extents"]] == [11 * OBJ + 11]
    assert s.note(counter.data_reads) <= 4
    s.call(rbd.create, io, "fe", 8 * OBJ, order=ORDER)
    with s.Image(io, "fe") as im:
        s.call(im.write, 2 * OBJ, b"two")
        s.call(im.write, 6 * OBJ, b"six")
    counter = ReadCounter(io, "fe")
    with s.Image(counter, "fe", read_only=True) as im2:
        diff = s.call(im2.export_diff)
    assert sorted(e["off"] for e in diff["extents"]) == [2 * OBJ, 6 * OBJ]
    assert s.note(counter.data_reads) <= 4
    # a whole-object discard between snaps, and a dirty union over
    # several snaps
    s.call(rbd.create, io, "dz", 4 * OBJ, order=ORDER)
    with s.Image(io, "dz") as im:
        s.call(im.write, OBJ, b"q" * OBJ)
        s.call(im.create_snap, "a")
        s.call(im.discard, OBJ, OBJ)
        s.call(im.create_snap, "b")
        s.call(im.write, 3 * OBJ, b"three")
        s.call(im.create_snap, "c")
    with s.Image(io, "dz", snapshot="c") as im2:
        diff = s.call(im2.export_diff, from_snap="a")
    assert sorted(e["off"] for e in diff["extents"]) == [OBJ, 3 * OBJ]


def sc_object_map_flatten_and_snap_removal(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "fbase", 2 * OBJ, order=ORDER)
    with s.Image(io, "fbase") as par:
        s.call(par.write, 0, b"parent-bytes")
        s.call(par.create_snap, "g")
        s.call(par.protect_snap, "g")
    s.call(rbd.clone, io, "fbase", "g", "fkid")
    s.call(rbd.clone, io, "fbase", "g", "pfk")
    with s.Image(io, "fkid") as ch:
        s.call(ch.flatten)
        diff = s.call(ch.export_diff)
    assert any(bytes.fromhex(e["data"]).startswith(b"parent-bytes")
               for e in diff["extents"])
    with s.Image(io, "pfk") as ch:
        s.call(ch.create_snap, "pre")                # parent-backed
        s.call(ch.flatten)
    with s.Image(io, "pfk", snapshot="pre") as snapv:
        diff = s.call(snapv.export_diff)
    assert any(bytes.fromhex(e["data"]).startswith(b"parent-bytes")
               for e in diff["extents"])
    s.call(rbd.create, io, "rsm", 4 * OBJ, order=ORDER)
    with s.Image(io, "rsm") as im:
        s.call(im.write, 2 * OBJ, b"1111")
        s.call(im.create_snap, "s1")
        s.call(im.write, 2 * OBJ, b"2222")           # dirty in s2's map
        s.call(im.create_snap, "s2")
        s.call(im.remove_snap, "s2")
        diff = s.call(im.export_diff, from_snap="s1")
    assert any(e["off"] == 2 * OBJ and bytes.fromhex(e["data"]) == b"2222"
               for e in diff["extents"])
    s.call(rbd.create, io, "fr", 2 * OBJ, order=ORDER)
    with s.Image(io, "fr") as im:
        s.call(im.write, 0, b"keepme" * 100)
        real_remove = im.ioctx.remove

        def flaky_remove(oid):
            raise RuntimeError("transient")

        im.ioctx.remove = flaky_remove
        try:
            s.call(im.discard, 0, OBJ)
        finally:
            im.ioctx.remove = real_remove
        assert s.note(bytes(im._objmap_load()))[0] == s.image_mod.OM_DIRTY
        assert s.call(im.export_diff)["extents"]


def sc_encryption(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "enc", 4 * OBJ, order=ORDER)
    secret = b"TOP-SECRET-PAYLOAD" * 100
    with s.Image(io, "enc") as im:
        s.call(im.encryption_format, "hunter2")
        s.call(im.encryption_format, "again")
        s.call(im.write, 1000, secret)
        assert s.call(im.read, 1000, len(secret)) == secret
    raw = bytes(io.read(s.image_mod._data_oid("enc", 0)))
    assert b"TOP-SECRET" not in s.note(raw)
    with s.Image(io, "enc", passphrase="hunter2") as im:
        assert s.call(im.read, 1000, len(secret)) == secret
    with s.Image(io, "enc", read_only=True) as im:
        s.call(im.read, 0, 10)                        # passphrase required
    s.call(s.Image, io, "enc", passphrase="letmein")
    s.call(rbd.remove, io, "enc")                     # without it
    assert "enc" not in s.call(rbd.list, io)
    s.call(rbd.create, io, "encp", 2 * OBJ, order=ORDER)
    with s.Image(io, "encp") as im:
        s.call(im.encryption_format, "pw")
        s.call(im.write, 0, b"A" * 1000)
        s.call(im.write, 500, b"B" * 100)             # overlapping RMW
        assert s.call(im.read, 0, 1000) == \
            b"A" * 500 + b"B" * 100 + b"A" * 400
        s.call(im.discard, 200, 100)
        got = s.call(im.read, 0, 1000)
        assert got[200:300] == b"\x00" * 100 and got[:200] == b"A" * 200
        s.call(im.create_snap, "s1")
        s.call(im.write, 0, b"gen-two!")
    with s.Image(io, "encp", snapshot="s1", passphrase="pw") as sv:
        assert s.call(sv.read, 0, 8) == b"A" * 8
    with s.Image(io, "encp", passphrase="pw") as im:
        assert s.call(im.export_diff, from_snap="s1")["extents"]
    s.call(rbd.create, io, "encg", OBJ, order=ORDER)
    with s.Image(io, "encg") as im:
        s.call(im.write, 0, b"data-first")
        s.call(im.encryption_format, "pw")            # has data
    s.call(rbd.create, io, "encj", OBJ, order=ORDER, journaling=True)
    with s.Image(io, "encj") as im:
        s.call(im.encryption_format, "pw")            # journaling


def sc_migration(s, p):
    io, rbd = s.ios[p], s.RBD()
    io2 = s.ios["rep" if p == "ec" else "ec"]
    s.call(rbd.create, io, "vmdisk", 8 * OBJ, order=ORDER)
    with s.Image(io, "vmdisk") as src:
        s.call(src.write, 0, b"boot-sector" * 100)
        s.call(src.write, 5 * OBJ, b"tail-data")
    s.call(rbd.migration_prepare, io, "vmdisk", io2, "vmdisk-new")
    s.call(rbd.migration_prepare, io, "vmdisk", io2, "again")
    with s.Image(io, "vmdisk") as src:
        s.call(src.write, 0, b"x")                    # mid-migration
    with s.Image(io2, "vmdisk-new") as d:
        assert s.call(d.read, 0, 11) == b"boot-sector"
        assert s.call(d.read, 5 * OBJ, 9) == b"tail-data"
        s.call(d.write, 4, b"PATCH")
        assert s.call(d.read, 0, 11) == b"bootPATCHor"
    s.call(rbd.migration_commit, io2, "vmdisk-new")   # not copied yet
    assert s.call(rbd.migration_execute, io2, "vmdisk-new") >= 1
    s.call(rbd.migration_commit, io2, "vmdisk-new")
    assert "vmdisk" not in s.call(rbd.list, io)
    with s.Image(io2, "vmdisk-new") as d:
        assert d._hdr.get("migration_source") is None
        assert s.call(d.read, 0, 11) == b"bootPATCHor"
        assert s.call(d.read, 5 * OBJ, 9) == b"tail-data"
    s.call(rbd.create, io, "mab", 2 * OBJ, order=ORDER)
    with s.Image(io, "mab") as src:
        s.call(src.write, 0, b"keep-me")
    s.call(rbd.migration_prepare, io, "mab", io2, "mab-new")
    s.call(rbd.migration_abort, io2, "mab-new")
    assert "mab-new" not in s.call(rbd.list, io2)
    with s.Image(io, "mab") as src:
        s.call(src.write, 7, b"!")
        assert s.call(src.read, 0, 8) == b"keep-me!"
    s.call(rbd.create, io, "mz", 2 * OBJ, order=ORDER)
    with s.Image(io, "mz") as src:
        s.call(src.write, 0, b"Z" * OBJ)
    s.call(rbd.migration_prepare, io, "mz", io2, "mz-new")
    with s.Image(io2, "mz-new") as d:
        s.call(d.discard, 0, OBJ)
        assert s.call(d.read, 0, 100) == b"\x00" * 100
    s.call(rbd.migration_execute, io2, "mz-new")
    s.call(rbd.migration_commit, io2, "mz-new")
    with s.Image(io2, "mz-new") as d:
        assert s.call(d.read, 0, 100) == b"\x00" * 100
    s.call(rbd.migration_execute, io2, "mz-new")      # not a target


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_object_map_states, sc_fast_diff,
    sc_object_map_flatten_and_snap_removal, sc_encryption, sc_migration)}
CASES = [(name, "ec") for name in SCENARIOS] + [("migration", "rep")]


class TestRBDFeaturesAgainstCephTpu:
    @pytest.mark.parametrize("scenario,pool", CASES)
    def test_scenario_replies_match(self, pair, scenario, pool):
        outs = {}
        for pkg, s in pair.items():
            s.out = []
            SCENARIOS[scenario](s, pool)
            outs[pkg] = s.out
        assert outs["port"] == outs["ceph_tpu"]
        assert len(outs["port"]) > 5

    def test_stores_match(self, pair):
        views = {pkg: store_views(s) for pkg, s in pair.items()}
        assert views["port"] == views["ceph_tpu"]
        names = {oid for v in views["port"].values() for _c, oid in v}
        for pre in ("rbd_header.enc", "rbd_data.encp.", "rbd_object_map.",
                    "rbd_data.vmdisk-new."):
            assert any(o.startswith(pre) for o in names), pre
