"""The port's offline tools (``ceph_tpu_torch.tools.objectstore_tool``,
``kvstore_tool`` and ``blackbox_tool``) against ceph_tpu's: the same
arguments on the same store or recorder file print the same output and
return the same code."""

import json
import os
import shutil

import pytest

import ceph_tpu_torch.os_store as P
from ceph_tpu.tools import blackbox_tool as j_blackbox
from ceph_tpu.tools import kvstore_tool as j_kvstore
from ceph_tpu.tools import objectstore_tool as j_objectstore
from ceph_tpu_torch.core.flight_recorder import FlightRecorder
from ceph_tpu_torch.mon.store import MonitorDBStore, StoreTransaction
from ceph_tpu_torch.tools import blackbox_tool as p_blackbox
from ceph_tpu_torch.tools import kvstore_tool as p_kvstore
from ceph_tpu_torch.tools import objectstore_tool as p_objectstore


def _both(capsys, j_main, p_main, argv, fix=lambda s: s):
    """Run both mains on ``argv``; return (rc, out) after holding them
    equal.  ``SystemExit`` (a refusal) counts as its message."""
    res = []
    for main in (j_main, p_main):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = ("exit", str(e.code))
        cap = capsys.readouterr()
        res.append((rc, fix(cap.out), cap.err))
    assert res[0] == res[1], argv
    return res[1][0], res[1][1]


@pytest.fixture
def osd_wal(tmp_path):
    """A port WALStore shaped like an OSD's: EC shard collections, a
    replicated PG with its ``_meta`` info and log rows, xattrs, omap."""
    path = str(tmp_path / "osd.wal")
    st = P.WALStore(path, sync_mode="always")
    st.mount()
    t = P.Transaction()
    for s in range(3):
        cid = f"1.0s{s}"
        t.create_collection(cid)
        for i in range(3):
            t.write(cid, f"obj{i}", 0, bytes([s, i]) * 100)
            t.setattrs(cid, f"obj{i}", {"_": json.dumps(
                {"version": [1, i], "size": 600, "hinfo": i}).encode()})
    t.create_collection("2.5").write("2.5", "plain", 0, b"payload" * 9)
    t.omap_setkeys("2.5", "_meta", {
        "info": json.dumps({"pgid": "2.5", "last_update": [3, 4]}).encode(),
        "log": json.dumps([{"op": "modify", "oid": "plain"}]).encode()})
    t.omap_setkeys("2.5", "plain", {"row": b"cell"})
    st.queue_transaction(t)
    st.umount()
    return path


def _copy(path, name):
    dst = os.path.join(os.path.dirname(path), name)
    shutil.copy(path, dst)
    return dst


@pytest.mark.parametrize("argv", [
    ["--op", "fsck"], ["--op", "list-pgs"], ["--op", "list"],
    ["--op", "list", "--pgid", "1.0"], ["--op", "info", "--pgid", "2.5"],
    ["--op", "log", "--pgid", "2.5"], ["--op", "info", "--pgid", "1.0"],
    ["--op", "info"], ["2.5", "plain", "dump"], ["1.0", "obj2", "dump"],
    ["1.0", "nope", "dump"], ["--op", "export", "--pgid", "9.9",
                              "--file", "x"], []])
def test_objectstore_tool_reads_equal(osd_wal, capsys, argv):
    _both(capsys, j_objectstore.main, p_objectstore.main,
          ["--data-path", osd_wal] + argv)


def test_objectstore_tool_export_import_remove_equal(osd_wal, tmp_path,
                                                     capsys):
    outs = {}
    for name, main in (("j", j_objectstore.main), ("p", p_objectstore.main)):
        wal = _copy(osd_wal, f"{name}.wal")
        exp = str(tmp_path / f"{name}.export")
        assert main(["--data-path", wal, "--op", "export", "--pgid", "1.0",
                     "--file", exp]) == 0
        assert main(["--data-path", wal, "--op", "remove",
                     "--pgid", "1.0"]) == 0
        assert main(["--data-path", wal, "2.5", "plain", "remove"]) == 0
        assert main(["--data-path", wal, "--op", "import",
                     "--file", exp]) == 0
        with pytest.raises(SystemExit):
            main(["--data-path", wal, "--op", "import", "--file", exp])
        outs[name] = (open(exp).read(), open(wal, "rb").read(),
                      capsys.readouterr().out)
    assert outs["j"] == outs["p"]


@pytest.mark.parametrize("damage", ["torn", "corrupt"])
def test_objectstore_tool_fsck_damage_equal(osd_wal, capsys, damage):
    with open(osd_wal, "rb") as f:
        raw = f.read()
    raw = raw + raw[:40] if damage == "torn" else \
        raw[:-5] + bytes([raw[-5] ^ 1]) + raw[-4:]
    with open(osd_wal, "wb") as f:
        f.write(raw)
    rc, out = _both(capsys, j_objectstore.main, p_objectstore.main,
                    ["--data-path", osd_wal, "--op", "fsck"])
    assert rc == 1 and json.loads(out)["tail"]["status"] == damage
    copies = [_copy(osd_wal, f"{n}.wal") for n in ("j", "p")]
    res = []
    for wal, main in zip(copies, (j_objectstore.main, p_objectstore.main)):
        res.append((main(["--data-path", wal, "--op", "fsck",
                          "--truncate-tail"]),
                    capsys.readouterr().out.replace(wal, "WAL"),
                    open(wal, "rb").read()))
    assert res[0] == res[1] and res[0][0] == 0


@pytest.fixture
def mon_wal(tmp_path):
    path = str(tmp_path / "mon.wal")
    db = MonitorDBStore(path, sync=False)
    t = StoreTransaction()
    t.put("paxos", "1", b"\x01\x02").put("paxos", "2", b"\x03")
    t.put("paxos", "10", 7).put("svc_osdmap", "last", "42")
    db.apply_transaction(t)
    t = StoreTransaction().erase("paxos", "2").erase_range("paxos", 5, 11)
    db.apply_transaction(t)
    db.close()
    return path


def test_mon_store_bytes_equal(mon_wal, tmp_path):
    from ceph_tpu.mon.store import MonitorDBStore as JDB
    from ceph_tpu.mon.store import StoreTransaction as JTxn
    path = str(tmp_path / "j.wal")
    db = JDB(path, sync=False)
    t = JTxn()
    t.put("paxos", "1", b"\x01\x02").put("paxos", "2", b"\x03")
    t.put("paxos", "10", 7).put("svc_osdmap", "last", "42")
    db.apply_transaction(t)
    db.apply_transaction(JTxn().erase("paxos", "2")
                         .erase_range("paxos", 5, 11))
    db.close()
    assert open(path, "rb").read() == open(mon_wal, "rb").read()
    a, b = MonitorDBStore(mon_wal), JDB(mon_wal)
    assert a._data == b._data and a.keys("paxos") == ["1"]
    assert a.get_int("svc_osdmap", "last") == 42
    a.close(), b.close()


@pytest.mark.parametrize("args", [
    ["list"], ["list", "paxos"], ["get", "paxos", "1"], ["get", "no", "x"],
    ["get", "paxos"], ["rm", "no", "x"], ["set", "paxos", "1"],
    ["rm", "paxos"], ["store-copy"]])
def test_kvstore_tool_reads_equal(mon_wal, capsys, args):
    _both(capsys, j_kvstore.main, p_kvstore.main, [mon_wal] + args)


def test_kvstore_tool_writes_equal(mon_wal, tmp_path, capsys):
    res = []
    for name, main in (("j", j_kvstore.main), ("p", p_kvstore.main)):
        wal = _copy(mon_wal, f"{name}.wal")
        blob = tmp_path / "blob"
        blob.write_bytes(b"\x00\xff" * 5)
        out_file = str(tmp_path / f"{name}.out")
        rcs = [main([wal, "set", "svc", "k", "val", "v1"]),
               main([wal, "set", "svc", "b", "in", str(blob)]),
               main([wal, "rm", "paxos", "1"]),
               main([wal, "get", "svc", "b", "out", out_file]),
               main([wal, "store-copy", str(tmp_path / f"{name}.copy")])]
        text = capsys.readouterr().out.replace(out_file, "OUT").replace(
            str(tmp_path / f"{name}.copy"), "COPY")
        res.append((rcs, text, open(wal, "rb").read(),
                    open(out_file, "rb").read(),
                    open(str(tmp_path / f"{name}.copy"), "rb").read()))
    assert res[0] == res[1] and res[0][0] == [0] * 5


def test_kvstore_tool_on_an_osd_wal(osd_wal, capsys):
    """The smoke's use: an OSD WAL holds no mon rows, and the tool's
    replay of it (every record's CRC) leaves the file as it was."""
    before = open(osd_wal, "rb").read()
    rc, out = _both(capsys, j_kvstore.main, p_kvstore.main,
                    [osd_wal, "list"])
    assert rc == 0 and out == ""
    assert open(osd_wal, "rb").read() == before


@pytest.fixture
def black_box(tmp_path):
    """A recorder that died uncleanly: boot, marks, snaps with perf and
    spans, a crash-point event, and a torn tail."""
    path = str(tmp_path / "osd.wal.bbox")
    fr = FlightRecorder(path, daemon="osd.3", max_bytes=4096)
    fr.open()
    for i in range(40):
        fr.note("txn", seq=i, b=100 + i)
        if i % 10 == 9:
            fr.snap(spans=[{"name": "s", "i": i}], clog=[{"message": "m"}],
                    perf={"osd.3": {"op": i, "lat": {"avgcount": i,
                                                       "sum": i / 10}}},
                    profiler={"launches": i}, crash={"armed": []})
    fr.event("crash_point", point="mid_record", n=4)
    fr._file.write(b"\xce\x01\x40\x00")     # torn: died mid-append
    fr._file.flush()
    return path


@pytest.mark.parametrize("args", [
    ["--op", "info"], ["--op", "info", "--json"], ["--op", "timeline"],
    ["--op", "timeline", "--json", "--tail", "5"],
    ["--op", "timeline", "--tail", "3"]])
def test_blackbox_tool_equal(black_box, capsys, args):
    rc, out = _both(capsys, j_blackbox.main, p_blackbox.main,
                    ["--path", black_box] + args)
    assert rc == 0 and out
    if args == ["--op", "info", "--json"]:
        info = json.loads(out)
        assert info["crash_point"] == {"point": "mid_record", "n": 4}
        assert info["tail"]["status"] == "torn"


def test_blackbox_tool_missing(tmp_path, capsys):
    rc, _ = _both(capsys, j_blackbox.main, p_blackbox.main,
                  ["--path", str(tmp_path / "none")])
    assert rc == 1


def test_recorder_reopen_finds_the_corpse(black_box):
    fr = FlightRecorder(black_box, daemon="osd.3")
    prior = fr.open()
    assert prior["crash_point"] == {"point": "mid_record", "n": 4}
    assert prior["daemon"] == "osd.3" and not prior["clean_close"]
    assert os.path.exists(black_box + ".crash")
    fr.close()
    assert not os.path.exists(black_box + ".dirty")
