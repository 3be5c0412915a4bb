"""The port's PG module helpers, the OSD daemon's engine surface and its
device rules, against ceph_tpu on the CPU.

``ceph_tpu_torch.osd.pg``'s module helpers value for value;
``BatchEngine.maybe_flush`` per lane and ``BatchEngine.dump`` (the
daemon's ``dump_batch_engine``) against ceph_tpu's engine under one
config, with no timers: a ``flush_ms`` window and a poll; the OSDMap's
shared mapping memo against the scalar ``do_rule``; ``OSDaemon`` and
``MiniCluster`` without ``device=`` on a machine with no card.
Tolerance: exact bytes, digests and values.
"""

import json
import time

import numpy as np
import pytest
import torch

import ceph_tpu.osd.pg as RPG
import ceph_tpu_torch.osd.pg as PPG
from ceph_tpu.compress.registry import create_codec as r_codec
from ceph_tpu.ec import create_erasure_code as r_create
from ceph_tpu.os_store import MemStore as RMemStore
from ceph_tpu.os_store import Transaction as RTransaction
from ceph_tpu.osd import messages as RM
from ceph_tpu.osd.batch_engine import BatchEngine as RBatchEngine
from ceph_tpu_torch.compress.registry import create_codec as p_codec
from ceph_tpu_torch.crush.mapper import do_rule
from ceph_tpu_torch.ec import create_erasure_code as p_create
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.msg import EntityAddr
from ceph_tpu_torch.os_store import MemStore as PMemStore
from ceph_tpu_torch.os_store import Transaction as PTransaction
from ceph_tpu_torch.osd import OSDaemon, OSDMap, PGid
from ceph_tpu_torch.osd import messages as PM
from ceph_tpu_torch.osd import osdmap as POM
from ceph_tpu_torch.osd.batch_engine import BatchEngine as PBatchEngine
from ceph_tpu_torch.tools.osdmaptool import (osdmap_to_dict,
                                             shared_osdmap_from_dict)
from ceph_tpu_torch.vstart import MiniCluster

torch.set_num_threads(1)

PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": 4,
           "m": 2}
LANES = ("write", "recon", "comp")


def wait_for(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# -- module helpers --------------------------------------------------------

def test_constants_match():
    for name in ("META_OID", "SNAPMAP_OID", "_SNAP_SEP", "_WRITE_OPS",
                 "_NOOP_OPS", "_LOCAL_COMMIT"):
        assert getattr(PPG, name) == getattr(RPG, name), name


@pytest.mark.parametrize("oid,seq", [("a", 1), ("obj.with.dots", 7),
                                     ("", 0), ("x" * 300, 2 ** 40)])
def test_snap_clone_names_match(oid, seq):
    name = PPG.snap_clone_oid(oid, seq)
    assert name == RPG.snap_clone_oid(oid, seq)
    assert PPG.is_snap_clone(name) and RPG.is_snap_clone(name)
    assert PPG.is_snap_clone(oid) == RPG.is_snap_clone(oid)


@pytest.mark.parametrize("version,size,hinfo,extra", [
    ((1, 2), 0, None, None),
    ((3, 4), 16384, 0xDEADBEEF, None),
    ((5, 6), 100, 0, {"stored": 40, "comp": {"algo": "rle", "len": 100}}),
    ((7, 8), 8192, None, {"stored": 0, "dedup": [["ab", 4096],
                                                 ["cd", 4096]]}),
    ((9, 10), 1, 1, {}),
])
def test_obj_meta_and_extra_match(version, size, hinfo, extra):
    got = PPG._obj_meta(version, size, hinfo=hinfo, extra=extra)
    assert got == RPG._obj_meta(version, size, hinfo=hinfo, extra=extra)
    meta = json.loads(got)
    assert PPG._meta_extra(meta) == RPG._meta_extra(meta)
    assert PPG._meta_extra(None) == RPG._meta_extra(None) is None


@pytest.mark.parametrize("op", [
    {}, {"keys": ["b", "zz"]}, {"keys_only": True},
    {"keys": ["a"], "keys_only": True}, {"keys": []}])
def test_omap_read_result_matches(op):
    kv = {"a": b"\x00\x01", "b": b"", "c": b"xyz"}
    assert PPG._omap_read_result(kv, op) == RPG._omap_read_result(kv, op)


@pytest.mark.parametrize("pushed", [None, (1, 4), (1, 5), (1, 6), (2, 0)])
def test_push_is_stale_matches(pushed):
    answers = []
    for store, txn, msgs, pg in ((PMemStore("p"), PTransaction, PM, PPG),
                                 (RMemStore("r"), RTransaction, RM, RPG)):
        store.mount()
        store.queue_transaction(
            txn().create_collection("1.0").write("1.0", "o", 0, b"abc")
            .setattrs("1.0", "o", {"_": pg._obj_meta((1, 5), 3)}))
        out = []
        for oid in ("o", "missing"):
            msg = msgs.MOSDPGPush(
                pgid="1.0", epoch=1, oid=oid, data=b"x".hex(), attrs={},
                omap={}, version=None if pushed is None else list(pushed),
                from_osd=0, pull_tid=None)
            out.append(pg._push_is_stale(store, "1.0", msg))
        answers.append(out)
        store.umount()
    assert answers[0] == answers[1]
    assert answers[0][1] is False


# -- the engine's daemon surface -------------------------------------------

def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _submit(pkg, eng, lane):
    """One op of ``lane`` on ``pkg``'s engine; → its Completion."""
    data = _payload(5000, 3)
    if lane == "write":
        ec = (p_create(PROFILE, device="cpu") if pkg == "port"
              else r_create(PROFILE))
        return eng.submit_encode(ec, data)
    if lane == "recon":
        ec = (p_create(PROFILE, device="cpu") if pkg == "port"
              else r_create(PROFILE))
        shards = ec.encode(set(range(6)), data)
        have = {i: np.asarray(shards[i]) for i in (0, 2, 3, 5)}
        return eng.submit_reconstruct(ec, have, want={0, 1, 2, 3})
    codec = p_codec("rle") if pkg == "port" else r_codec("rle")
    return eng.submit_compress(codec, b"\x07" * 3000 + data[:2000])


def _engines(flush_ms):
    kw = dict(flush_ms=flush_ms, max_ops=1000, max_bytes=1 << 30)
    return {"port": PBatchEngine("osd.0", device="cpu", **kw),
            "ceph_tpu": RBatchEngine("osd.0", **kw)}


def _value(v):
    """A completion's value in comparable form."""
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_value(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return v


@pytest.mark.parametrize("lane", LANES)
def test_maybe_flush_waits_out_the_window(lane):
    """An op younger than its lane's window stays pending through the
    tick's backstop in both packages."""
    engines = _engines(flush_ms=600_000.0)
    for pkg, eng in engines.items():
        comp = _submit(pkg, eng, lane)
        assert eng.maybe_flush() is False, pkg
        assert not comp.done(), pkg
        d = eng.dump()
        prefix = {"write": "", "recon": "recon_", "comp": "comp_"}[lane]
        assert d[f"{prefix}pending_ops"] == 1, pkg
        eng.stop()
        assert comp.done(), pkg
    assert engines["port"].dump() == engines["ceph_tpu"].dump()


@pytest.mark.parametrize("lane", LANES)
def test_maybe_flush_per_lane_matches(lane):
    """Past the window, the tick's backstop flushes exactly that lane
    ("deadline"), and the value, the stats and ``dump()`` equal
    ceph_tpu's."""
    engines = _engines(flush_ms=1.0)
    values, dumps = {}, {}
    for pkg, eng in engines.items():
        comp = _submit(pkg, eng, lane)
        assert wait_for(eng.maybe_flush), pkg
        assert eng.maybe_flush() is False, pkg      # nothing left
        values[pkg] = _value(comp.result(timeout=30))
        eng.drain()
        dumps[pkg] = eng.dump()
        eng.stop()
    assert values["port"] == values["ceph_tpu"]
    prefix = {"write": "", "recon": "recon_", "comp": "comp_"}[lane]
    assert dumps["port"][f"{prefix}flush_deadline"] == 1
    assert dumps["port"] == dumps["ceph_tpu"]


def test_dump_keys_and_knobs_match():
    kw = dict(enabled=True, max_bytes=1 << 20, max_ops=7, flush_ms=2.5,
              recon_max_bytes=1 << 21, recon_max_ops=9,
              recon_flush_ms=3.5, comp_enabled=False, comp_max_ops=5,
              comp_segment_bytes=1 << 16, bucket_floor=64)
    port = PBatchEngine("osd.3", device="cpu", **kw)
    ref = RBatchEngine("osd.3", **kw)
    got, want = port.dump(), ref.dump()
    assert got == want
    assert got["recon_use_mesh"] is False
    port.stop()
    ref.stop()


# -- the daemon's mapping memo ---------------------------------------------

def test_mapping_memo_equals_do_rule():
    def build():
        m = OSDMap.build_simple(11, pg_bits=2)
        m.create_pool("ec", pg_num=32, size=11, type=POM.TYPE_ERASURE,
                      crush_rule=1)
        m.osd_weight[4] = 0x8000
        return m

    m = build()
    plain = {(p, s): m.pg_to_raw_osds(PGid(p, s))
             for p in m.pools for s in range(m.pools[p].pg_num)}
    assert m.mapping_key is None
    keyed = shared_osdmap_from_dict(osdmap_to_dict(build()))
    assert keyed.mapping_key == POM.mapping_key(osdmap_to_dict(m))
    for (p, s), raw in plain.items():
        assert keyed.pg_to_raw_osds(PGid(p, s)) == raw
        pool = keyed.pools[p]
        assert raw == do_rule(keyed.crush, pool.crush_rule,
                              pool.raw_pg_to_pps(s), pool.size,
                              keyed.osd_weight)
    # the memo answers the second time, and a reweight changes the key
    ec = keyed.pools[keyed.pool_name["ec"]]
    assert POM._RAW_MEMO[(keyed.mapping_key, 1, ec.raw_pg_to_pps(0), 11)]
    m.osd_weight[4] = 0x10000
    assert shared_osdmap_from_dict(osdmap_to_dict(m)).mapping_key \
        != keyed.mapping_key


# -- device rules ------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_daemon_and_cluster_raise_without_a_card():
    monmap = MonMap(mons={0: EntityAddr("127.0.0.1", 1)})
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDaemon(0, monmap)
    with pytest.raises(RuntimeError, match="CUDA"):
        MiniCluster(n_mons=1, n_osds=1)
    with pytest.raises(NotImplementedError, match="service-heads"):
        MiniCluster(n_mons=1, n_osds=1, device="cpu", procs=True)


def test_daemon_refuses_the_mesh():
    from ceph_tpu_torch.core.config import ConfigProxy
    from ceph_tpu_torch.core.options import build_options
    cfg = ConfigProxy(build_options())
    cfg.set("osd_recovery_batch_mesh", True)
    monmap = MonMap(mons={0: EntityAddr("127.0.0.1", 1)})
    with pytest.raises(NotImplementedError, match="multi-device"):
        OSDaemon(0, monmap, config=cfg, device="cpu")
