"""The port's ``osdmaptool`` against ceph_tpu's, on the CPU: the same
``--createsimple`` map file, the same ``--test-map-pgs`` report (all but
its timing line) for a replicated and an erasure pool with OSDs marked
out, ``--scalar`` equal to the batched mapper, ``--test-map-object``,
crush export/import, and the rules on engines and devices."""

import io
import json

import pytest

from ceph_tpu.tools import osdmaptool as J
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.tools import osdmaptool as P


def run(tool, argv, capsys):
    rc = tool.main([str(a) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def report(out):
    """The report without its host-clock line."""
    return [ln for ln in out.splitlines() if not ln.startswith("mapped ")]


@pytest.mark.parametrize("pool_type", ["replicated", "erasure"])
def test_test_map_pgs_report_matches_ceph_tpu(tmp_path, capsys, pool_type):
    jmap, pmap = tmp_path / "j.json", tmp_path / "p.json"
    args = ["--createsimple", 64, "--pg-bits", 2, "--pool-type", pool_type]
    assert run(J, [jmap, *args], capsys)[0] == 0
    assert run(P, [pmap, *args], capsys)[0] == 0
    assert json.loads(jmap.read_text()) == json.loads(pmap.read_text())
    for path, tool in ((jmap, J), (pmap, P)):
        assert run(tool, [path, "--mark-out", 3, "--mark-out", 40,
                          "-o", path], capsys)[0] == 0
    # ceph_tpu's report goes to the stdout of its import time
    buf = io.StringIO()
    J.run_test_map_pgs(J.load_osdmap(str(jmap)), None, require_batched=True,
                       out=buf)
    jout = buf.getvalue()
    rc, pout, perr = run(P, [pmap, "--test-map-pgs", "--require-batched",
                             "--device", "cpu"], capsys)
    assert rc == 0
    assert "engine: batched (cpu)" in perr
    assert report(pout) == report(jout)
    assert pout.startswith("pool 0 pg_num 256\n")
    assert "size histogram: size 3 256" in pout or pool_type == "erasure"
    rc, sout, serr = run(P, [pmap, "--test-map-pgs", "--scalar"], capsys)
    assert rc == 0 and "engine: scalar-oracle" in serr
    assert report(sout) == report(pout)


def test_object_lookup_and_crush_round_trip(tmp_path, capsys):
    path, crush = tmp_path / "m.json", tmp_path / "crush.json"
    assert run(P, [path, "--createsimple", 16], capsys)[0] == 0
    jpath = tmp_path / "j.json"
    assert run(J, [jpath, "--createsimple", 16], capsys)[0] == 0
    _, pout, _ = run(P, [path, "--test-map-object", "foo", "--pool", 0],
                     capsys)
    _, jout, _ = run(J, [jpath, "--test-map-object", "foo", "--pool", 0],
                     capsys)
    assert pout == jout and "object 'foo'" in pout
    assert run(P, [path, "--export-crush", crush], capsys)[0] == 0
    assert run(P, [path, "--import-crush", crush, "-o", path],
               capsys)[0] == 0
    assert P.load_osdmap(str(path)).crush.max_devices == 16


def test_engine_rules(tmp_path, capsys, monkeypatch):
    path = tmp_path / "m.json"
    assert run(P, [path, "--createsimple", 8, "--pg-bits", 1], capsys)[0] == 0
    # --require-batched refuses the scalar oracle
    rc, _, err = run(P, [path, "--test-map-pgs", "--scalar",
                         "--require-batched"], capsys)
    assert rc == 2 and "--require-batched with --scalar" in err
    # a rule the batched mapper declines stops the run: no fallback
    m = P.load_osdmap(str(path))
    m.crush.tunables.choose_local_tries = 2
    P.save_osdmap(m, str(path))
    rc, out, err = run(P, [path, "--test-map-pgs", "--device", "cpu"],
                       capsys)
    assert rc == 2 and "declines this rule" in err
    assert "osd.0" not in out
    # with no card, the default device raises
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m.crush.tunables.choose_local_tries = 0
    with pytest.raises(RuntimeError, match="CUDA"):
        m.batch_mapper(0, 3)
    assert isinstance(m, OSDMap)
