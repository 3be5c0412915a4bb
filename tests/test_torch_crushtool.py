"""The port's ``crushtool`` against ceph_tpu's, on the CPU: ``--test``
reports (``--show-mappings``, ``--show-utilization``,
``--show-statistics``, with ``--weight``) equal line for line apart from
the engine line on stderr, for a firstn and an indep rule; ``--build``
writes the same map; ``-c`` / ``-d`` round-trip; and the rules on
engines and devices."""

import json

import pytest

from ceph_tpu.crush import build_hierarchy
from ceph_tpu.crush.compiler import crushmap_to_dict
from ceph_tpu.tools import crushtool as J
from ceph_tpu_torch.tools import crushtool as P

BUILD = ["--build", "--num-osds", 48, "host", "straw2", 4, "rack", "straw2",
         3, "root", "straw2", 0]
SHOW = ["--show-mappings", "--show-utilization", "--show-statistics"]


def run(tool, argv, capsys):
    rc = tool.main([str(a) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.fixture
def maps(tmp_path):
    """A --build map (firstn rule) and an EC-style map (indep rule) as
    JSON, written by ceph_tpu."""
    built = tmp_path / "built.json"
    assert J.main([str(a) for a in BUILD + ["-o", built]]) == 0
    indep = tmp_path / "indep.json"
    indep.write_text(json.dumps(crushmap_to_dict(
        build_hierarchy(1, 6, 4, rule="chooseleaf_indep"))))
    return {"firstn": built, "indep": indep}


@pytest.mark.parametrize("rule", ["firstn", "indep"])
@pytest.mark.parametrize("extra", [
    pytest.param(["--num-rep", 3, "--max-x", 255], id="rep3"),
    pytest.param(["--num-rep", 5, "--weight", "5:0.5", "--weight", "7,0",
                  "--min-x", 100, "--max-x", 400], id="rep5-weights")])
def test_test_report_matches_ceph_tpu(maps, capsys, rule, extra):
    argv = ["-i", maps[rule], "--test", *extra, *SHOW]
    jrc, jout, jerr = run(J, argv, capsys)
    prc, pout, perr = run(P, argv + ["--device", "cpu"], capsys)
    assert jrc == prc == 0
    assert pout == jout
    assert pout.count("CRUSH rule 0 x ") == (256 if "--min-x" not in
                                             extra else 301)
    assert "engine: batched (cpu)" in perr
    src, sout, serr = run(P, argv + ["--scalar"], capsys)
    assert src == 0 and sout == pout
    assert "engine: scalar-oracle" in serr


def test_build_writes_ceph_tpus_map(tmp_path, capsys):
    pmap, jmap = tmp_path / "p.json", tmp_path / "j.json"
    assert run(P, BUILD + ["-o", pmap], capsys)[0] == 0
    assert run(J, BUILD + ["-o", jmap], capsys)[0] == 0
    assert json.loads(pmap.read_text()) == json.loads(jmap.read_text())
    # --build then --test in one call, as the reference tool allows
    rc, out, _ = run(P, BUILD + ["--test", "--num-rep", 2, "--max-x", 9,
                                 "--show-statistics", "--device", "cpu"],
                     capsys)
    assert rc == 0
    assert out == "rule 0 (replicated_rule) num_rep 2 result size == 2:" \
                  "\t10/10\n"


def test_compile_decompile_round_trip(maps, tmp_path, capsys):
    rc, ptext, _ = run(P, ["-d", maps["firstn"]], capsys)
    assert rc == 0
    assert ptext == run(J, ["-d", maps["firstn"]], capsys)[1]
    src = tmp_path / "map.txt"
    src.write_text(ptext)
    assert run(P, ["-c", src, "-o", tmp_path / "p.json"], capsys)[0] == 0
    assert run(J, ["-c", src, "-o", tmp_path / "j.json"], capsys)[0] == 0
    pj = json.loads((tmp_path / "p.json").read_text())
    assert pj == json.loads((tmp_path / "j.json").read_text())
    assert pj == json.loads(maps["firstn"].read_text())
    assert run(P, ["-d", tmp_path / "p.json", "-o", tmp_path / "back.txt"],
               capsys)[0] == 0
    assert (tmp_path / "back.txt").read_text() == ptext
    # -i also reads the text form
    rc, out, _ = run(P, ["-i", src, "--test", "--num-rep", 3, "--max-x", 3,
                         "--show-mappings", "--device", "cpu"], capsys)
    assert rc == 0 and out.count("\n") == 4


def test_engine_rules(maps, capsys, monkeypatch):
    rc, _, err = run(P, ["-i", maps["firstn"], "--test", "--scalar",
                         "--require-batched"], capsys)
    assert rc == 2 and "--require-batched with --scalar" in err
    # a rule the batched mapper declines stops the run: no fallback
    m = P.load_map(str(maps["firstn"]))
    m.tunables.choose_local_tries = 2
    P.save_map(m, str(maps["firstn"]))
    rc, out, err = run(P, ["-i", maps["firstn"], "--test", "--num-rep", 3,
                           "--show-statistics", "--device", "cpu"], capsys)
    assert rc == 2 and "declines this rule" in err and out == ""
    assert run(P, ["-i", maps["firstn"], "--test", "--rule", 7], capsys
               )[0] == 1
    assert run(P, ["--test"], capsys)[0] == 1
    # with no card, the default device raises
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.main(["-i", str(maps["indep"]), "--test", "--num-rep", "2"])
