"""BENCHMARK.json keeps to the contract's rules of form: keys, names,
units, lengths, bounds, the budget of a check, and a file for everything
it names."""

import json
import os
import re

import pytest

from portbench_small import ROOT

MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok)")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", *KEYS}
    assert len(json.dumps(MAN).encode()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_text(w) for w in MAN["command"])
    files = [w for w in MAN["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in MAN["paths"])
               for f in files)


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = MAN[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _text(e[k])


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in MAN["configs"]}
    for c in cfgs.values():
        assert c["file"].startswith("portbench/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(c["reduced"]) <= set(body) and \
            set(c["reduced"]) == set(body["reduced"])
        assert os.path.isfile(os.path.join(
            ROOT, "portbench", "generators", body["generator"] + ".py"))
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert os.path.isfile(os.path.join(
            ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        used.add(w["config"])
        pairs.add((w["config"], w["traffic"]))
    assert used == set(cfgs)
    assert len(pairs) == len(MAN["workloads"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert os.path.isfile(os.path.join(
            ROOT, "portbench", "metrics", m["name"] + ".py"))
    for w in MAN["workloads"]:
        mine = [m["name"] for m in MAN["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in MAN["per_layer"])


def test_budget_of_a_check_fits_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_file_names_under_paths():
    for p in MAN["paths"]:
        for d, _, fs in os.walk(os.path.join(ROOT, p)):
            for f in fs:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert PATH.match(rel), rel
