"""The configurations against their published sizes, and BENCHMARK.json
against the benchmark's contract and its own files."""
import json
import re

import pytest

from tiny import ROOT

from gpubench import core, counts

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                    r"projection|head_|_dim$|_rank$|expansion|"
                    r"experts_per_tok)")


def published(conf: dict) -> dict:
    """The config as published: the run's keys with the reduced ones put
    back."""
    return {**conf, **conf["published"]}


def params_of(conf: dict) -> int:
    return counts.total_params(counts.sizes(core.dims(conf)))


def test_mistral_7b_has_its_published_size():
    conf = core.Registry().config("mistral-7b")
    assert params_of(published(conf)) == 7_248_023_552          # 7.25 B
    assert params_of(conf) == params_of(published(conf))        # no cut
    assert conf["reduced"] == ["max_position_embeddings"]


def test_mixtral_8x7b_whole_and_as_cut():
    conf = core.Registry().config("mixtral-8x7b")
    whole = params_of(published(conf))
    assert round(whole / 1e9, 1) == 46.7
    assert round(params_of(conf) / 1e9, 2) == 3.16
    # 16 bytes a parameter (f32 weights, gradients, two moments)
    assert params_of(conf) * 16 < 80e9 < params_of(
        {**conf, "num_hidden_layers": 4}) * 16


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_the_port_counts_the_same_parameters(name):
    conf = core.Registry().config(name)
    cfg = core.model_config(conf)
    assert cfg.num_params() == params_of(conf)
    assert cfg.head_dim == 128 and cfg.kv_heads == 8


def test_manifest_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == conf["reduced"]
        assert set(conf["reduced"]) == set(conf["published"])
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (ROOT / "gpubench" / "workloads" / f"{w['name']}.json"
                ).exists()
    every_cell_reports = {c: [m["name"] for m in BENCH["end_to_end"]
                              if c in m.get("workloads", cells)]
                          for c in cells}
    assert all("setup_s" in v and len(v) >= 2
               for v in every_cell_reports.values())
