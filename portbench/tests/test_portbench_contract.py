"""BENCHMARK.json and the files it names: the shape the benchmark's
contract asks for, and every name found by the harness with no edit."""
import json
import math
import re

import pytest

import cases
from portbench import harness as H

ROOT = cases.ROOT
BENCH = cases.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "proj", "head",
          "expansion", "experts_per_tok", "num_experts_per_tok")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_units_and_lines(group):
    items = BENCH[group]
    names = [x["name"] for x in items]
    assert len(set(names)) == len(names)
    for x in items:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
            assert x["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in x and group != "end_to_end" or key == "why" and \
                    key in x:
                assert _line(x[key]), (x["name"], key)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in H.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        assert H.metrics_of(BENCH, w["name"], True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}
            assert m["moves"] in {x["name"] for x in
                                  H.metrics_of(BENCH, cell, False)}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_configs_files_and_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert c["file"].startswith("portbench/")
        cfg = H.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert key in cfg["published"], key
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert not any(w in key for w in WIDTHS), key
        pub, m = cfg["published"], cfg["model"]
        assert (m["d_model"], m["num_layers"], m["num_heads"],
                m["num_kv_heads"], m["d_ff"], m["vocab_size"]) == (
            pub["hidden_size"], pub["num_hidden_layers"],
            pub["num_attention_heads"], pub["num_key_value_heads"],
            pub["intermediate_size"], pub["vocab_size"])
        assert m["norm_eps"] == pub["rms_norm_eps"]
        assert m["rope_theta"] == pub["rope_theta"]
        if "num_local_experts" in pub:
            assert (m["num_experts"], m["top_k"]) == (
                pub["num_local_experts"], pub["num_experts_per_tok"])


def test_edge_is_the_configs_edge_variant():
    from repro_torch.models.config import ModelConfig
    for c in BENCH["configs"]:
        cfg = H.load_json(ROOT / c["file"])
        want = ModelConfig(**cfg["model"]).edge_variant()
        got = ModelConfig(**cfg["edge"])
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "num_experts", "top_k",
                  "norm_eps", "rope_theta", "attn_bias", "attn_impl"):
            assert getattr(got, f) == getattr(want, f), f


def test_every_cell_finds_its_files_and_fits_its_context():
    for w in BENCH["workloads"]:
        cell, entry = H.cell(BENCH, w["name"])
        assert cell.mix["name"] == w["traffic"]
        H.driver(cell.mix)
        cfg = cell.config
        lo, hi = cell.mix["prompt_tokens"]
        assert hi + cell.mix["answer_tokens"][1] <= cell.mix["cache_len"]
        assert cell.mix["cache_len"] <= \
            cfg["published"]["max_position_embeddings"]
        assert set(cell.checks["limits"]) >= {"answer_miss", "route_miss",
                                              "conf_err_max"}
        for m in H.metrics_of(BENCH, w["name"], False) + \
                H.metrics_of(BENCH, w["name"], True):
            assert callable(H.reader(m["name"]).read)


def test_a_new_config_mix_cell_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "checks", "metrics"):
        (root / sub).mkdir(parents=True)
    cfg = cases.config("granite-moe-1b-a400m")
    cfg["name"] = "new-model"
    (root / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (root / "traffic" / "new-mix.json").write_text(json.dumps(cases.mix()))
    (root / "checks" / "new-cell.json").write_text(
        json.dumps({"limits": cases.LIMITS}))
    (root / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 2.0 * run.window_s\n")
    bench = {"configs": [{"name": "new-model", "source": "https://x",
                          "file": "portbench/configs/new-model.json",
                          "reduced": [], "why": "t"}],
             "workloads": [{"name": "new-cell", "config": "new-model",
                            "traffic": "new-mix", "chips": 1, "why": "t"}],
             "end_to_end": [], "per_layer": [
                 {"name": "new_metric", "unit": "s", "better": "lower",
                  "source": "host_clock", "layer": "l", "moves": "x"}]}
    cell, _ = H.cell(bench, "new-cell", root=root)
    assert cell.config["model"]["num_experts"] == 8
    assert cell.mix["burst"] == 8
    mod = H.reader("new_metric", where=root / "metrics")
    assert mod.read(type("R", (), {"window_s": 1.5})) == 3.0
    assert [m["name"] for m in H.metrics_of(bench, "new-cell", True)] == [
        "new_metric"]


def test_bounds_are_set_and_setup_has_its_own():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for name, m in e2e.items():
        assert not math.isnan(m["bound"])
