"""The port's production-shape dry-run CLI, each call in a process of its
own (the fake process group of 256 or 512 ranks is process-global).

The reference's ``tests/test_dryrun_cli.py`` calls, on the CPU's fake
tensors (``--device cpu``): qwen1.5-0.5b's long_500k decode on the
single and multi meshes must write one record with 256 or 512 chips,
per-device peak bytes and FLOPs above 0, the 8,192-token window and a
collective inventory; decode_32k with the int8 KV cache and 1-D serve
weights must run.  The reference's own test of these calls fails on this
host; these must pass.  The records' per-device FLOPs, counted on the
local shards, equal the reference's analytic count of the step over the
shards that split it, to 1e-3.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_cli_runs_and_records(mesh, tmp_path):
    r = _run(["--arch", "qwen1.5-0.5b", "--shape", "long_500k",
              "--mesh", mesh, "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "All dry-runs ran" in r.stdout
    recs = os.listdir(tmp_path)
    assert recs == [f"qwen1.5-0.5b__long_500k__{mesh}.json"]
    rec = json.load(open(tmp_path / recs[0]))
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["fits"] is True
    # FLOPs on the local shards: the reference's analytic count of the
    # step over the 16 "model" shards (one sequence: the data axes hold
    # copies), to 1e-3 (measured 4e-5: the norms and softmax it leaves out)
    per_device = R.analytic_flops(get_config("qwen1.5-0.5b"),
                                  INPUT_SHAPES["long_500k"]) / 16
    assert abs(rec["cost"]["flops"] / per_device - 1) < 1e-3
    assert rec["window"] == 8192
    assert rec["params"] == get_config("qwen1.5-0.5b").param_count()
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(
        v["bytes"] for v in coll.values() if isinstance(v, dict)
        and "bytes" in v)
    # TP all-reduces of the residual stream, a layer at least each
    assert coll["all-reduce"]["count"] >= 24
    assert sum(coll["comm_debug_counts"].values()) == sum(
        v["count"] for v in coll.values() if isinstance(v, dict)
        and "count" in v)
    # the record reads back through the roofline, as the reference's does
    out = str(tmp_path)
    got = R.load_dryrun(out, "qwen1.5-0.5b", "long_500k", mesh)
    rl = R.analyze(get_config("qwen1.5-0.5b"), INPUT_SHAPES["long_500k"],
                   chips=rec["chips"], dryrun_record=got)
    assert rl.compiled_flops == rec["cost"]["flops"] * rec["chips"]


def test_dryrun_cli_perf_knobs(tmp_path):
    r = _run(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
              "--mesh", "single", "--kv-dtype", "int8", "--serve-1d",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "chips=256" in r.stdout
    rec = json.load(open(tmp_path / "qwen1.5-0.5b__decode_32k__single.json"))
    assert rec["overrides"] == {"kv_dtype": "int8", "serve_1d": True}
    assert rec["window"] is None and rec["memory"]["fits"] is True
    # 128 sequences over 16 data shards, heads over 16 model shards
    per_device = R.analytic_flops(get_config("qwen1.5-0.5b"),
                                  INPUT_SHAPES["decode_32k"]) / 256
    assert abs(rec["cost"]["flops"] / per_device - 1) < 1e-3


def test_dryrun_cli_runs_a_process_a_combination(tmp_path):
    """More than one combination (here ``--mesh both``): a process each,
    the parsed override flags passed on to every one."""
    r = _run(["--arch", "qwen1.5-0.5b", "--shape", "long_500k",
              "--mesh", "both", "--kv-dtype", "int8", "--out",
              str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "All dry-runs ran (2 records)." in r.stdout
    assert r.stdout.count("[dryrun] qwen1.5-0.5b") == 2
    for mesh, chips in (("single", 256), ("multi", 512)):
        rec = json.load(open(
            tmp_path / f"qwen1.5-0.5b__long_500k__{mesh}.json"))
        assert rec["chips"] == chips and rec["mesh"] == mesh
        assert rec["overrides"] == {"kv_dtype": "int8"}


def test_dryrun_needs_the_card_unless_told_otherwise():
    if D.torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    assert D.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k"]) == 2


def test_dryrun_refuses_the_flash_kernel():
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), attn_impl="flash")
    with pytest.raises(ValueError, match="flash"):
        D.build_program(cfg, INPUT_SHAPES["long_500k"],
                        MESH.make_production_mesh(device_type="cpu"), "cpu")
