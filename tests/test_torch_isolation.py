"""The port stands alone: no JAX, nothing of ``repro``, the card by
default, and a clear refusal for every stage a later slice brings."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.system as P
from repro_torch.system import SimDriver, run_query

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    """Top-level module names every import statement in ``path`` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_covers_the_kernel_sources():
    assert len(PORT_FILES) > 30
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "triage.cu", "calibrate.cu", "framediff.cu", "morphology.cu",
        "pixel_cascade.cu"}


def test_running_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.system import single_edge, drifting_city, "
        "pixel_city, run_query\n"
        "r = run_query(single_edge(duration_s=5.0), device='cpu')\n"
        "d = run_query(drifting_city(num_cameras=4, duration_s=10.0), "
        "device='cpu')\n"
        "p = run_query(pixel_city(num_cameras=2, duration_s=3.0), "
        "frontend='pixel', device='cpu')\n"
        "assert r.n_items > 0 and d.n_items > 0 and p.n_items > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_query(P.single_edge(duration_s=5.0))


def test_pipeline_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.QueryPipeline(P.single_edge(duration_s=5.0))
    pipe = P.QueryPipeline(P.single_edge(duration_s=5.0), device="cpu")
    assert pipe.device == torch.device("cpu")


@pytest.mark.parametrize("name,kw,match", [
    ("metropolis", {}, "superstep"),
    ("vehicle_pursuit", {}, "track"),
    ("crowd_flow", {}, "track"),
])
def test_unported_presets_raise(name, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        run_query(P.SCENARIOS[name](**kw), device="cpu")


def test_pixel_frontend_runs_small_on_the_cpu():
    rep = run_query(P.pixel_city(num_cameras=2, duration_s=3.0),
                    frontend="pixel", device="cpu")
    assert rep.n_items > 0
    assert rep.stage_timings["classify_s"] > 0
    assert rep.summary()["launches_per_tick"] == 1.0


def test_pixel_frontend_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_query(P.pixel_city(), frontend="pixel")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.PixelFrontend()


def test_other_drivers_raise():
    class AsyncDriver:
        def drive(self, pipe):
            raise AssertionError("never reached")

    with pytest.raises(NotImplementedError, match="SimDriver"):
        run_query(P.single_edge(duration_s=5.0), driver=AsyncDriver(),
                  device="cpu")
    rep = run_query(P.single_edge(duration_s=5.0), driver=SimDriver(),
                    device="cpu")
    assert rep.n_items > 0


def test_runtime_track_query_submission_raises():
    from repro_torch.system import QueryPipeline, QuerySpec
    pipe = QueryPipeline(P.single_edge(duration_s=5.0), device="cpu")
    with pytest.raises(NotImplementedError, match="track"):
        pipe.register_query(QuerySpec(7, kind="track"))


def test_ported_presets_resolve_and_run_small():
    for name in P.PORTED_SCENARIOS:
        sc = P.SCENARIOS[name](num_cameras=4, duration_s=4.0)
        assert run_query(sc, device="cpu").summary()["supersteps"] == 0
