"""The port stands alone: no JAX, nothing of ``repro``, and the card by
default."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.system as P
from repro_torch.system import run_query

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
        "pixel_cascade.cu", "superstep.cu", "associate.cu",
        "flash_attention.cu"}


def test_running_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.system import single_edge, drifting_city, "
        "pixel_city, metropolis, vehicle_pursuit, run_query\n"
        "from repro_torch.serving.engine import AsyncDriver\n"
        "r = run_query(single_edge(duration_s=5.0), device='cpu')\n"
        "m = run_query(metropolis(num_cameras=1024, duration_s=3.0), "
        "device='cpu')\n"
        "v = run_query(vehicle_pursuit(duration_s=10.0), "
        "driver=AsyncDriver(), device='cpu')\n"
        "assert m.supersteps > 0 and v.track_launches > 0\n"
        "d = run_query(drifting_city(num_cameras=4, duration_s=10.0), "
        "device='cpu')\n"
        "p = run_query(pixel_city(num_cameras=2, duration_s=3.0), "
        "frontend='pixel', device='cpu')\n"
        "assert r.n_items > 0 and d.n_items > 0 and p.n_items > 0\n"
        "import dataclasses\n"
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core.thresholds import ThresholdState\n"
        "from repro_torch.models import meta as M\n"
        "from repro_torch.serving.engine import CascadeServer, Request\n"
        "full = get_config('qwen1.5-0.5b')\n"
        "cloud = dataclasses.replace(full.reduced(), attn_impl='flash')\n"
        "edge = full.edge_variant()\n"
        "srv = CascadeServer(edge, M.init_params(edge, "
        "torch.Generator().manual_seed(1)), cloud, M.init_params(cloud, "
        "torch.Generator().manual_seed(0)), slots=2, cache_len=24, "
        "thresholds=ThresholdState(alpha=1.0, beta=0.0), device='cpu')\n"
        "out = srv.run([Request(rid=i, tokens=np.arange(8 + i) % 512, "
        "max_new=3) for i in range(3)])\n"
        "assert all(len(o.output) == 3 for o in out.values())\n"
        "from repro_torch.serving.workload import build_workload\n"
        "w = build_workload(num_cameras=2, num_edges=1, duration_s=5.0, "
        "finetune_steps=2, device='cpu')\n"
        "assert w.items and w.edge_accuracy == w.edge_accuracy\n"
        "from repro_torch import serve_demo\n"
        "from repro_torch.launch import train\n"
        "assert serve_demo.main(['--device', 'cpu']) == 0\n"
        "assert train.main(['--reduced', '--steps', '2', '--batch', '2', "
        "'--seq', '16', '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


#: the multi-device slice's modules: importing one starts no process
#: group, builds no device mesh and touches no card
MULTI_DEVICE_MODULES = ["repro_torch.launch.mesh",
                        "repro_torch.distributed.sharding",
                        "repro_torch.configs.shapes",
                        "repro_torch.launch.roofline",
                        "repro_torch.launch.dryrun",
                        "repro_torch.launch.multihost",
                        "repro_torch.launch.train"]


def test_multi_device_modules_start_no_group_at_import():
    code = (
        "import importlib, sys, threading\n"
        f"for m in {MULTI_DEVICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'a process group at import'\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for name in MULTI_DEVICE_MODULES:
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        assert path in PORT_FILES, name


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_query(P.single_edge(duration_s=5.0))


def _training_entries():
    """The training slice's public entry points, each called without a
    device."""
    from repro_torch import finetune_cq, quickstart, serve_cascade
    from repro_torch.core.finetune import pretrain_backbone
    from repro_torch.serving.workload import build_workload
    from repro_torch.system.pixel_frontend import cq_config
    return {
        "build_workload": lambda: build_workload(
            num_cameras=2, duration_s=5.0, finetune_steps=1),
        "pretrain_backbone": lambda: pretrain_backbone(
            cq_config(), torch.Generator().manual_seed(0), iter(())),
        "finetune_cq": lambda: finetune_cq.main([]),
        "quickstart": lambda: quickstart.main([]),
        "serve_cascade": lambda: serve_cascade.main([]),
    }


@pytest.mark.parametrize("name", ["build_workload", "pretrain_backbone",
                                  "finetune_cq", "quickstart",
                                  "serve_cascade"])
def test_training_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        _training_entries()[name]()


def test_pipeline_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.QueryPipeline(P.single_edge(duration_s=5.0))
    pipe = P.QueryPipeline(P.single_edge(duration_s=5.0), device="cpu")
    assert pipe.device == torch.device("cpu")


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


def test_ported_presets_resolve_and_run_small():
    # metropolis pins >= 1024 cameras: tests/test_torch_superstep.py runs it
    assert set(P.PORTED_SCENARIOS) == set(P.SCENARIOS)
    for name in P.PORTED_SCENARIOS:
        if name == "metropolis":
            continue
        sc = P.SCENARIOS[name](num_cameras=4, duration_s=4.0)
        assert run_query(sc, device="cpu").summary()["supersteps"] == 0
