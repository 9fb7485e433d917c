"""The production-shape dry-run for every model family's decode, on the
CPU: ``python -m repro_torch.launch.dryrun --shape decode_32k --mesh
single --device cpu`` (256 ranks of a fake group; each call a process of
its own, started together) for the MoEs, mamba2, hymba, whisper,
internvl2 and qwen3-8b.

Each record must show what the context-parallel decode is for: no cache
leaf gathered (no all-gather returns the elements and dims of one
layer's cache leaf whole for the device's rows, and all of them together
move less than the largest such leaf), under
100 MB of collectives a device, and per-device FLOPs within 1% of the
reference's analytic count over the shards that split each term
(``roofline.decode_flops_per_device``).  That count is the reference's
formula but for three terms, each pinned against the reference's own
``analytic_flops`` here: the MoE's experts over their capacity slots,
and the SSD's state update and convs, which are elementwise.  phi3.5-moe
runs with 1-D serve weights here: under the reference's 2-D serve rule
its weights are split over "data" too and every step gathers them (5.7 GB
a device), which no cache layout changes.  The 2-D records (phi3.5-moe,
and command-r-35b, whose tied embedding is gathered for each of its two
uses) are held instead to one pass over the weights: the all-gathers
return at least that (``dryrun.serve_weight_pass_bytes``) and every
collective beside it stays under the same 100 MB.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.shapes import INPUT_SHAPES as REF_SHAPES
from repro.launch import roofline as RR
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, attn_cache_len
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as R
from repro_torch.models import layers as L
from repro_torch.models import meta as M
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"granite-moe-1b-a400m": (), "phi3.5-moe-42b-a6.6b": ("--serve-1d",),
         "mamba2-2.7b": (), "hymba-1.5b": (), "whisper-large-v3": (),
         "internvl2-1b": (), "qwen3-8b": ()}
#: the same decode under the default (2-D) serve rule
TWO_D = ["phi3.5-moe-42b-a6.6b", "command-r-35b"]
#: collective bytes a device a decode step
COLL_LIMIT = 100e6
FLOPS_RTOL = 0.01


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every ``ARCHS`` and ``TWO_D`` dry-run, started together: (arch,
    2-D or not) -> (exit code, output, record or None)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    calls = {(a, False): extra for a, extra in ARCHS.items()}
    calls.update({(a, True): () for a in TWO_D})
    procs = {(a, two_d): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", "decode_32k", "--mesh", "single", "--device", "cpu",
         "--out", str(out / f"{a}{two_d}"), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for (a, two_d), extra in calls.items()}
    got = {}
    try:
        for (a, two_d), p in procs.items():
            text = p.communicate(timeout=400)[0]
            path = out / f"{a}{two_d}" / f"{a}__decode_32k__single.json"
            got[a, two_d] = (p.returncode, text, json.loads(
                path.read_text()) if path.exists() else None)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return got


def _cache_leaves(cfg, rows: int) -> dict:
    """One layer's decode-cache leaves whole for ``rows`` rows: (elements,
    dims) -> bytes (bf16 values, f32 SSD state)."""
    cache = T.make_cache(cfg, rows, attn_cache_len(
        cfg, INPUT_SHAPES["decode_32k"]), dtype=torch.bfloat16,
        abstract=True)["layers"]
    return {(t[0].numel(), t[0].ndim): t[0].numel() * t[0].element_size()
            for _, t in M.leaves(cache)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_dryrun_gathers_no_cache(arch, records):
    rc, text, rec = records[arch, False]
    assert rc == 0 and rec is not None, text[-3000:]
    assert {"arch", "shape", "mesh", "chips", "memory", "cost",
            "collectives", "analytic", "window", "params"} <= set(rec)
    assert rec["chips"] == 256 and rec["memory"]["fits"] is True
    cfg = get_config(arch)
    coll = rec["collectives"]
    rows = INPUT_SHAPES["decode_32k"].global_batch // 16
    leaves = _cache_leaves(cfg, rows)
    for key in coll["all-gather"]["shapes"]:
        dims = [int(d) for d in key.split("x")]
        assert (int(np.prod(dims)), len(dims)) not in leaves, key
    assert coll["all-gather"]["cache_leaf_gathers"] == 0
    assert coll["all-gather"]["bytes"] < max(leaves.values())
    assert coll["total_bytes"] < COLL_LIMIT, coll
    want = R.decode_flops_per_device(cfg, INPUT_SHAPES["decode_32k"], 16, 16)
    assert rec["analytic"]["decode_flops_per_device"] == want
    assert abs(rec["cost"]["flops"] / want - 1) < FLOPS_RTOL
    assert rec["analytic"]["flops"] == RR.analytic_flops(
        ref_config(arch), REF_SHAPES["decode_32k"])


@pytest.mark.parametrize("arch", TWO_D)
def test_two_d_serve_decode_gathers_one_weight_pass(arch, records):
    """Under 2-D serve weights a decode step gathers each weight once a
    use, and nothing else beyond 100 MB; still no cache leaf."""
    rc, text, rec = records[arch, True]
    assert rc == 0 and rec is not None, text[-3000:]
    cfg = get_config(arch)
    mesh = MESH.make_production_mesh(device_type="cpu")
    assert SH.logical_to_mesh(cfg, mesh, "serve")["embed"] == "data"
    coll = rec["collectives"]
    assert coll["all-gather"]["cache_leaf_gathers"] == 0
    weights = D.serve_weight_pass_bytes(cfg, mesh)
    assert coll["all-gather"]["bytes"] >= weights > 1e9
    assert coll["total_bytes"] - weights < COLL_LIMIT, coll
    want = R.decode_flops_per_device(cfg, INPUT_SHAPES["decode_32k"], 16, 16)
    assert abs(rec["cost"]["flops"] / want - 1) < FLOPS_RTOL


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_count_is_the_references_but_three_terms(arch, shape):
    """``decode_flops_per_device`` on one device equals the reference's
    ``analytic_flops`` but for the MoE's capacity slots (E x cap a row
    where the reference counts top_k), the SSD's elementwise state update
    (4 nh hd N of its 6) and the depthwise convs."""
    cfg, sh = get_config(arch), INPUT_SHAPES[shape]
    want = RR.analytic_flops(ref_config(arch), REF_SHAPES[shape])
    per_row = 0.0
    if cfg.is_moe:
        gate = 3 if cfg.mlp_act == "silu" else 2
        per_row += 2 * gate * cfg.d_model * cfg.d_ff * (
            cfg.num_experts * L.moe_capacity(cfg, 1) - cfg.top_k)
    if cfg.has_ssm:
        conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        per_row -= 4 * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state
        per_row -= 2 * cfg.ssm_conv * conv_ch
    want += sh.global_batch * cfg.num_layers * per_row
    got = R.decode_flops_per_device(cfg, sh, 1, 1)
    assert abs(got / want - 1) < 1e-12, (got, want)


def test_decode_count_splits_where_the_rules_split():
    """Over a (16, 16) mesh, a config whose every term splits 16 ways
    (qwen1.5-0.5b: 16 heads, 16 KV heads, a vocabulary of 16 x 9,496)
    counts exactly the global count over 256 devices."""
    cfg, sh = get_config("qwen1.5-0.5b"), INPUT_SHAPES["decode_32k"]
    mesh = MESH.make_production_mesh(device_type="cpu")
    assert R.decode_flops_per_device(cfg, sh, SH.data_size(mesh), 16) == \
        pytest.approx(R.decode_flops_per_device(cfg, sh, 1, 1) / 256,
                      rel=1e-12)
