"""The port's input shapes, abstract trees and roofline against the
reference's.

Exact throughout: ``input_specs``, ``abstract_params``,
``make_cache(abstract=True)`` (f32 and int8 KV), ``adamw.abstract_state``
and ``quantize.abstract_quantized`` give the reference's shapes and
dtypes leaf for leaf; ``decode_window``, ``attn_cache_len`` and
``param_count`` its values; and for every arch x shape the roofline's
FLOP and byte counts (``analytic_flops``, ``model_flops``,
``analytic_hbm_bytes``, ``analytic_collective_bytes``, the pixel
roofline) equal the reference's.  Only the seconds differ, by the ratio
of the H100's spec-sheet constants to the reference's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.configs import shapes as RS
from repro.distributed import quantize as RQZ
from repro.launch import mesh as RMESH
from repro.launch import roofline as RR
from repro.models import meta as RM
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch.configs import get_config
from repro_torch.configs import shapes as S
from repro_torch.distributed import quantize as QZ
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as R
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A

SHAPES = list(S.INPUT_SHAPES)
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int32: jnp.int32, torch.int8: jnp.int8}


def _abstract(tree):
    """{path: (shape, dtype)} of a port tree of meta tensors."""
    out = {}
    for path, t in M.leaves(tree):
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), DTYPES[t.dtype])
    return out


def _ref_abstract(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(s.shape), s.dtype)
            for path, s in jax.tree_util.tree_leaves_with_path(tree)}


def test_input_shapes_match_reference():
    assert S.INPUT_SHAPES == {k: S.InputShape(**dataclasses.asdict(v))
                              for k, v in RS.INPUT_SHAPES.items()}
    assert S.LONG_CONTEXT_WINDOW == RS.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", ASSIGNED)
def test_shapes_and_abstract_trees_match_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert M.param_count(cfg) == RM.param_count(ref)
    for name in SHAPES:
        shape, rshape = S.INPUT_SHAPES[name], RS.INPUT_SHAPES[name]
        assert S.decode_window(cfg, shape) == RS.decode_window(ref, rshape)
        assert S.attn_cache_len(cfg, shape) == RS.attn_cache_len(ref, rshape)
        assert _abstract(S.input_specs(cfg, shape)) == _ref_abstract(
            RS.input_specs(ref, rshape))
    for dt in (torch.float32, torch.bfloat16):
        pabs = M.abstract_params(cfg, dt)
        assert _abstract(pabs) == _ref_abstract(
            RM.abstract_params(ref, DTYPES[dt]))
    pabs = M.abstract_params(cfg, torch.bfloat16)
    rabs = RM.abstract_params(ref, jnp.bfloat16)
    st, rst = A.abstract_state(pabs), RA.abstract_state(rabs)
    assert _abstract({"m": st.m, "v": st.v, "count": st.count}) == \
        _ref_abstract({"m": rst.m, "v": rst.v, "count": rst.count})
    assert _abstract(QZ.abstract_quantized(pabs, cfg)) == _ref_abstract(
        RQZ.abstract_quantized(rabs, ref))
    for kv in ("model", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        r = dataclasses.replace(ref, kv_cache_dtype=kv)
        assert _abstract(T.make_cache(c, 4, 96, dtype=torch.bfloat16,
                                      abstract=True)) == _ref_abstract(
            RT.make_cache(r, 4, 96, dtype=jnp.bfloat16, abstract=True))


def test_abstract_cache_and_params_need_no_device():
    cfg = get_config("qwen3-8b")
    cache = T.make_cache(cfg, 128, 32768, dtype=torch.bfloat16,
                         abstract=True)
    assert cache["layers"]["k"].shape == (36, 128, 32768, 8, 128)
    assert all(t.device.type == "meta" for _, t in M.leaves(cache))
    concrete = T.make_cache(get_config("qwen1.5-0.5b").reduced(), 2, 8,
                            device="cpu")
    assert bool((concrete["kpos"] == -1).all())
    assert not any(bool(t.any()) for p, t in M.leaves(concrete)
                   if p != "kpos")


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("shape", SHAPES)
def test_roofline_counts_match_reference(arch, shape):
    cfg, ref = get_config(arch), ref_get_config(arch)
    sh, rsh = S.INPUT_SHAPES[shape], RS.INPUT_SHAPES[shape]
    assert R.analytic_flops(cfg, sh) == RR.analytic_flops(ref, rsh)
    assert R.model_flops(cfg, sh) == RR.model_flops(ref, rsh)
    for chips, tp, two_d, micro in ((256, 16, False, 1), (512, 16, True, 4),
                                    (256, 16, True, 8)):
        assert R.analytic_hbm_bytes(cfg, sh, chips, two_d) == \
            RR.analytic_hbm_bytes(ref, rsh, chips, two_d)
        assert R.analytic_collective_bytes(
            cfg, sh, chips // tp, tp, two_d, micro) == \
            RR.analytic_collective_bytes(ref, rsh, chips // tp, tp, two_d,
                                         micro)
    rec = {"cost": {"flops": 1.5e12}, "collectives": {"total_bytes": 3e9}}
    for chips in (256, 512):
        got = R.analyze(cfg, sh, chips=chips, dryrun_record=rec)
        want = RR.analyze(ref, rsh, chips=chips, dryrun_record=rec)
        for f in ("chips", "model_flops", "analytic_flops",
                  "compiled_flops", "compiled_coll_bytes"):
            assert getattr(got, f) == getattr(want, f), f
        # the seconds scale by the ratio of the constants, nothing else
        np.testing.assert_allclose(
            got.compute_s * MESH.PEAK_FLOPS_BF16,
            want.compute_s * RMESH.PEAK_FLOPS_BF16, rtol=1e-12)
        np.testing.assert_allclose(got.memory_s * MESH.HBM_BW,
                                   want.memory_s * RMESH.HBM_BW, rtol=1e-12)
        np.testing.assert_allclose(got.collective_s * MESH.LINK_BW,
                                   want.collective_s * RMESH.ICI_BW,
                                   rtol=1e-12)
        assert got.compute_s > 0 and got.memory_s > 0
        assert got.dominant in ("compute", "memory", "collective")
        assert got.useful_ratio == want.useful_ratio


@pytest.mark.parametrize("batch,h,w", [(1, 96, 128), (12, 96, 128),
                                       (8, 1080, 1920)])
def test_pixel_roofline_counts_match_reference(batch, h, w):
    for fused in (True, False):
        got = R.pixel_cascade_roofline(batch, h, w, fused=fused)
        want = RR.pixel_cascade_roofline(batch, h, w, fused=fused)
        assert (got.name, got.hbm_bytes, got.flops) == \
            (want.name, want.hbm_bytes, want.flops)
        assert got.ai == want.ai
        assert got.ridge == MESH.PEAK_FLOPS_BF16 / MESH.HBM_BW
        assert 0.0 < got.roofline_fraction <= 1.0
        assert set(got.to_row()) == set(want.to_row())


def test_load_dryrun_reads_a_record(tmp_path):
    rec = {"cost": {"flops": 2.0e13}, "collectives": {"total_bytes": 7.0}}
    (tmp_path / "qwen3-8b__train_4k__single.json").write_text(
        json.dumps(rec))
    assert R.load_dryrun(str(tmp_path), "qwen3-8b", "train_4k",
                         "single") == rec
    assert R.load_dryrun(str(tmp_path), "qwen3-8b", "train_4k",
                         "multi") is None
    assert RR.load_dryrun(str(tmp_path), "qwen3-8b", "train_4k",
                          "single") == rec
