"""The port's sharding rules against the reference's, spec for spec, and
the row-sharded superstep against one launch.

Specs are compared exactly (tuples of mesh-axis names against the
reference's ``PartitionSpec``s) on the production meshes — (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model") — for the ten
``ASSIGNED`` configs in both modes: parameters (and ``force_1d_serve``),
decode caches (decode_32k, f32 and int8 KV), input batches, int8-weight
shardings, the fleet specs and the activation constraints of ``ActCtx``.
The reference's own invariants (``tests/test_sharding.py``) are mirrored
on the port.  The superstep split is held bit for bit: ``_superstep_fn``
over 2, 4 and 8 row shards against one launch and against the
reference's single-device program, and ``metropolis`` at smoke size with
its fleet in 8 row shards on the CPU against the unsharded run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import INPUT_SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.distributed import quantize as RQZ
from repro.distributed import sharding as RSH
from repro.models import meta as RM
from repro.models import transformer as RT
from repro.system.superstep import _superstep_fn as ref_superstep_fn
from repro_torch.configs import get_config
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs
from repro_torch.distributed import quantize as QZ
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.system import metropolis, run_query
from repro_torch.system.superstep import _superstep_fn
from torch_kernel_cases import superstep_slab

MESHES = ["single", "multi"]


def _ref_mesh(kind):
    """An abstract reference mesh for spec computation (the one CPU
    device repeated, as ``tests/test_sharding.py`` builds it)."""
    shape = (2, 16, 16) if kind == "multi" else (16, 16)
    axes = ("pod", "data", "model") if kind == "multi" else ("data", "model")
    devs = np.asarray(jax.devices() * int(np.prod(shape)))[
        : int(np.prod(shape))].reshape(shape)
    return Mesh(devs, axes)


def _port_mesh(kind):
    return MESH.make_production_mesh(multi_pod=kind == "multi")


def _ref_leaves(tree, leaf_type):
    """(path, leaf) pairs of a reference tree in ``M.leaves`` order."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, leaf_type)):
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


def _spec_of(sh):
    return tuple(sh.spec if hasattr(sh, "spec") else sh)


def _same_specs(port_tree, ref_tree, leaf_type=P):
    got = {p: _spec_of(s) for p, s in M.leaves(port_tree)}
    want = {p: tuple(_spec_of(s)) for p, s in
            _ref_leaves(ref_tree, leaf_type).items()}
    assert got == want


def test_meshes_keep_the_reference_shapes():
    for kind in MESHES:
        ref, port = _ref_mesh(kind), _port_mesh(kind)
        assert port.shape == dict(ref.shape)
        assert MESH.chips(port) == ref.devices.size
    assert MESH.make_host_mesh().shape == {"data": 1, "model": 1}
    fleet = MESH.make_fleet_mesh(4, device_type="cpu")
    assert fleet.shape == {"fleet": 4} and fleet.devices == ("cpu",) * 4
    assert MESH.make_fleet_mesh(device_type="cpu").size == 1
    with pytest.raises(RuntimeError, match="process group"):
        _port_mesh("single").device_mesh


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", ["train", "serve", "serve_1d"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_reference(arch, mode, mesh):
    one_d = mode == "serve_1d"
    mode = "serve" if one_d else mode
    _same_specs(SH.param_specs(get_config(arch), _port_mesh(mesh), mode,
                               force_1d_serve=one_d),
                RSH.param_specs(ref_get_config(arch), _ref_mesh(mesh), mode,
                                force_1d_serve=one_d))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_batch_and_quantized_specs_match_reference(arch, mesh):
    cfg, ref = get_config(arch), ref_get_config(arch)
    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    shape = INPUT_SHAPES["decode_32k"]
    for kv in ("model", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        r = dataclasses.replace(ref, kv_cache_dtype=kv)
        for batch in (shape.global_batch, 1):
            got = SH.cache_specs(c, pm, batch, T.make_cache(
                c, batch, 4096, dtype=torch.bfloat16, abstract=True))
            want = RSH.cache_specs(r, rm, batch, RT.make_cache(
                r, batch, 4096, dtype=jnp.bfloat16, abstract=True))
            _same_specs(got, want, jax.sharding.NamedSharding)
    for name in INPUT_SHAPES:
        b = INPUT_SHAPES[name].global_batch
        _same_specs(SH.batch_specs(cfg, pm, b, input_specs(
                        cfg, INPUT_SHAPES[name])),
                    RSH.batch_specs(ref, rm, b, ref_input_specs(
                        ref, REF_SHAPES[name])),
                    jax.sharding.NamedSharding)
    pabs = M.abstract_params(cfg, torch.bfloat16)
    rabs = RM.abstract_params(ref, jnp.bfloat16)
    _same_specs(
        QZ.quantized_shardings(SH.param_shardings(cfg, pm, "serve"), pabs,
                               cfg, pm),
        RQZ.quantized_shardings(RSH.param_shardings(ref, rm, "serve"), rabs,
                                ref, rm),
        jax.sharding.NamedSharding)


def test_fleet_specs_and_guard_match_reference():
    assert {k: tuple(v) for k, v in RSH.fleet_specs().items()} == \
        SH.fleet_specs()
    for n in (1, 2, 3, 8):
        pm = MESH.make_fleet_mesh(n, device_type="cpu")
        rm = Mesh(np.asarray(jax.devices() * n)[:n], ("fleet",))
        assert SH.fleet_axis_size(pm) == RSH.fleet_axis_size(rm) == n
        for rows in (1, 8, 12, 64):
            assert SH.can_shard_fleet(pm, rows) == \
                RSH.can_shard_fleet(rm, rows)


ACT_CASES = [((256, 4096, 4096), "resid"), ((256, 1, 4096), "resid"),
             ((8, 4096, 4096), "resid"), ((256, 4096, 32, 128), "act_q"),
             ((256, 4096, 25, 64), "act_q"), ((256, 64, 80, 2048), "moe_buf"),
             ((256, 32768, 2048), "moe_flat"),
             ((256, 4096, 151936), "logits"), ((256, 4096, 49155), "logits"),
             ((128, 151936), "logits"), ((1, 8192, 4096), "resid"),
             ((3, 7), "other")]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("seq_shard,moe_flat", [(True, True),
                                                (False, False)])
def test_act_ctx_specs_match_reference(mesh, seq_shard, moe_flat,
                                       monkeypatch):
    """The reference's constraint, read by standing in for
    ``with_sharding_constraint``, against ``ActCtx.spec``."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s.spec)
    cfg = get_config("qwen3-8b")
    port = SH.ActCtx(cfg, _port_mesh(mesh), seq_shard_resid=seq_shard,
                     shard_moe_flat=moe_flat)
    ref = RSH.ActCtx(ref_get_config("qwen3-8b"), _ref_mesh(mesh),
                     seq_shard_resid=seq_shard, shard_moe_flat=moe_flat)
    for shape, name in ACT_CASES:
        want = tuple(ref(jax.ShapeDtypeStruct(shape, jnp.float32), name))
        assert port.spec(shape, name) == want, (shape, name)
    x = torch.zeros(3, 4)
    assert port(x, "resid") is x           # a plain tensor passes


def test_named_sharding_placements_and_shapes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh("multi")
    sh = SH.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.local_shape((64, 3, 32)) == (2, 3, 2)
    assert sh.global_shape((2, 3, 2)) == (64, 3, 32)
    assert SH.NamedSharding(mesh, ()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="does not split"):
        sh.local_shape((48, 3, 32))


# --- the reference's invariants (tests/test_sharding.py) on the port ----------

@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_param_specs_divisible(arch, mode):
    cfg = get_config(arch)
    mesh = _port_mesh("single")
    specs = dict(M.leaves(SH.param_specs(cfg, mesh, mode)))
    for path, pm in M.leaves(M.model_meta(cfg)):
        spec = specs[path]
        assert len(spec) <= len(pm.shape)
        used = [a for a in spec if a is not None]
        assert len(used) == len(set(used)), f"axis reused: {spec}"
        for dim, ax in zip(pm.shape, spec):
            if ax is not None:
                assert dim % mesh.shape[ax] == 0, (arch, pm.shape, spec)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_train_mode_fsdp_shards_embed_dim(arch):
    cfg = get_config(arch)
    spec = SH.spec_for_meta(cfg, M.model_meta(cfg)["embed"],
                            _port_mesh("single"), "train")
    assert "data" in spec


def test_batch_spec_divisibility_fallback():
    mesh = _port_mesh("single")
    assert SH._batch_spec(mesh, 256) == "data"
    assert SH._batch_spec(mesh, 1) is None
    mesh3 = _port_mesh("multi")
    assert SH._batch_spec(mesh3, 256) == ("pod", "data")
    assert SH._batch_spec(mesh3, 2) == "pod"
    assert SH.data_axes(mesh3) == ("pod", "data")
    assert SH.data_size(mesh3) == 32 and SH.data_size(mesh) == 16


def test_moe_experts_on_model_axis():
    specs = SH.param_specs(get_config("granite-moe-1b-a400m"),
                           _port_mesh("single"), "train")
    wi = specs["layers"]["moe"]["wi"]
    assert wi[1] == "model"             # (L, E, D, F): experts on model
    assert wi[3] is None                # per-expert mlp unsharded for MoE


def test_nondivisible_heads_replicate():
    specs = SH.param_specs(get_config("hymba-1.5b"), _port_mesh("single"),
                           "serve")
    assert "model" not in specs["layers"]["attn"]["wq"]


# --- the row-sharded superstep ------------------------------------------------

@pytest.mark.parametrize("S,R,N,capacity,mask_kind", [
    (16, 256, 8, 4, "random"), (5, 64, 8, 8, "on"), (7, 8, 40, 3, "off")])
def test_sharded_superstep_is_bit_identical(S, R, N, capacity, mask_kind):
    """Rows split into 2, 4 and 8 contiguous shards: routes, slots and the
    f32 thresholds equal one launch's and the reference's single-device
    program's, bit for bit."""
    slab = superstep_slab(S * 31 + R, S, R, N, mask_kind)
    want = [np.asarray(a) for a in ref_superstep_fn(capacity, 1)(*slab)]
    args = [torch.from_numpy(a) for a in slab]
    one = [t.numpy() for t in _superstep_fn(capacity, 1)(*args)]
    for w, o in zip(want, one):
        np.testing.assert_array_equal(o, w)
    for n in (2, 4, 8):
        got = _superstep_fn(capacity, n)(*args)
        for g, o, what in zip(got, one, ("routes", "slots", "ths")):
            assert g.dtype == torch.from_numpy(o).dtype, what
            np.testing.assert_array_equal(g.numpy(), o, err_msg=(n, what))
    with pytest.raises(ValueError, match="do not split"):
        _superstep_fn(capacity, 3)(*args)


def test_metropolis_with_the_fleet_in_row_shards_matches_unsharded():
    """The port's counterpart of the reference's
    ``test_metropolis_sharded_matches_single_device``: 8 row shards on the
    CPU.  Everything but the launch count is identical; each superstep is
    one launch a shard."""
    kw = dict(num_cameras=1024, duration_s=12.0)
    solo = run_query(metropolis(shard_fleet=False, **kw), device="cpu")
    split = run_query(metropolis(shard_fleet=8, **kw), device="cpu")
    launch_keys = ("kernel_launches", "launches_per_tick")
    assert {k: v for k, v in split.summary().items()
            if k not in launch_keys} == \
        {k: v for k, v in solo.summary().items() if k not in launch_keys}
    assert split.per_query_summary() == solo.per_query_summary()
    assert split.accuracy_timeline() == solo.accuracy_timeline()
    assert split.thresholds == solo.thresholds
    assert split.supersteps == solo.supersteps > 0
    assert split.kernel_launches == 8 * split.supersteps
    assert solo.kernel_launches == solo.supersteps
    with pytest.raises(ValueError, match="shard_fleet"):
        metropolis(shard_fleet=0, **kw)
