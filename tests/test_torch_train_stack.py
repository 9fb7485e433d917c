"""The training stack around the step, against the reference on the CPU:
the synthetic loader, npz checkpoints, the training launcher, and the
flash path's refusal of a gradient.

- ``host_batches`` gives the reference's numpy arrays exactly (tokens,
  labels, image embeddings, audio frames; every host shard; several
  steps); ``to_device`` keeps their dtypes.
- A checkpoint written by either package restores in the other, bit for
  bit, with the same keys (``jax.tree_util.keystr``'s spelling), for a
  parameter tree and a whole ``TrainState``.
- ``python -m repro_torch.launch.train --reduced --steps 3 --batch 2
  --seq 32 --checkpoint <tmp> --device cpu`` returns 0.
- ``flash_attention`` has no backward on either side: the port raises
  where autograd would need one (through ``layers.attention``,
  ``transformer.forward`` and the train step under
  ``attn_impl="flash"``), and the reference's jitted train step cannot
  differentiate its Pallas call (ROADMAP queue 3, item 11).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as RCK
from repro.configs import get_config as ref_get_config
from repro.data import loader as RL
from repro.optim import adamw as RA
from repro.train import steps as RST
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_config
from repro_torch.data import loader as TL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import train as LT
from repro_torch.models import layers as LY
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.train import steps as ST
from torch_model_cases import bridged

# --- the loader --------------------------------------------------------------


@pytest.mark.parametrize("arch,variant,lc,hosts", [
    ("qwen1.5-0.5b", "reduced", dict(global_batch=8, seq_len=32, seed=5), 1),
    ("qwen1.5-0.5b", "full", dict(global_batch=4, seq_len=64, seed=0), 1),
    ("qwen1.5-0.5b", "reduced", dict(global_batch=8, seq_len=32, seed=5), 2),
    ("internvl2-1b", "reduced", dict(global_batch=4, seq_len=32), 1),
    ("whisper-large-v3", "reduced", dict(global_batch=2, seq_len=16,
                                         noise=0.5), 1),
])
def test_host_batches_equal_the_references(arch, variant, lc, hosts):
    cfg, ref = get_config(arch), ref_get_config(arch)
    if variant == "reduced":
        cfg, ref = cfg.reduced(), ref.reduced()
    for host in range(hosts):
        got = TL.host_batches(cfg, TL.LoaderConfig(**lc), host_id=host,
                              num_hosts=hosts)
        want = RL.host_batches(ref, RL.LoaderConfig(**lc), host_id=host,
                               num_hosts=hosts)
        for _ in range(3):
            g, w = next(got), next(want)
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
    assert set(g) == {"tokens", "labels"} | (
        {"img_embeds"} if cfg.num_img_tokens else set()) | (
        {"audio_frames"} if cfg.is_encdec else set())
    assert g["tokens"].shape == (lc["global_batch"] // hosts,
                                 lc["seq_len"] - cfg.num_img_tokens)


def test_host_shards_differ_and_the_batch_must_split():
    cfg = get_config("qwen1.5-0.5b").reduced()
    lc = TL.LoaderConfig(global_batch=8, seq_len=32, seed=5)
    h0 = next(TL.host_batches(cfg, lc, host_id=0, num_hosts=2))
    h1 = next(TL.host_batches(cfg, lc, host_id=1, num_hosts=2))
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="3 hosts"):
        next(TL.host_batches(cfg, lc, num_hosts=3))


def test_to_device_keeps_values_and_dtypes():
    cfg = get_config("internvl2-1b").reduced()
    block = next(TL.host_batches(cfg, TL.LoaderConfig(2, 32)))
    out = TL.to_device(block, "cpu")
    assert out["tokens"].dtype == torch.int32
    assert out["img_embeds"].dtype == torch.float32
    for k, v in block.items():
        np.testing.assert_array_equal(out[k].numpy(), v)


# --- checkpoints --------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """The reduced qwen1.5-0.5b after one train step on both sides, from
    the reference's weights: (reference state, port state)."""
    ref_cfg = ref_get_config("qwen1.5-0.5b").reduced()
    jp, tp = bridged(ref_cfg, jax.random.PRNGKey(7), 3)
    block = next(RL.host_batches(ref_cfg, RL.LoaderConfig(2, 16)))
    jstate = RST.TrainState(jp, RA.init(jp), jnp.zeros((), jnp.int32))
    jstate, _ = jax.jit(RST.make_train_step(ref_cfg, RA.AdamWConfig()))(
        jstate, {k: jnp.asarray(v) for k, v in block.items()})
    cfg = get_config("qwen1.5-0.5b").reduced()
    tstate = ST.TrainState(tp, A.init(tp), torch.zeros((), dtype=torch.int32))
    tstate, _ = ST.make_train_step(cfg, A.AdamWConfig())(
        tstate, TL.to_device(block, "cpu"))
    return jstate, tstate


def _keys(path):
    with np.load(path) as data:
        return set(data.files)


def _specs(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


def test_port_checkpoint_restores_in_the_reference(trained, tmp_path):
    jstate, tstate = trained
    path = str(tmp_path / "port.npz")
    CK.save(path, tstate, step=1)
    assert not os.path.exists(path + ".tmp.npz")
    want = {jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert _keys(path) == want | {"__step__"}
    back = RCK.restore(path, _specs(jstate))
    assert isinstance(back, RST.TrainState)
    assert RCK.latest_step(path) == 1
    got = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    for k, v in CK._flatten(tstate).items():
        assert got[k].dtype == v.numpy().dtype, k
        np.testing.assert_array_equal(got[k], v.numpy())


def test_reference_checkpoint_restores_in_the_port(trained, tmp_path):
    jstate, tstate = trained
    path = str(tmp_path / "ref.npz")
    RCK.save(path, jstate, step=9)
    back = CK.restore(path, tstate)
    assert isinstance(back, ST.TrainState)
    assert isinstance(back.opt, A.AdamWState)
    assert CK.latest_step(path) == 9
    assert int(back.step) == 1 and back.step.dtype == torch.int32
    want = dict(M.leaves(jax.tree.map(np.asarray, jstate.params)))
    for name, got in M.leaves(back.params):
        np.testing.assert_array_equal(got.numpy(), want[name])
    wm = dict(M.leaves(jax.tree.map(np.asarray, jstate.opt.v)))
    for name, got in M.leaves(back.opt.v):
        np.testing.assert_array_equal(got.numpy(), wm[name])


def test_checkpoint_round_trip_casts_and_checks(trained, tmp_path):
    """Bitwise round trip; ``like`` may be specs (numpy or meta) and sets
    dtype and device; a misshapen entry raises; no step, no step."""
    _, tstate = trained
    path = str(tmp_path / "nested" / "ck.npz")
    CK.save(path, tstate.params)
    assert CK.latest_step(path) is None
    assert CK.latest_step(str(tmp_path / "missing.npz")) is None
    back = CK.restore(path, tstate.params)
    for (name, got), (_, want) in zip(M.leaves(back),
                                      M.leaves(tstate.params)):
        assert torch.equal(got, want), name
    like = M.tree_map(lambda t: torch.empty(t.shape, dtype=torch.float64,
                                            device="meta"), tstate.params)
    wide = CK.restore(path, like)
    assert wide["embed"].dtype == torch.float64
    assert wide["embed"].device.type == "cpu"
    spec = CK.restore(path, {"embed": np.zeros(tstate.params["embed"].shape,
                                               np.float16)})
    assert spec["embed"].dtype == torch.float16
    bad = dict(tstate.params, embed=tstate.params["embed"][:3])
    with pytest.raises(ValueError, match="embed"):
        CK.restore(path, bad)
    with pytest.raises(ValueError, match="no entry"):
        CK.restore(path, {"nope": torch.zeros(1)})
    CK.save(path, [torch.arange(3), {"a": np.float32(2.5)}], step=4)
    out = CK.restore(path, [torch.zeros(3, dtype=torch.int64),
                            {"a": torch.zeros(())}])
    assert out[0].tolist() == [0, 1, 2] and float(out[1]["a"]) == 2.5
    assert CK.latest_step(path) == 4


# --- the launcher -------------------------------------------------------------


def test_launcher_trains_reduced_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    assert LT.main(["--reduced", "--steps", "3", "--batch", "2", "--seq",
                    "32", "--checkpoint", path, "--log-every", "1",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("[train] qwen1.5-0.5b-smoke: 1.4M params, B=2 S=32 "
                      "steps=3")
    assert sum(line.startswith("  step ") for line in out) == 3
    assert out[-2] == f"[train] checkpoint -> {path}"
    assert out[-1].startswith("[train] done: final loss ")
    assert CK.latest_step(path) == 3
    cfg = get_config("qwen1.5-0.5b").reduced()
    like = LT.init_state(cfg, "cpu").params
    back = CK.restore(path, like)
    assert float((back["embed"] - like["embed"]).abs().max()) > 0


def test_launcher_functions_follow_the_reference():
    """The schedule warms up over max(steps // 10, 1) steps, remat is on,
    the weights are seed 0 on the asked device and the data are the
    loader's seed-0 stream."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    state = LT.init_state(cfg, "cpu")
    again = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(M.leaves(state.params), M.leaves(again)))
    assert int(state.step) == 0 and int(state.opt.count) == 0
    batch = next(LT.batches(cfg, 2, 16, "cpu"))
    want = next(RL.host_batches(ref_get_config("qwen1.5-0.5b").reduced(),
                                RL.LoaderConfig(2, 16)))
    np.testing.assert_array_equal(batch["labels"].numpy(), want["labels"])
    _, m = LT.make_step(cfg, lr=1e-2, steps=30)(state, batch)
    assert float(m["lr"]) == pytest.approx(1e-2 / 3)     # 1 of 3 warmup
    _, m = LT.make_step(cfg, lr=1e-2, steps=5)(state, batch)
    assert float(m["lr"]) == pytest.approx(1e-2)         # warmup of 1


def test_launcher_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal only happens on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.main(["--reduced", "--steps", "1"])


# --- flash has no backward ----------------------------------------------------


def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 8, 16), generator=g) for _ in range(3))
    return q.requires_grad_(requires_grad), k, v


def test_flash_attention_refuses_a_gradient():
    q, k, v = _qkv(True)
    for call in (FA.flash_attention, lambda *a: ops.flash_attention(
            *a, device="cpu")):
        with pytest.raises(RuntimeError, match="no backward"):
            call(q, k, v)
        with torch.no_grad():
            out = call(q, k, v)
        assert not out.requires_grad
        torch.testing.assert_close(call(*_qkv(False)),
                                   FA.flash_attention_torch(q.detach(), k, v),
                                   rtol=0, atol=0)


def test_flash_model_paths_refuse_a_gradient():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              attn_impl="flash")
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 8, cfg.num_heads, cfg.head_dim), generator=g)
    kv = torch.randn((1, 8, cfg.num_kv_heads, cfg.head_dim), generator=g)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        LY.attention(cfg, q.requires_grad_(), kv, kv, pos, pos)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.arange(8)[None] % cfg.vocab_size
    live = M.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with pytest.raises(RuntimeError, match="no backward"):
        T.forward(cfg, live, tokens)
    with torch.no_grad():                     # serving is untouched
        h, _ = T.forward(cfg, live, tokens)
    assert torch.isfinite(h).all()
    state = ST.TrainState(params, A.init(params),
                          torch.zeros((), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no backward"):
        ST.make_train_step(cfg, A.AdamWConfig())(
            state, {"tokens": tokens, "labels": tokens})


def test_reference_cannot_differentiate_flash_either():
    """The mirrored reference fault (ROADMAP queue 3, item 11): the jitted
    train step on the reduced qwen1.5-0.5b under flash fails in the
    Pallas call's JVP rule."""
    ref = dataclasses.replace(ref_get_config("qwen1.5-0.5b").reduced(),
                              attn_impl="flash")
    jp, _ = bridged(ref, jax.random.PRNGKey(7), 3)
    block = next(RL.host_batches(ref, RL.LoaderConfig(2, 16)))
    state = RST.TrainState(jp, RA.init(jp), jnp.zeros((), jnp.int32))
    with pytest.raises(AssertionError):
        jax.jit(RST.make_train_step(ref, RA.AdamWConfig()))(
            state, {k: jnp.asarray(v) for k, v in block.items()})
