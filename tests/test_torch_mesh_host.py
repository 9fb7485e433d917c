"""Every ``ASSIGNED`` config on the one-card mesh, on the CPU: the
configuration ``chip_smoke.py`` runs on the card, a (1, 1) ("data",
"model") mesh over a one-rank group, with DTensor parameters and
``ActCtx``.

``launch/train.py --mesh host`` prints the losses of the run without a
mesh, and the serve steps (``make_prefill_step``, ``make_decode_step``
with ``ctx``) give the plain path's logits within ``LOGIT_ATOL`` and its
greedy tokens, for all ten reduced configs: the MoE's row-local dispatch,
the SSD's local-shard path and the stub frames and image embeddings all
run on the mesh, where every split degenerates to one shard.  AdamW's
moments and the microbatch accumulators take the parameters' layout.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_cases as MC
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import meta as M
from repro_torch.train import steps as ST


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the mesh tests' ranks run (the pytest
    worker's own setting restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_rank_group():
    """A one-process gloo group, destroyed after the test (the pytest
    worker runs other files afterwards)."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{MC._free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_launcher_on_the_host_mesh(arch, capsys):
    from repro_torch.launch import train
    args = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "32", "--log-every", "1", "--device", "cpu"]
    assert train.main(args) == 0
    plain = capsys.readouterr().out
    assert train.main(args + ["--mesh", "host"]) == 0
    meshed = capsys.readouterr().out
    assert not dist.is_initialized()

    def losses(out):
        return [line.split("gnorm")[0] for line in out.splitlines()
                if line.strip().startswith("step")]
    assert losses(meshed) == losses(plain) and len(losses(plain)) == 2


@pytest.mark.parametrize("arch", ASSIGNED)
def test_serve_steps_on_the_host_mesh(arch, one_rank_group):
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="flash")
    mesh = MESH.make_host_mesh("cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    inputs = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    if cfg.num_img_tokens:
        inputs["img_embeds"] = torch.from_numpy(rng.normal(0, 0.1, (
            2, cfg.num_img_tokens, 1024)).astype(np.float32))
    if cfg.is_encdec:
        inputs["audio_frames"] = torch.from_numpy(rng.normal(0, 0.1, (
            2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    runs = {}
    for name in ("plain", "mesh"):
        ctx = SH.ActCtx(cfg, mesh) if name == "mesh" else None
        p, batch = params, inputs
        if ctx is not None:
            p = SH.distribute_tree(params, SH.param_shardings(
                cfg, mesh, "serve"))
            shs = SH.batch_specs(cfg, mesh, 2, inputs)
            batch = {k: SH.distribute(v, shs[k]) for k, v in inputs.items()}
        logits, cache = ST.make_prefill_step(cfg, cache_len=24, ctx=ctx)(
            p, batch)
        decode = ST.make_decode_step(cfg, ctx=ctx)
        outs, toks = [MC._whole(logits)], []
        for _ in range(3):
            tok = torch.from_numpy(outs[-1].argmax(-1).astype(np.int32))
            toks.append(tok.numpy())
            if ctx is not None:
                tok = SH.distribute(tok, shs["tokens"])
            logits, cache = decode(p, cache, tok)
            assert SH.is_dtensor(logits) == (ctx is not None)
            outs.append(MC._whole(logits))
        runs[name] = (np.stack(outs), np.stack(toks))
    assert float(np.abs(runs["mesh"][0] - runs["plain"][0]).max()) <= \
        MC.LOGIT_ATOL
    np.testing.assert_array_equal(runs["mesh"][1], runs["plain"][1])


def test_microbatch_step_keeps_the_parameters_layout(one_rank_group):
    """AdamW's moments and the microbatch loop's gradient accumulators
    are laid out as the parameters (DTensors of their placements, not
    plain tensors of their global shape, which would put 4 bytes a
    parameter on every device): a step at microbatches 2 on the mesh
    gives the plain step's loss and grad_norm."""
    from repro_torch.data.loader import (LoaderConfig, global_shard,
                                         host_batches)
    from repro_torch.optim import adamw
    cfg = get_config("internvl2-1b").reduced()
    mesh = MESH.make_host_mesh("cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    block = next(host_batches(cfg, LoaderConfig(global_batch=4, seq_len=16)))
    opt = adamw.AdamWConfig(lr=1e-3)
    dp = SH.distribute_tree(params, SH.param_shardings(cfg, mesh, "train"))
    moments = adamw.init(dp)
    for (_, m), (_, p) in zip(M.leaves(moments.m), M.leaves(dp)):
        assert SH.is_dtensor(m) and m.placements == p.placements
        assert m.dtype == torch.float32
    runs = []
    for p, ctx in ((params, None), (dp, SH.ActCtx(cfg, mesh))):
        batch = global_shard(block, SH.batch_specs(cfg, mesh, 4, block),
                             "cpu") if ctx else \
            {k: torch.from_numpy(v) for k, v in block.items()}
        _, m = ST.make_train_step(cfg, opt, microbatches=2, ctx=ctx)(
            ST.TrainState(p, adamw.init(p),
                          torch.zeros((), dtype=torch.int32)), batch)
        runs.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(runs[1], runs[0], rtol=MC.MESH_RTOL)


@pytest.mark.parametrize("count", ["plain", "dtensor"])
def test_adamw_updates_dtensor_leaves_on_their_shards(count, one_rank_group):
    """``adamw.apply`` on DTensor leaves gives the plain update bit for
    bit, keeps each leaf's placements, and takes gradients in another
    layout (here replicated) and a replicated DTensor step count (as the
    dry-run lays out its AdamW state)."""
    from repro_torch.optim import adamw, schedules
    cfg = get_config("qwen1.5-0.5b").reduced()
    mesh = MESH.make_host_mesh("cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    grads = M.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                       params)
    opt = adamw.AdamWConfig(lr=1e-3, schedule=schedules.cosine_with_warmup(
        2, 10))
    state = adamw.init(params)
    state = state._replace(count=torch.full((), 3, dtype=torch.int32))
    want = adamw.apply(opt, grads, state, params)

    shard = SH.param_shardings(cfg, mesh, "train")
    repl = SH.NamedSharding(mesh, ())
    dp = SH.distribute_tree(params, shard)
    dstate = adamw.init(dp)
    n = state.count if count == "plain" else SH.distribute(state.count, repl)
    got = adamw.apply(opt, M.tree_map(lambda g: SH.distribute(g, repl),
                                      grads), dstate._replace(count=n), dp)
    for new, new_d in ((want[0], got[0]), (want[1].m, got[1].m),
                       (want[1].v, got[1].v)):
        for (path, w), (_, p), (_, d) in zip(M.leaves(new), M.leaves(dp),
                                              M.leaves(new_d)):
            assert d.placements == p.placements, path
            assert torch.equal(d.full_tensor(), w), path
    assert float(got[2]["lr"]) == float(want[2]["lr"])
    assert float(got[2]["grad_norm"]) == float(want[2]["grad_norm"])
