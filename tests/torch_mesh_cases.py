"""The rank side of ``tests/test_torch_multidevice.py``'s multi-process
check (not a test file): one process of a CPU ``gloo`` group running the
port's train steps and its serve steps (under ``attn_impl="flash"``) on a
device mesh.

Imports nothing of JAX or the reference: each rank is a fresh process
(the ``spawn`` start method) that imports only the port.
"""
import dataclasses
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: the loader's global batch and sequence, the steps, the learning rate
BATCH, SEQ, STEPS, LR = 4, 32, 2, 1e-3
#: the serve check: prompts, prompt length, ring length, decode steps
PROMPTS, PROMPT_LEN, CACHE_LEN, DECODE = 2, 16, 24, 4


def plain_run(arch, hosts):
    """The same train and serve steps in one process with no mesh, the
    global batch the ``hosts`` host blocks in host order."""
    return run(arch, None, hosts)


def run(arch, mesh, hosts):
    """Train ``STEPS`` steps of ``arch``'s reduced config and serve one
    prefill and ``DECODE`` greedy decode steps, on ``mesh`` (a
    ``launch.mesh.Mesh``; None: plain tensors, the batch made of
    ``hosts`` host blocks).  Returns numpy
    (train metrics, final params, prefill and decode logits, tokens),
    gathered whole on every rank."""
    from repro_torch.configs import get_config
    from repro_torch.data.loader import (LoaderConfig, global_shard,
                                         host_batches, to_device)
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import meta as M
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw.AdamWConfig(lr=LR)
    ctx = SH.ActCtx(cfg, mesh) if mesh is not None else None
    if mesh is not None:
        data_rank, hosts = SH.data_index(mesh)
        blocks = [data_rank]
        params_t = SH.distribute_tree(params, SH.param_shardings(
            cfg, mesh, "train"))
    else:
        blocks, params_t = list(range(hosts)), params
    streams = [host_batches(cfg, LoaderConfig(global_batch=BATCH,
                                              seq_len=SEQ),
                            host_id=h, num_hosts=hosts) for h in blocks]
    state = ST.TrainState(params_t, adamw.init(params_t),
                          torch.zeros((), dtype=torch.int32))
    step = ST.make_train_step(cfg, opt, remat=True, ctx=ctx)
    metrics = []
    for _ in range(STEPS):
        parts = [next(s) for s in streams]
        blk = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        if mesh is None:
            batch = to_device(blk, "cpu")
        else:
            batch = global_shard(blk, SH.batch_specs(cfg, mesh, BATCH, blk),
                                 "cpu")
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = {p: t.numpy() for p, t in M.leaves(SH.full_tree(state.params))}

    # serve under the flash path: on the mesh each shard launches it on
    # its own heads
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    ctx = SH.ActCtx(cfg, mesh) if mesh is not None else None
    sparams = params if mesh is None else SH.distribute_tree(
        params, SH.param_shardings(cfg, mesh, "serve"))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)).astype(np.int32))
    if mesh is not None:
        sh = SH.batch_specs(cfg, mesh, PROMPTS, {"t": prompts})["t"]
        prompts = SH.distribute(prompts, sh)
    prefill = ST.make_prefill_step(cfg, cache_len=CACHE_LEN, ctx=ctx)
    decode = ST.make_decode_step(cfg, ctx=ctx)
    logits, cache = prefill(sparams, {"tokens": prompts})
    outs, toks = [_whole(logits)], []
    for _ in range(DECODE):
        # greedy over the gathered logits, the token batch-sharded again
        tok = torch.from_numpy(np.argmax(outs[-1], axis=-1).astype(np.int32))
        toks.append(tok.numpy())
        if mesh is not None:
            tok = SH.distribute(tok, sh)
        logits, cache = decode(sparams, cache, tok)
        outs.append(_whole(logits))
    return metrics, final, np.stack(outs), np.stack(toks)


def _whole(t):
    from repro_torch.distributed import sharding as SH
    return (t.full_tensor() if SH.is_dtensor(t) else t).numpy()


def worker(rank, world, port, arch, shape, queue):
    """Rank ``rank`` of a ``world``-process gloo group on a ("data",
    "model") mesh of ``shape``: runs ``run`` and, on rank 0, puts the
    result on ``queue`` (any rank that fails puts its traceback there)."""
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = run(arch, Mesh(("data", "model"), shape, "cpu"), None)
    except Exception:
        queue.put(("failed", rank, traceback.format_exc()))
        raise
    else:
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()
