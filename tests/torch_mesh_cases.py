"""The rank side of the multi-process mesh checks (not a test file:
``tests/test_torch_multidevice.py``, ``test_torch_mesh_moe.py``,
``test_torch_mesh_families.py``): one process of a CPU ``gloo`` group
running the port's train steps and its serve steps (under
``attn_impl="flash"``) on a device mesh, and ``check``, which holds the
gathered result against the same run in one process.

A case is an ``ASSIGNED`` name, reduced, or one of ``CASES``' variants.
Imports nothing of JAX or the reference: each rank is a fresh process
(the ``spawn`` start method) that imports only the port.
"""
import dataclasses
import multiprocessing
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: the loader's global batch and sequence, the steps, the learning rate
BATCH, SEQ, STEPS, LR = 4, 32, 2, 1e-3
#: the serve check: prompts, prompt length, ring length, decode steps
PROMPTS, PROMPT_LEN, CACHE_LEN, DECODE = 2, 16, 24, 4
#: loss and grad_norm relative, prefill and decode logits absolute
MESH_RTOL = 1e-5
LOGIT_ATOL = 1e-4

#: variants of the reduced configs: (arch, config changes, ``ActCtx``
#: keywords).  granite-moe under ``--no-moe-flat-shard``'s setting, at a
#: capacity factor of 0.5 so that its train steps and prefill drop
#: expert choices over capacity.  "uneven" heads do not divide a 4-way "model" axis: hymba's
#: 6 attention heads over 3 KV heads (a context-parallel cache) beside 6
#: SSM heads of 64 (the SSD split on its head dim), whisper's 6 heads (a
#: context-parallel self-attention cache, and its 24-frame cross cache
#: split on the frames too).  internvl2 with a vocabulary of 514, which
#: does not divide the axis: its logits split their sequence, image
#: prefix and all, and the loss picks each shard's own labels; and with
#: 20 image tokens too, so that on 4 shards of 8 positions the prefix
#: fills two shards and ends inside the third
CASES = {
    "granite-moe-1b-a400m:no-moe-flat": ("granite-moe-1b-a400m", dict(
        capacity_factor=0.5), {"shard_moe_flat": False}),
    "hymba-1.5b:uneven": ("hymba-1.5b", dict(
        d_model=192, num_heads=6, num_kv_heads=3, head_dim=32,
        ssm_headdim=64), {}),
    "whisper-large-v3:uneven": ("whisper-large-v3", dict(
        d_model=192, num_heads=6, num_kv_heads=6, head_dim=32), {}),
    "internvl2-1b:odd-vocab": ("internvl2-1b", dict(vocab_size=514), {}),
    "internvl2-1b:long-prefix": ("internvl2-1b", dict(
        vocab_size=514, num_img_tokens=20), {}),
}


def case_config(case):
    """(the reduced config of ``case``, its ``ActCtx`` keywords)."""
    from repro_torch.configs import get_config
    arch, changes, ctx_kw = CASES.get(case, (case, {}, {}))
    return dataclasses.replace(get_config(arch).reduced(), **changes), \
        ctx_kw


def plain_run(arch, hosts):
    """The same train and serve steps in one process with no mesh, the
    global batch the ``hosts`` host blocks in host order."""
    return run(arch, None, hosts)


def run(arch, mesh, hosts):
    """Train ``STEPS`` steps of ``arch``'s reduced config (a ``case``)
    and serve one prefill and ``DECODE`` greedy decode steps, on ``mesh``
    (a ``launch.mesh.Mesh``; None: plain tensors, the batch made of
    ``hosts`` host blocks).  Returns numpy (train metrics: loss,
    grad_norm and moe_aux a step; final params; prefill and decode
    logits; tokens; the MoE's dropped expert choices a dispatch call,
    summed over the mesh's rows), gathered whole on every rank."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import meta as M
    from repro_torch.optim import adamw

    cfg, ctx_kw = case_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw.AdamWConfig(lr=LR)
    ctx = SH.ActCtx(cfg, mesh, **ctx_kw) if mesh is not None else None
    drops = []
    dispatch = L._moe_dispatch

    def tapped(cfg_, x, topw, topi):
        out = dispatch(cfg_, x, topw, topi)
        drops.append(topi.numel() - int((out[0] < x.shape[1]).sum()))
        return out
    L._moe_dispatch = tapped
    try:
        out = _run(cfg, ctx_kw, mesh, hosts, params, opt, ctx)
    finally:
        L._moe_dispatch = dispatch
    if mesh is not None:        # each data shard's rows, once
        coord = mesh.device_mesh.get_coordinate()
        model = mesh.axis_names.index("model")
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (coord[model], drops))
        drops = [sum(col) for col in zip(*[d for m, d in every if m == 0])]
    return out + (np.asarray(drops),)


def _run(cfg, ctx_kw, mesh, hosts, params, opt, ctx):
    """``run``'s train and serve steps."""
    from repro_torch.data.loader import (LoaderConfig, global_shard,
                                         host_batches, to_device)
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import meta as M
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
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
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["moe_aux"])))
    final = {p: t.numpy() for p, t in M.leaves(SH.full_tree(state.params))}

    # serve under the flash path: on the mesh each shard launches it on
    # its own heads
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    ctx = SH.ActCtx(cfg, mesh, **ctx_kw) if mesh is not None else None
    sparams = params if mesh is None else SH.distribute_tree(
        params, SH.param_shardings(cfg, mesh, "serve"))
    rng = np.random.default_rng(3)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (
        PROMPTS, PROMPT_LEN)).astype(np.int32)}
    if cfg.num_img_tokens:      # the stub image embeddings and frames
        inputs["img_embeds"] = rng.normal(0, 0.1, (
            PROMPTS, cfg.num_img_tokens, 1024)).astype(np.float32)
    if cfg.is_encdec:
        inputs["audio_frames"] = rng.normal(0, 0.1, (
            PROMPTS, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    if mesh is not None:
        shs = SH.batch_specs(cfg, mesh, PROMPTS, inputs)
        inputs = {k: SH.distribute(v, shs[k]) for k, v in inputs.items()}
        sh = shs["tokens"]
    prefill = ST.make_prefill_step(cfg, cache_len=CACHE_LEN, ctx=ctx)
    decode = ST.make_decode_step(cfg, ctx=ctx)
    logits, cache = prefill(sparams, inputs)
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check(case, shape, timeout=240):
    """``case`` on a 4-process gloo group over a ("data", "model") mesh
    of ``shape`` against the same run in this process with no mesh: loss,
    grad_norm and the MoE's aux loss within ``MESH_RTOL`` (relative), the
    parameters after the steps within 2 lr a step, the prefill and decode
    logits within ``LOGIT_ATOL``, the greedy tokens and the MoE's dropped
    choices a dispatch call equal."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker,
                         args=(r, 4, port, case, shape, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    # the one-process run meanwhile, on one thread as each rank runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = plain_run(case, hosts=shape[0])
        out = queue.get(timeout=timeout)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert out[0] != "failed", f"rank {out[1]}:\n{out[2]}"
    metrics, final, logits, tokens, drops = out
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    want_m, want_final, want_logits, want_tokens, want_drops = want
    for got, want in zip(metrics, want_m):
        for g, w in zip(got, want):
            assert abs(g - w) <= MESH_RTOL * abs(w), (got, want)
    assert set(final) == set(want_final)
    for path, w in want_final.items():
        gap = float(np.abs(final[path] - w).max())
        assert gap <= 2 * LR * STEPS, (path, gap)
    assert float(np.abs(logits - want_logits).max()) <= LOGIT_ATOL
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_array_equal(drops, want_drops)
    return out


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
