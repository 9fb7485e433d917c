"""Production-shape dry-run: every (arch x input-shape x mesh) step on fake
tensors.

For each combination this builds the step the launcher would run
(train_step / prefill_step / decode_step, ``train/steps.py``) on the
production mesh (``launch.mesh``: 256 or 512 devices), with the
parameters, AdamW state, caches and inputs as DTensors under the sharding
rules (``distributed.sharding``), and runs it once with no allocation:

  * a fake process group of ``chips`` ranks (backend ``"fake"``), whose
    collectives move nothing, this process being rank 0;
  * every tensor a ``FakeTensorMode`` tensor on the card's device
    (``--device cpu``: the CPU's), each DTensor holding rank 0's shard.

It records, per device (rank 0):

  * ``memory.peak_bytes`` — the peak of live tensor bytes over the step,
    arguments included (``torch.distributed._tools.mem_tracker.
    MemTracker``), beside one card's memory (``fits``);
  * ``cost.flops`` — FLOPs of the operations on the local shards
    (``torch.utils.flop_counter``'s formulas).  A ``FlopCounterMode``
    around DTensor operations would count their global shapes; here the
    counter sees only the local operations DTensor dispatches;
  * ``collectives`` — the collectives DTensor issued, by kind: count and
    result bytes (an all-reduce counted twice, reduce then broadcast, as
    the reference counts it), their ``total_bytes``, and
    ``torch.distributed.tensor.debug.CommDebugMode``'s counts beside them;
  * ``window``, ``chips``, ``params``.

The record keeps the reference's keys (``cost.flops`` per device,
``collectives.total_bytes``), so ``roofline.load_dryrun`` reads either
package's records.  The step runs in this process; the CLI is one process
per call, as the fake group is process-global.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both   # -> dryrun_out/
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape,
                                        attn_cache_len, decode_window,
                                        input_specs)
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import meta as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import steps as ST

#: one card's memory where torch finds no card: the H100 80GB HBM3's
#: 80 GB (NVIDIA data sheet), a stated value, not a reading
H100_MEMORY_BYTES = 80e9

#: the funcol operations DTensor issues, by the reference's HLO names
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "permute_tensor": "collective-permute"}


class _LocalCounter:
    """A dispatch mode counting the operations on plain (local) tensors:
    FLOPs by ``flop_counter``'s formulas and collectives by kind, with
    their result bytes.  It declines DTensor operations, so DTensor
    dispatches them and the mode sees the local operations they become."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        self.flops = 0
        self.coll: Dict[str, Dict[str, int]] = {
            k: {"count": 0, "bytes": 0} for k in COLLECTIVES.values()}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(SH.is_dtensor_type(t) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                packet = func.overloadpacket
                if packet in flop_registry:
                    counter.flops += int(flop_registry[packet](
                        *args, **kwargs, out_val=out))
                kind = COLLECTIVES.get(packet.__name__)
                if kind is not None and isinstance(out, torch.Tensor):
                    nbytes = out.numel() * out.element_size()
                    counter.coll[kind]["count"] += 1
                    counter.coll[kind]["bytes"] += nbytes * (
                        2 if kind == "all-reduce" else 1)
                return out

        self.mode = Mode()

    def collectives(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.coll)
        out["total_bytes"] = sum(v["bytes"] for v in self.coll.values())
        return out


@contextlib.contextmanager
def _quiet_bookkeeping():
    """DTensor's sharding propagation picks each new operation's
    placements and derives its global output shape by running it once on
    global-shape fake tensors, and a strided shard's layout is worked out
    on index tensors.  That is bookkeeping, not the step's work (and some
    of it reads tensor values): run it with the dispatch modes (the fake
    mode, the counters, the memory tracker) set aside."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    sites = [(ShardingPropagator, "propagate_op_sharding_non_cached", True),
             (placement_types._StridedShard, "local_shard_size_and_offset",
              False)]
    saved = []
    for cls, name, required in sites:
        orig = cls.__dict__.get(name)
        if orig is None:
            if required:
                raise RuntimeError(
                    f"this torch ({torch.__version__}) has no "
                    f"{cls.__name__}.{name}: the dry-run cannot keep "
                    f"DTensor's bookkeeping out of its counts")
            continue

        def quiet(*args, __orig=orig, **kwargs):
            with _disable_current_modes():
                return __orig(*args, **kwargs)

        saved.append((cls, name, orig))
        setattr(cls, name, quiet)
    try:
        yield
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def init_fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake_tree(tree, shardings, device):
    """Meta/abstract leaves -> DTensors whose rank-0 shard is a tensor of
    the local shape on ``device`` (fake, under the caller's mode)."""
    def leaf(t, sh):
        local = torch.empty(sh.local_shape(t.shape), dtype=t.dtype,
                            device=device)
        return SH.from_local(local, sh, t.shape)
    return M.tree_map(leaf, tree, shardings)


def build_program(cfg: ModelConfig, shape: InputShape, mesh, device,
                  dtype=torch.bfloat16, overrides=None):
    """Returns (fn, args): the step and its DTensor arguments, made under
    the caller's ``FakeTensorMode`` on ``device``.

    ``overrides`` (the reference's perf-iteration knobs):
      micro: int            gradient-accumulation factor (train)
      kv_dtype: str         'int8' quantized KV cache (decode)
      remat_policy: str     'dots' | 'dots_no_batch' checkpoint policy
      no_seq_shard: bool    disable sequence-parallel residual sharding
      no_moe_flat_shard: bool
      serve_1d: bool        1-D TP weights in serve mode
      quant_weights: bool   int8 weights in serve mode
    """
    ov = overrides or {}
    if ov.get("kv_dtype"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype=ov["kv_dtype"])
    if cfg.attn_impl == "flash":
        raise ValueError(f"{cfg.name}: attn_impl='flash' launches a CUDA "
                         f"kernel on raw pointers, which fake tensors do not "
                         f"have; dry-run the chunked path")
    mode = "train" if shape.kind == "train" else "serve"
    ctx = SH.ActCtx(cfg, mesh,
                    seq_shard_resid=not ov.get("no_seq_shard", False),
                    shard_moe_flat=not ov.get("no_moe_flat_shard", False))
    pspecs = SH.param_shardings(cfg, mesh, mode,
                                force_1d_serve=ov.get("serve_1d", False))
    params_abs = M.abstract_params(cfg, dtype)
    if ov.get("quant_weights") and mode == "serve":
        from repro_torch.distributed import quantize as QZ
        pspecs = QZ.quantized_shardings(pspecs, params_abs, cfg, mesh)
        params_abs = QZ.abstract_quantized(params_abs, cfg)
    params = _fake_tree(params_abs, pspecs, device)
    batch_abs = input_specs(cfg, shape, dtype)
    batch = _fake_tree(batch_abs, SH.batch_specs(
        cfg, mesh, shape.global_batch, batch_abs), device)
    repl = SH.NamedSharding(mesh, ())

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        micro = ov.get("micro") or ST.default_microbatches(
            cfg, shape.global_batch, SH.data_size(mesh))
        fn = ST.make_train_step(cfg, opt_cfg, remat=True,
                                microbatches=micro,
                                remat_policy=ov.get("remat_policy"), ctx=ctx)
        opt_abs = adamw.abstract_state(params_abs)
        opt = adamw.AdamWState(
            count=_fake_tree({"c": opt_abs.count}, {"c": repl}, device)["c"],
            m=_fake_tree(opt_abs.m, pspecs, device),
            v=_fake_tree(opt_abs.v, pspecs, device))
        step = _fake_tree({"s": torch.empty((), dtype=torch.int32,
                                            device="meta")},
                          {"s": repl}, device)["s"]
        return fn, (ST.TrainState(params, opt, step), batch)

    window = decode_window(cfg, shape)
    cache_len = attn_cache_len(cfg, shape)
    if shape.kind == "prefill":
        fn = ST.make_prefill_step(cfg, cache_len=cache_len, window=window,
                                  ctx=ctx)
        return fn, (params, batch)

    fn = ST.make_decode_step(cfg, window=window, ctx=ctx)
    cache_abs = T.make_cache(cfg, shape.global_batch, cache_len,
                             dtype=dtype, abstract=True)
    cache = _fake_tree(cache_abs, SH.cache_specs(
        cfg, mesh, shape.global_batch, cache_abs), device)
    return fn, (params, cache, batch["token"])


def card_memory_bytes() -> tuple:
    """(bytes, source) of one card's memory."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                f"torch.cuda.get_device_properties(0).total_memory "
                f"({torch.cuda.get_device_name(0)})")
    return H100_MEMORY_BYTES, "H100 80GB HBM3 data sheet: 80 GB (stated)"


def dryrun_one(arch: str, shape_name: str, mesh_kind: str,
               verbose: bool = True, overrides=None,
               device="cuda") -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    dev = torch.device(device)
    mesh = MESH.make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                     device_type=dev.type)
    init_fake_group(mesh.size)
    mesh.device_mesh                    # built outside the fake mode
    t0 = time.time()
    counter = _LocalCounter()
    comm = CommDebugMode()
    with FakeTensorMode(allow_non_fake_inputs=False), \
            _quiet_bookkeeping():
        fn, args = build_program(cfg, shape, mesh, dev, overrides=overrides)
        t_build = time.time() - t0
        mem = MemTracker()
        mem.track_external(*_leaves(args))
        with mem, comm, counter.mode:
            fn(*args)
    t_run = time.time() - t0 - t_build
    snap = mem.get_tracker_snapshot("peak")
    peak = float(sum(v["Total"] for v in snap.values()))
    arg_bytes = float(sum(_local_bytes(t) for t in _leaves(args)))
    card_bytes, card_src = card_memory_bytes()
    coll = counter.collectives()
    coll["comm_debug_counts"] = {str(k): v for k, v in
                                 comm.get_comm_counts().items()}
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": MESH.chips(mesh), "device": str(dev),
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "memory": {"argument_bytes": arg_bytes, "peak_bytes": peak,
                   "card_bytes": card_bytes, "card_bytes_source": card_src,
                   "fits": peak <= card_bytes},
        "cost": {"flops": float(counter.flops),
                 "flops_counted_on": "rank 0's local shards (per device)"},
        "collectives": coll,
        "window": decode_window(cfg, shape),
        "overrides": {k: v for k, v in (overrides or {}).items() if v},
    }
    if verbose:
        print(f"[dryrun] {arch:26s} {shape_name:12s} {mesh_kind:6s} "
              f"chips={rec['chips']:3d} perdev_flops={counter.flops:.3e} "
              f"peak_dev_bytes={peak / 2**30:.2f}GiB "
              f"(card {card_bytes / 2**30:.1f}GiB, "
              f"fits={rec['memory']['fits']}) "
              f"coll={coll['total_bytes'] / 2**20:.1f}MiB "
              f"(build {t_build:.1f}s run {t_run:.1f}s)")
        print("  collectives:", {k: v for k, v in coll.items()
                                 if isinstance(v, dict) and v.get("count")})
    return rec


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _local_bytes(t: torch.Tensor) -> int:
    local = t.to_local() if SH.is_dtensor(t) else t
    return local.numel() * local.element_size()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--out", default="dryrun_out",
                    help="directory for the JSON records")
    ap.add_argument("--micro", type=int, default=None,
                    help="override gradient-accumulation factor")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="quantized KV cache")
    ap.add_argument("--remat-policy", default=None,
                    choices=["dots", "dots_no_batch"])
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="disable sequence-parallel residuals")
    ap.add_argument("--no-moe-flat-shard", action="store_true",
                    help="keep MoE dispatch tensors batch-sharded only")
    ap.add_argument("--serve-1d", action="store_true",
                    help="force 1-D TP weights in serve mode (no FSDP gathers)")
    ap.add_argument("--quant-weights", action="store_true",
                    help="serve with int8 weights (per-channel scales)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors claim")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[dryrun] torch finds no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    overrides = {"micro": args.micro, "kv_dtype": args.kv_dtype,
                 "remat_policy": args.remat_policy,
                 "no_seq_shard": args.no_seq_shard,
                 "no_moe_flat_shard": args.no_moe_flat_shard,
                 "serve_1d": args.serve_1d,
                 "quant_weights": args.quant_weights}

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                try:
                    rec = dryrun_one(arch, shape, mk, overrides=overrides,
                                     device=args.device)
                except Exception as e:      # noqa: BLE001 — report, go on
                    failures.append((arch, shape, mk, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape} {mk}: {e!r}",
                          file=sys.stderr)
                    continue
                os.makedirs(args.out, exist_ok=True)
                fname = f"{arch.replace('/', '_')}__{shape}__{mk}.json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:", file=sys.stderr)
        for f in failures:
            print("  ", *f, file=sys.stderr)
        return 1
    print("\nAll dry-runs ran.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
