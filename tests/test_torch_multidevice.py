"""The port's multi-device path on the CPU: real cross-device arithmetic
on a 4-process ``gloo`` group.

Four processes (``tests/torch_mesh_cases.py``) on a ("data"=2,
"model"=2) mesh take two train steps of reduced qwen1.5-0.5b (and on a
(1, 4) mesh of reduced chatglm3-6b, whose 2 KV heads the 4 query-head
shards split in prefill, and whose context-parallel cache each decode
step reads with the shards' log-sum-exp merge) with DTensor parameters
and AdamW state placed by the
train rules, ``ActCtx`` on and each rank's batch block made its part of
the global batch by ``global_shard``; then one prefill (flash attention,
each shard on its own heads) and four greedy decode steps under the
serve rules.  Loss and ``grad_norm`` must be within ``MESH_RTOL`` = 1e-5
(relative) of the same steps in one process with no mesh (measured: 0
and 8e-7), the parameters after the steps within 2 lr a step (Adam's
first steps move an entry whose gradient cancels to a few ulps by about
lr on one side only; 5.9e-5 at lr 1e-3), the prefill and decode logits
within ``LOGIT_ATOL`` = 1e-4 (1.9e-6) and the greedy tokens equal.
Beside it, in this process: the card's configuration, a (1, 1) host mesh
over a one-rank group, bit for bit the plain train step;
``global_shard`` with no group a plain ``to_device``; ``launch/train.py
--mesh host`` printing the losses of the run without a mesh; and
``launch/multihost.py``'s bring-up from explicit flags.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_cases as MC
from repro_torch.configs import get_config
from repro_torch.data.loader import LoaderConfig, global_shard, host_batches
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import meta as M
from repro_torch.optim import adamw
from repro_torch.train import steps as ST

_free_port = MC._free_port


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", (2, 2)),
                                        ("chatglm3-6b", (1, 4))])
def test_four_process_mesh_matches_one_process(arch, shape):
    MC.check(arch, shape)


@pytest.fixture
def one_rank_group():
    """A one-process gloo group, destroyed after the test (the pytest
    worker runs other files afterwards)."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_global_shard_without_a_group_is_to_device():
    block = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)}
    out = global_shard(block, None, "cpu")
    assert type(out["tokens"]) is torch.Tensor
    np.testing.assert_array_equal(out["tokens"].numpy(), block["tokens"])


def test_host_mesh_step_equals_plain(one_rank_group):
    """The card's configuration on the CPU: a (1, 1) host mesh over one
    rank, DTensor parameters and ``ActCtx``: one train step bit for bit
    the plain step's."""
    torch.set_num_threads(1)
    cfg = get_config("qwen1.5-0.5b").reduced()
    mesh = MESH.make_host_mesh("cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    block = next(host_batches(cfg, LoaderConfig(global_batch=2, seq_len=16)))
    opt = adamw.AdamWConfig(lr=1e-3)
    plain = ST.make_train_step(cfg, opt)(
        ST.TrainState(params, adamw.init(params),
                      torch.zeros((), dtype=torch.int32)),
        {k: torch.from_numpy(v) for k, v in block.items()})
    dp = SH.distribute_tree(params, SH.param_shardings(cfg, mesh, "train"))
    batch = global_shard(block, SH.batch_specs(cfg, mesh, 2, block), "cpu")
    assert SH.is_dtensor(batch["tokens"]) and SH.is_dtensor(dp["embed"])
    state, m = ST.make_train_step(cfg, opt, ctx=SH.ActCtx(cfg, mesh))(
        ST.TrainState(dp, adamw.init(dp),
                      torch.zeros((), dtype=torch.int32)), batch)
    assert SH.is_dtensor(state.params["embed"])
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == float(plain[1][k]), k
    for (p, a), (_, b) in zip(M.leaves(SH.full_tree(state.params)),
                              M.leaves(plain[0].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=p)


def test_train_launcher_on_the_host_mesh(capsys):
    """``launch/train.py --mesh host`` (a one-process group of its own,
    closed at the end) prints the losses of the run without a mesh."""
    from repro_torch.launch import train
    args = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--device", "cpu"]
    assert train.main(args) == 0
    plain = capsys.readouterr().out
    assert train.main(args + ["--mesh", "host"]) == 0
    meshed = capsys.readouterr().out
    assert not dist.is_initialized()
    assert "mesh host: {'data': 1, 'model': 1}" in meshed

    def losses(out):
        return [line.split("gnorm")[0] for line in out.splitlines()
                if line.strip().startswith("step")]
    assert losses(meshed) == losses(plain) and len(losses(plain)) == 2


def test_multihost_bring_up_on_the_cpu(capsys, monkeypatch):
    """``multihost.main`` with explicit flags joins a one-process gloo
    group, prints the process and the mesh's shape, and leaves the group;
    without flags or torchrun's environment it refuses."""
    from repro_torch.launch import multihost
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize(device="cpu")
    assert multihost.main(["--coordinator", f"localhost:{_free_port()}",
                           "--num-processes", "1", "--process-id", "0",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "process 0/1 (gloo)" in out
    assert "mesh: {'data': 16, 'model': 16}" in out
    assert not dist.is_initialized()
