"""The SSM, hybrid, encoder-decoder and image-prefix families on a device
mesh, on the CPU: a 4-process ``gloo`` group (``tests/torch_mesh_cases.py``)
takes two train steps, one prefill and four greedy decode steps of each,
against the same run in one process: loss and grad_norm within
``MESH_RTOL`` = 1e-5 (relative), logits within ``LOGIT_ATOL`` = 1e-4,
tokens equal.

* reduced mamba2-2.7b on (2, 2): the SSD on local heads (16 over 2);
* hymba with 6 attention heads over 3 KV heads and 6 SSM heads of 64 on
  (1, 4): attention heads replicate, the cache is context-parallel, and
  the SSD splits its head dim (the state cache's layout);
* whisper with 6 heads on (1, 4): the encoder on a mesh, a
  context-parallel self-attention cache, and a cross-attention cache
  split on its 24 frames, each read with the shards' log-sum-exp merge;
* reduced internvl2-1b on (1, 4): the image prefix, and 2 KV heads that
  make its cache context-parallel; and with a vocabulary of 514, which
  does not divide the axis, so that the logits split their sequence
  (the image prefix's positions included) and the loss picks each
  shard's own labels (``sharding.on_positions``); and with 20 image
  tokens beside that vocabulary, whose prefix fills the first two
  shards of 8 positions and ends inside the third.
"""
import pytest

import torch_mesh_cases as MC
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

CASES = [("mamba2-2.7b", (2, 2)), ("hymba-1.5b:uneven", (1, 4)),
         ("whisper-large-v3:uneven", (1, 4)), ("internvl2-1b", (1, 4)),
         ("internvl2-1b:odd-vocab", (1, 4)),
         ("internvl2-1b:long-prefix", (1, 4))]


@pytest.mark.parametrize("case,shape", CASES)
def test_family_mesh_matches_one_process(case, shape):
    MC.check(case, shape)


@pytest.mark.parametrize("case,shape", CASES)
def test_cases_take_the_layouts_they_claim(case, shape):
    """The layouts the cases are there for, from the sharding rules."""
    cfg, _ = MC.case_config(case)
    mesh = Mesh(("data", "model"), shape, "cpu")
    cache = T.make_cache(cfg, MC.PROMPTS, MC.CACHE_LEN + cfg.num_img_tokens,
                         abstract=True)
    spec = SH.cache_specs(cfg, mesh, MC.PROMPTS, cache)["layers"]
    tp = shape[1]
    if cfg.has_attn:
        context_parallel = cfg.num_kv_heads % tp != 0
        assert (spec["k"].spec[2] == "model") == context_parallel
        assert context_parallel == (case != "mamba2-2.7b")
    if cfg.has_ssm:
        split = SSM.ssd_split(cfg, tp)
        assert split == (1 if case == "mamba2-2.7b" else 2)
        assert spec["ssd"].spec[split + 1] == "model"
    if cfg.is_encdec:
        assert spec["cross_k"].spec[2] == "model"
    logits = SH.ActCtx(cfg, mesh).spec((MC.BATCH, MC.SEQ + cfg.num_img_tokens,
                                        cfg.vocab_size), "logits")
    assert (logits[1] == "model") == case.endswith(("odd-vocab",
                                                      "long-prefix"))
