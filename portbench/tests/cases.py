"""Small cells for the CPU tests: each configuration file of the
benchmark cut to a size the CPU runs in seconds, its edge kept as the
file has it, and a traffic mix of short prompts (not a test file)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness as H  # noqa: E402

BENCH = H.load_json(ROOT / "BENCHMARK.json")
CUT = {"num_layers": 2, "d_model": 64, "num_heads": 4, "head_dim": 16,
       "d_ff": 96, "vocab_size": 384}
#: the limits of a tiny cell, compared as the cells of its family are:
#: the widest logit error for a dense model, the 90th percentile for a
#: mixture of experts (router near-ties move a few tokens by design)
LIMITS = {"answer_miss": 0, "route_miss": 0, "token_miss": 0,
          "conf_err_max": 1e-5, "logit_err_max": 1e-4}
LIMITS_MOE = {"answer_miss": 0, "route_miss": 0, "token_miss": 0,
              "conf_err_max": 1e-5, "logit_err_p90": 1e-4}
#: a served token may lie this far below the reference's best
TOKEN_BAND = 1e-3


def config(name: str) -> dict:
    """The configuration file ``name`` cut to ``CUT`` (experts kept at
    their count and top-k; half the query heads as kv heads where the
    file has fewer kv heads than query heads)."""
    cfg = copy.deepcopy(H.load_json(ROOT / "portbench" / "configs"
                                    / f"{name}.json"))
    m = cfg["model"]
    gqa = m["num_kv_heads"] < m["num_heads"]
    m.update(CUT, num_kv_heads=2 if gqa else 4, attn_impl="flash")
    if m.get("num_experts"):
        m.update(num_experts=8, top_k=2)
    e = cfg["edge"]
    e.update(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64,
             vocab_size=256)
    return cfg


def mix(**kw) -> dict:
    out = {"name": "tiny", "driver": "cascade_serving",
           "prompt_tokens": [24, 96], "answer_tokens": [3, 8],
           "topic_ids": 16, "slots": 4, "cache_len": 104, "burst": 8,
           "edge_settled": 0.25, "threshold_bursts": 2,
           "check_requests": 6}
    out.update(kw)
    return out


def cell(name: str = "qwen1.5-0.5b", **kw) -> H.Cell:
    cfg = config(name)
    lim = LIMITS_MOE if cfg["model"].get("num_experts") else LIMITS
    return H.Cell(name="tiny", config=cfg, mix=mix(**kw),
                  checks={"limits": dict(lim), "token_band": TOKEN_BAND})


def bench() -> dict:
    """BENCHMARK.json with the tiny cell as a workload."""
    b = copy.deepcopy(BENCH)
    b["workloads"].append({"name": "tiny", "config": "qwen1.5-0.5b",
                           "traffic": "tiny", "chips": 1, "why": "test"})
    return b
