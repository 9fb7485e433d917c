"""Cascade speculative decoding demo (see ``core/speculative.py``).

SurveilEdge's confidence cascade, applied per token: the edge draft model
proposes k tokens, the cloud model verifies them and accepts the agreeing
prefix.  The output is identical to cloud-only greedy decoding, and the
cloud runs about ``tokens_per_cloud_step`` times fewer rounds.  Both
models run on ``--device`` (the card by default; ``cpu`` for the host):

  PYTHONPATH=src python -m repro_torch.speculative_serving --steps 16 --k 4 \\
      --device cpu

The flags are the reference example's, plus ``--device``.  The weights
draw from ``torch.Generator``s seeded 0 (cloud) and 1 (edge), and the
prompt from one seeded 2, where the reference example uses
``PRNGKey(0/1/2)``; the two frameworks draw different numbers from the
same seed.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import speculative as SP
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cloud_cfg = get_config(args.arch).reduced()
    edge_cfg = get_config(args.arch).edge_variant()

    def init(cfg, seed):
        return M.tree_map(lambda t: t.to(dev), M.init_params(
            cfg, torch.Generator().manual_seed(seed)))

    cloud, edge = init(cloud_cfg, 0), init(edge_cfg, 1)
    prompt = torch.randint(0, cloud_cfg.vocab_size, (1, args.prompt_len),
                           generator=torch.Generator().manual_seed(2)).to(dev)

    t0 = time.perf_counter()
    want = SP.cloud_greedy_generate(cloud_cfg, cloud, prompt, args.steps)
    want = want.cpu()                      # waits for the device
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, stats = SP.speculative_generate(edge_cfg, edge, cloud_cfg, cloud,
                                         prompt, steps=args.steps, k=args.k)
    got = got.cpu()
    t_spec = time.perf_counter() - t0

    print(f"device={dev} cloud={cloud_cfg.name} edge={edge_cfg.name}")
    print(f"output identical to cloud-greedy: {torch.equal(got, want)}")
    print(f"draft acceptance rate : {stats.acceptance_rate:.1%}")
    print(f"tokens per cloud round: {stats.tokens_per_cloud_step:.2f}")
    print(f"wall s: cloud-greedy {t_ref:.2f}, speculative {t_spec:.2f} "
          f"(the speculative loop re-prefills both caches every round; the "
          f"win is the {stats.tokens_per_cloud_step:.1f}x fewer cloud "
          f"decode rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
