"""Serving launcher: batched prefill+decode with the cascade front-end.

Serves a (reduced) model behind the SurveilEdge triage: each request
batch is scored by the edge CQ model; confident requests are answered at
the edge, uncertain ones run the full ("cloud") model decode.  The flags
are the reference launcher's, plus ``--device`` (the card by default;
``cpu`` runs every kernel's plain version):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 32 --decode-steps 8 --device cpu

``--arch`` takes every ``ASSIGNED`` architecture.  whisper-large-v3 and
internvl2-1b also take their stubbed frontends' outputs: seeded normal
``audio_frames`` (requests, enc_seq, d_model) and ``img_embeds``
(requests, num_img_tokens, 1024), which the reference's launcher never
passes (it serves neither).

Parameters and prompts come from ``torch.Generator``s seeded 0 (cloud), 1
(edge), 2 (prompts) and 3 (stub frames and image embeddings), where the
reference uses ``PRNGKey(0/1/2)``; the two frameworks draw different
numbers from the same seed.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import cascade as C
from repro_torch.core.speculative import greedy
from repro_torch.core.thresholds import ThresholdState
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import meta as M
from repro_torch.train import steps as ST


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.8)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cloud_cfg = get_config(args.arch).reduced()
    edge_cfg = get_config(args.arch).edge_variant()

    def init(cfg, seed):
        return M.tree_map(lambda t: t.to(dev), M.init_params(
            cfg, torch.Generator().manual_seed(seed)))

    cloud_params = init(cloud_cfg, 0)
    edge_params = init(edge_cfg, 1)
    print(f"[serve] cloud={cloud_cfg.name} ({cloud_cfg.param_count()/1e6:.1f}M) "
          f"edge={edge_cfg.name} ({edge_cfg.param_count()/1e6:.1f}M) "
          f"device={dev}")

    B, S = args.requests, args.prompt_len
    tokens = torch.randint(0, min(edge_cfg.vocab_size, cloud_cfg.vocab_size),
                           (B, S), generator=torch.Generator().manual_seed(2)
                           ).to(dev)

    def batch_of(cfg, toks):
        """The model's inputs: the tokens, plus its stub frontend's output."""
        g, n = torch.Generator().manual_seed(3), toks.shape[0]
        batch = {"tokens": toks}
        if cfg.is_encdec:
            batch["audio_frames"] = torch.randn(
                (n, cfg.enc_seq, cfg.d_model), generator=g).to(dev)
        if cfg.num_img_tokens:
            batch["img_embeds"] = torch.randn(
                (n, cfg.num_img_tokens, 1024), generator=g).to(dev)
        return batch

    # --- edge triage ---------------------------------------------------------
    classify = ST.make_classify_fn(edge_cfg)
    conf = C.confidence_from_logits(classify(edge_params,
                                             batch_of(edge_cfg, tokens)))
    th = ThresholdState(alpha=args.alpha, beta=args.beta)
    routes = C.triage(conf, th.alpha, th.beta)
    idx, valid, n_esc = C.compact_escalated(routes, capacity=B)
    print(f"[serve] triage: accept={int((routes == 0).sum())} "
          f"reject={int((routes == 1).sum())} escalate={int(n_esc)}")

    # --- cloud decode for escalated requests ----------------------------------
    esc_tokens = tokens[idx.long()]
    prefill = ST.make_prefill_step(cloud_cfg,
                                   cache_len=S + args.decode_steps)
    decode = ST.make_decode_step(cloud_cfg)

    t0 = time.perf_counter()
    logits, cache = prefill(cloud_params, batch_of(cloud_cfg, esc_tokens))
    tok = greedy(logits)
    generated = [tok]
    for _ in range(args.decode_steps - 1):
        logits, cache = decode(cloud_params, cache, tok)
        tok = greedy(logits)
        generated.append(tok)
    gen = torch.stack(generated, dim=1).cpu()   # waits for the device
    dt = time.perf_counter() - t0
    print(f"[serve] cloud decoded {int(n_esc)} reqs x {args.decode_steps} "
          f"tokens in {dt:.2f}s "
          f"({int(n_esc) * args.decode_steps / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] sample continuation (req 0): {gen[0].numpy()[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
