"""Cascade speculative decoding: the reference's ``core/speculative.py``.

SurveilEdge's cascade routes images by edge-model confidence; the same
economics apply per token when serving an LLM.  A cheap edge draft model
proposes ``k`` tokens greedily; the cloud model decodes them one at a
time and accepts the longest prefix where its own greedy token agrees,
then adds its token at the first mismatch.  Greedy-match acceptance keeps
the output identical to cloud-greedy decoding (``cloud_greedy_generate``,
also the oracle of the serving tests), so there is no accuracy trade.

The control flow is the reference's, for one sequence (B = 1): each
round the draft decodes ``k`` tokens on its cache, the cloud decodes them
on its own, and both caches are then rebuilt by a prefill of the accepted
stream.  One step differs.  The cloud decodes ``[cur, draft[:-1]]``, so
when all ``k`` proposals match, ``verify_prefix``'s next token is the
cloud's token at the last draft position, the last draft token itself;
the reference appends it a second time, and its stream then parts from
cloud-greedy decoding.  Here a fully accepted round appends the ``k``
verified tokens only, and the next round starts after the last of them.

The port's ``decode_step`` writes K/V into the cache it is given
(the reference returns a new cache), so the draft and verify decodes
overwrite both caches' storage; the re-prefill that ends every round
replaces them, and no cache is held across a round.  Under the cloud
config's ``attn_impl="flash"`` each of those prefills launches the
flash-attention kernel once a layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SpecStats:
    """The reference's counts of proposals, accepted proposals and cloud
    rounds, and the tokens the cloud itself added (one a round with a
    mismatch; the reference counts one every round)."""
    proposed: int = 0
    accepted: int = 0
    cloud_steps: int = 0
    cloud_tokens: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_cloud_step(self) -> float:
        return (self.accepted + self.cloud_tokens) / max(self.cloud_steps, 1)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...) int32 argmax (the first maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def draft_tokens(cfg: ModelConfig, params, cache, last_token: torch.Tensor,
                 k: int, window: Optional[int] = None):
    """Draft ``k`` tokens greedily with the edge model, decoding on
    ``cache`` in place.  Returns ((B, k) tokens, cache)."""
    toks = []
    tok = last_token
    for _ in range(k):
        logits, cache = T.decode_step(cfg, params, cache, tok, window=window)
        tok = greedy(logits)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def verify_prefix(cloud_logits: torch.Tensor, draft: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cloud_logits (B, k, V): the cloud's logits at each draft position
    (position i conditioned on draft[:, :i]).  Returns (n_accepted (B,),
    next_token (B,)): the length of the longest prefix where the cloud's
    greedy token equals the draft's, and the cloud's token at the first
    mismatch (at the last draft position if all match, where it equals the
    last draft token)."""
    cloud_tok = greedy(cloud_logits)                     # (B, k)
    eq = (cloud_tok == draft.to(cloud_tok.dtype)).to(torch.int32)
    n_acc = torch.sum(torch.cumprod(eq, dim=1), dim=1)   # (B,)
    idx = torch.clamp(n_acc, max=draft.shape[1] - 1)
    next_tok = torch.gather(cloud_tok, 1, idx[:, None].long())[:, 0]
    return n_acc, next_tok


@torch.no_grad()
def speculative_generate(edge_cfg: ModelConfig, edge_params,
                         cloud_cfg: ModelConfig, cloud_params,
                         prompt: torch.Tensor, *, steps: int, k: int = 4,
                         cache_len: Optional[int] = None
                         ) -> Tuple[torch.Tensor, SpecStats]:
    """Generate ``steps`` tokens after the cloud's first for a (1, S)
    prompt: (1, steps + 1) tokens equal to ``cloud_greedy_generate``'s,
    and the round's counts.  The draft must share the cloud's vocabulary:
    it is fed the cloud's tokens."""
    B, S = prompt.shape
    if B != 1:
        raise ValueError(f"speculative_generate runs one sequence, got a "
                         f"batch of {B}")
    if edge_cfg.vocab_size != cloud_cfg.vocab_size:
        raise ValueError(f"the draft's vocabulary ({edge_cfg.vocab_size}) "
                         f"is not the cloud's ({cloud_cfg.vocab_size})")
    total = S + steps + k + 2
    cache_len = max(cache_len or 0, total)
    stats = SpecStats()

    _, e_cache = T.prefill(edge_cfg, edge_params, prompt, cache_len=cache_len)
    c_logits, c_cache = T.prefill(cloud_cfg, cloud_params, prompt,
                                  cache_len=cache_len)
    out = [greedy(c_logits)]                             # first cloud token
    cur = out[0]                                         # the draft follows

    while len(out) < steps + 1:
        kk = min(k, steps + 1 - len(out))
        draft, _ = draft_tokens(edge_cfg, edge_params, e_cache, cur, kk)
        # verify: the cloud decodes [cur, draft[:-1]] one position a step
        seq = torch.cat([cur[:, None], draft[:, :-1]], dim=1)
        c_logits_k = []
        for i in range(kk):
            lg, c_cache = T.decode_step(cloud_cfg, cloud_params, c_cache,
                                        seq[:, i])
            c_logits_k.append(lg)
        n_acc, next_tok = verify_prefix(torch.stack(c_logits_k, dim=1), draft)
        n = int(n_acc[0])
        stats.proposed += kk
        stats.accepted += n
        stats.cloud_steps += 1
        out.extend(draft[:, i] for i in range(n))
        if n < kk and len(out) < steps + 1:      # the cloud's token
            out.append(next_tok)
            stats.cloud_tokens += 1
        # rebuild both caches to the accepted stream
        full = torch.cat([prompt] + [t[:, None].to(prompt.dtype)
                                     for t in out], dim=1)
        _, e_cache = T.prefill(edge_cfg, edge_params, full[:, :-1],
                               cache_len=cache_len)
        _, c_cache = T.prefill(cloud_cfg, cloud_params, full[:, :-1],
                               cache_len=cache_len)
        cur = out[-1]

    return torch.stack(out[:steps + 1], dim=1), stats


@torch.no_grad()
def cloud_greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                          steps: int, cache_len: Optional[int] = None
                          ) -> torch.Tensor:
    """prompt (B, S) -> (B, steps + 1) greedy tokens: the prefill's, then
    one per decode step."""
    B, S = prompt.shape
    cache_len = max(cache_len or 0, S + steps + 2)
    logits, cache = T.prefill(cfg, params, prompt, cache_len=cache_len)
    out = [greedy(logits)]
    for _ in range(steps):
        logits, cache = T.decode_step(cfg, params, cache, out[-1])
        out.append(greedy(logits))
    return torch.stack(out[:steps + 1], dim=1)
