"""The plain reference of the served models, in float32 PyTorch.

It follows the architecture of each configuration as run
(``configs/<name>.json``'s ``model`` and ``edge`` sections): token
embedding, decoder layers, a final RMSNorm, a head tied to the
embedding; the edge model's classifier mean-pools the final hidden
states into a linear layer and a softmax.  A decoder layer is its
family's (the configuration's ``family``): ``reference/<family>.py``
gives its ``block`` and the weight leaves it reads (``layer_leaves``),
so a later family is a new file.  This file holds what the families
share: pre-norm RMSNorm, rotary ("neox", half-split) grouped-query
causal attention with an optional QKV bias, the SiLU-gated MLP.

A served request is one call of its prompt's S tokens (the admission),
then one call a generated token (a decode step); ``trunk`` passes each
block the length of the first call (``capped``), where a family that
caps a call's work (the mixture of experts' capacity) needs it.

Nothing here imports the program under test or takes anything it made:
it reads the weights the benchmark drew and the tokens the program
served.  ``Precision("tf32")`` runs the same arithmetic with TF32
matrix products (on the card through cuBLAS; on the CPU by rounding
the operands to TF32's 10-bit mantissa): the lower precision that the
correctness control uses.
"""
from __future__ import annotations

import contextlib
import importlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

#: query rows of one attention block: (heads, rows, keys) scores at once
ATTN_ROWS = 512


class Precision:
    """Matrix products in float32 ("f32", TF32 off) or in TF32 ("tf32")."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "tf32"):
            raise ValueError(f"precision {kind!r}: expected 'f32' or 'tf32'")
        self.kind = kind

    @contextlib.contextmanager
    def active(self, device: torch.device) -> Iterator[None]:
        """TF32 off (or on, for "tf32") for cuBLAS while the block runs."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.kind == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "tf32" and a.device.type == "cpu":
            a, b = _tf32(a), _tf32(b)
        return a @ b


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, round to nearest even)."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) rotated at positions pos (T,), half-split."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos[:, None].to(torch.float32) * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(m: Dict, p: Dict, i: int, h: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Causal GQA self-attention of layer i over h (T, D)."""
    T, D = h.shape
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = prec.mm(h, p["wq"][i].reshape(D, H * hd)).view(T, H, hd)
    k = prec.mm(h, p["wk"][i].reshape(D, KV * hd)).view(T, KV, hd)
    v = prec.mm(h, p["wv"][i].reshape(D, KV * hd)).view(T, KV, hd)
    if m.get("attn_bias", False):
        q, k, v = q + p["bq"][i], k + p["bk"][i], v + p["bv"][i]
    pos = torch.arange(T, device=h.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    G = H // KV
    kh = k.permute(1, 2, 0).repeat_interleave(G, dim=0)    # (H, hd, T)
    vh = v.permute(1, 0, 2).repeat_interleave(G, dim=0)    # (H, T, hd)
    out = torch.empty((T, H, hd), dtype=h.dtype, device=h.device)
    for a in range(0, T, ATTN_ROWS):
        b = min(a + ATTN_ROWS, T)
        s = prec.mm(q[a:b].permute(1, 0, 2), kh[:, :, :b]) / math.sqrt(hd)
        causal = pos[:b][None, :] <= pos[a:b][:, None]
        s = torch.where(causal[None], s, float("-inf"))
        out[a:b] = prec.mm(torch.softmax(s, dim=-1), vh[:, :b]
                           ).permute(1, 0, 2)
    return prec.mm(out.reshape(T, H * hd), p["wo"][i].reshape(H * hd, D))


def ffn(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
        wo: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The SiLU-gated MLP."""
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def attention_leaves(m: Dict) -> List[tuple]:
    """(path under ``layers``, shape, kind, fan-in) of the pre-norm and
    attention leaves of a layer, stacked over ``num_layers``."""
    D, H, KV = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd, L = m["head_dim"], m["num_layers"]
    out = [(("norm1", "scale"), (L, D), "norm", 0),
           (("attn", "wq"), (L, D, H, hd), "wq", D),
           (("attn", "wk"), (L, D, KV, hd), "wk", D),
           (("attn", "wv"), (L, D, KV, hd), "wv", D),
           (("attn", "wo"), (L, H, hd, D), "wo", H * hd)]
    if m.get("attn_bias", False):
        out += [(("attn", "bq"), (L, H, hd), "bias", 0),
                (("attn", "bk"), (L, KV, hd), "bias", 0),
                (("attn", "bv"), (L, KV, hd), "bias", 0)]
    return out


def attend(m: Dict, lp: Dict, i: int, x: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """x plus layer i's attention over its pre-norm."""
    return x + attention(m, lp["attn"], i, rms_norm(
        x, lp["norm1"]["scale"][i], m["norm_eps"]), prec)


def family(m: Dict):
    """The module ``reference/<family>.py`` of model ``m``."""
    return importlib.import_module(f"portbench.reference.{m['family']}")


def trunk(m: Dict, params: Dict, tokens: torch.Tensor, capped: int,
          prec: Precision) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """tokens (T,) -> (final-normed hidden (T, D), each token's smallest
    router margin over the layers (+inf without experts), the expert
    choices dropped over all layers).  The first ``capped`` tokens are
    one call, every later token a call of its own."""
    block = family(m).block
    lp = params["layers"]
    x = params["embed"][tokens.long()]
    margin = torch.full((x.shape[0],), float("inf"), device=x.device)
    dropped = 0
    for i in range(m["num_layers"]):
        x, mg, d = block(m, lp, i, x, capped, prec)
        margin = torch.minimum(margin, mg)
        dropped += d
    return rms_norm(x, params["final_norm"]["scale"], m["norm_eps"]), \
        margin, dropped


@torch.no_grad()
def edge_conf(m: Dict, params: Dict, tokens: torch.Tensor,
              prec: Precision) -> Tuple[float, float]:
    """The edge model's P(query object) for one prompt (S,), and the
    smallest router margin on its path (+inf without experts)."""
    with prec.active(tokens.device):
        h, margin, _ = trunk(m, params, tokens, tokens.shape[0], prec)
        logits = torch.mean(h, dim=0) @ params["cls_head"]["w"] + \
            params["cls_head"]["b"]
        return float(torch.softmax(logits, dim=-1)[1]), float(margin.min())


@torch.no_grad()
def served_logits(m: Dict, params: Dict, prompt: torch.Tensor,
                  served: torch.Tensor, prec: Precision
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The logits (n, V) that predict each of the n served tokens: the
    prompt (S,) is admitted as one call, then each served token but the
    last is decoded.  Also each position's smallest router margin (T,)
    and the expert choices dropped."""
    S, n = prompt.shape[0], served.shape[0]
    tokens = torch.cat([prompt.long(), served[:n - 1].long()])
    with prec.active(prompt.device):
        h, margin, dropped = trunk(m, params, tokens, S, prec)
        logits = prec.mm(h[S - 1:], params["embed"].T)
    return logits, margin, dropped


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the reference's best, (n,)."""
    best = torch.max(ref_logits, dim=-1).values
    return best - ref_logits.gather(1, tokens.long()[:, None])[:, 0]


def request_stats(m: Dict, params: Dict, prompt: torch.Tensor,
                  served: torch.Tensor, control: Optional[Precision] = None
                  ) -> Dict[str, List[float]]:
    """The reference's reading of one served request: at each served
    position its logit of the served token (``ref_at``) and that token's
    gap below its best; with a ``control`` precision, the token the
    control puts first, its logit there (``control_at``) and the f32
    reference's logit of it (``control_ref_at``) and gap; the smallest
    router margin over the request's positions and at each served
    position, and the share of its prompt's expert choices dropped."""
    ref, margin, dropped = served_logits(m, params, prompt, served,
                                         Precision("f32"))
    rows = torch.arange(served.shape[0], device=ref.device)
    choices = prompt.shape[0] * m["num_layers"] * m.get("top_k", 0)
    out = {"ref_at": ref[rows, served.long()].tolist(),
           "gap": gaps(ref, served).tolist(),
           "router_margin": float(margin.min()),
           "position_margin": margin[prompt.shape[0] - 1:].tolist(),
           "dropped_share": dropped / choices if choices else 0.0}
    if control is not None:
        low, _, _ = served_logits(m, params, prompt, served, control)
        top = torch.argmax(low, dim=-1)
        out["control_at"] = low[rows, top].tolist()
        out["control_ref_at"] = ref[rows, top].tolist()
        out["control_gap"] = gaps(ref, top).tolist()
    return out
