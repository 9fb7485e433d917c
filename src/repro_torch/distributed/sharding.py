"""Logical-axis -> mesh-axis sharding rules, as DTensor placements.

Parameters carry *logical* axis names (``models.meta``).  This module
maps them onto the production mesh (``launch.mesh``):

  mesh axes: ("pod", "data", "model")  (multi-pod)  or  ("data", "model")

Rules (the reference's, MaxText-style):
  * tensor-parallel axes (heads / kv_heads / mlp / experts / ssm_inner /
    ssm_heads / vocab) -> "model"
  * FSDP: the "embed" logical axis -> "data" in *train* mode (params,
    grads and Adam moments all shard); in serve mode only where a 1-D TP
    shard would not fit one device (2-D serve).
  * every mapping is guarded by divisibility (25 heads cannot shard over
    16 devices -> replicate) and by one-mesh-axis-per-leaf.

A spec is a plain tuple with one entry per tensor dimension: ``None``, a
mesh axis name, or a tuple of names (the dimension split over several
axes, major first), exactly the reference's ``PartitionSpec``.
:class:`NamedSharding` pairs a spec with a mesh and turns it into DTensor
placements (``Shard(dim)`` on each named mesh axis, ``Replicate()`` on
the rest).  ``ActCtx`` is the ``ctx`` the model and the step factories
take: ``ctx(x, name)`` redistributes a DTensor activation to the
reference's placement (the reference's ``with_sharding_constraint``) and
returns a plain tensor unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig

Spec = Tuple[Any, ...]

TP_AXES = ("vocab", "heads", "kv_heads", "mlp", "experts",
           "ssm_inner", "ssm_heads")


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Batch-sharding axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_size(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= _axis_size(mesh, a)
    return n


def data_index(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's coordinate over the data axes, their size): the host
    block of the global batch this rank feeds (``data.loader``'s
    ``host_batches(host_id=..., num_hosts=...)``); ranks that differ only
    on "model" feed the same block."""
    coord = mesh.device_mesh.get_coordinate()
    index = 0
    for ax in data_axes(mesh):
        i = mesh.axis_names.index(ax)
        index = index * mesh.axis_sizes[i] + coord[i]
    return index, data_size(mesh)


def logical_to_mesh(cfg: ModelConfig, mesh: Mesh, mode: str,
                    force_1d_serve: bool = False) -> Dict[str, Any]:
    """Logical axis name -> mesh axis candidate (or None)."""
    rules: Dict[str, Any] = {a: "model" for a in TP_AXES}
    if cfg.is_moe:
        # experts take the model axis; the per-expert mlp dim stays whole
        rules["mlp"] = None
    # FSDP ('embed' on the data axis): always in train; in serve only for
    # models whose 1-D TP shard would not fit one device (2-D weight
    # sharding, at the cost of per-layer weight all-gathers).
    # force_1d_serve keeps decode weights resident.
    two_d_serve = (cfg.param_count() * 2 / _axis_size(mesh, "model") > 2e9
                   and not force_1d_serve)
    rules["embed"] = "data" if (mode == "train" or two_d_serve) else None
    return rules


def spec_for_meta(cfg: ModelConfig, pm: M.ParamMeta, mesh: Mesh,
                  mode: str, force_1d_serve: bool = False) -> Spec:
    rules = logical_to_mesh(cfg, mesh, mode, force_1d_serve)
    used = set()
    out = []
    for dim, ax in zip(pm.shape, pm.axes):
        cand = rules.get(ax) if ax else None
        if cand is None or cand in used:
            out.append(None)
            continue
        if dim % _axis_size(mesh, cand) != 0:
            out.append(None)
            continue
        used.add(cand)
        out.append(cand)
    return tuple(out)


def param_specs(cfg: ModelConfig, mesh: Mesh, mode: str,
                force_1d_serve: bool = False) -> M.Tree:
    """Spec tree mirroring the parameter tree."""
    return M.tree_map(
        lambda pm: spec_for_meta(cfg, pm, mesh, mode, force_1d_serve),
        M.model_meta(cfg))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor placements, one
    per mesh axis."""
    mesh: Mesh
    spec: Spec

    @property
    def placements(self):
        """``Shard(dim)`` on each mesh axis the spec names for a dim (an
        axis of size 1 holds the whole dim: ``Replicate()``), else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.axis_names)
        for dim, ax in enumerate(self.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None and self.mesh.shape[a] > 1:
                    out[self.mesh.axis_names.index(a)] = Shard(dim)
        return tuple(out)

    def _splits(self, ndim: int) -> Tuple[int, ...]:
        """Per tensor dimension, the number of shards it splits into."""
        out = [1] * ndim
        for dim, ax in enumerate(self.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    out[dim] *= self.mesh.shape[a]
        return tuple(out)

    def local_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's shard of a tensor of ``shape``."""
        splits = self._splits(len(shape))
        for n, k in zip(shape, splits):
            if n % k:
                raise ValueError(f"{tuple(shape)} does not split as "
                                 f"{self.spec} on {self.mesh.shape}")
        return tuple(n // k for n, k in zip(shape, splits))

    def global_shape(self, local) -> Tuple[int, ...]:
        """The shape of the tensor whose shards have shape ``local``."""
        return tuple(n * k for n, k in zip(local, self._splits(len(local))))


def param_shardings(cfg: ModelConfig, mesh: Mesh, mode: str,
                    force_1d_serve: bool = False) -> M.Tree:
    return M.tree_map(lambda s: NamedSharding(mesh, s),
                      param_specs(cfg, mesh, mode, force_1d_serve))


def _batch_spec(mesh: Mesh, batch: int) -> Any:
    """Largest prefix of ('pod', 'data') that divides the batch."""
    axes = []
    n = 1
    for a in data_axes(mesh):
        if batch % (n * _axis_size(mesh, a)) == 0:
            axes.append(a)
            n *= _axis_size(mesh, a)
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def batch_specs(cfg: ModelConfig, mesh: Mesh, batch: int,
                tree: Any) -> Any:
    """Shardings for an input-batch tree: dim 0 = batch, the rest
    replicated."""
    b = _batch_spec(mesh, batch)

    def spec(leaf):
        nd = len(leaf.shape)
        return NamedSharding(mesh, (b,) + (None,) * (nd - 1) if nd else ())

    return M.tree_map(spec, tree)


def cache_specs(cfg: ModelConfig, mesh: Mesh, batch: int, cache: Any) -> Any:
    """Shardings for a decode cache, by leaf name.

    k/v/cross_k/cross_v: (L, B, S, KV, hd) — kv-heads on 'model' when
    divisible, else context-parallel (the sequence dim on 'model').  ssd
    state (L, B, nh, hd, N): ssm heads on 'model'.  conv caches (L, B,
    W-1, C): channels on 'model'.  Batch always on the data axes."""
    b = _batch_spec(mesh, batch)
    tp = _axis_size(mesh, "model")

    def div(n: int) -> bool:
        return n % tp == 0 and n > 1

    def spec(name: str, leaf) -> NamedSharding:
        shp = leaf.shape
        if name in ("pos", "kpos"):     # per-sequence bookkeeping
            return NamedSharding(mesh, (b,) + (None,) * (len(shp) - 1))
        if len(shp) <= 1:
            return NamedSharding(mesh, (None,) * len(shp))
        out = [None] * len(shp)
        out[1] = b                      # batch dim (after the layer dim)
        if name in ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale"):
            if div(shp[3]):             # kv heads
                out[3] = "model"
            elif div(shp[2]):           # context-parallel fallback
                out[2] = "model"
        elif name == "ssd":
            if div(shp[2]):             # ssm heads
                out[2] = "model"
            elif div(shp[3]):
                out[3] = "model"
        elif len(shp) >= 4 and div(shp[3]):   # conv caches: channels
            out[3] = "model"
        return NamedSharding(mesh, tuple(out))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec(k, v)
                for k, v in tree.items()}

    return walk(cache)


# --- placing tensors ----------------------------------------------------------

@functools.cache
def _dtensor_class() -> type:
    """``DTensor``, imported at first use (the model's hot loops ask)."""
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x: Any) -> bool:
    return isinstance(x, _dtensor_class())


def is_dtensor_type(t: type) -> bool:
    return issubclass(t, _dtensor_class())


def as_dtensor(t: torch.Tensor, device_mesh):
    """``t`` if it is a DTensor, else ``t`` as a DTensor replicated on
    ``device_mesh`` (every rank holds the same ``t``; no collective)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def distribute(x: torch.Tensor, sh: NamedSharding):
    """The DTensor of ``sh``'s layout whose local shard is this rank's
    slice of the full tensor ``x`` (every rank holds the same ``x``; no
    collective)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sh.mesh.device_mesh, sh.placements,
                             src_data_rank=None)


def from_local(local: torch.Tensor, sh: NamedSharding, shape):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (no collective, no check across ranks)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, sh.mesh.device_mesh, sh.placements,
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def distribute_tree(tree: M.Tree, shardings: M.Tree) -> M.Tree:
    """``distribute`` over matching trees (an int8 ``{"q", "s"}`` leaf
    takes a ``{"q", "s"}`` sharding)."""
    return M.tree_map(distribute, tree, shardings)


def split_batch(leaf: torch.Tensor, m: int):
    """``leaf`` in ``m`` microbatches along dim 0.  A DTensor batch (dim 0
    on the data axes) splits each rank's own rows, so no collective moves
    it: microbatch i holds the i-th block of every shard, not the i-th
    block of the global batch, which leaves the step's mean over all
    microbatches as it is."""
    if not is_dtensor(leaf):
        return leaf.chunk(m)
    from torch.distributed.tensor import DTensor
    shape = torch.Size((leaf.shape[0] // m,) + tuple(leaf.shape[1:]))
    return [DTensor.from_local(p, leaf.device_mesh, leaf.placements,
                               run_check=False, shape=shape,
                               stride=_contiguous_stride(shape))
            for p in leaf.to_local().chunk(m)]


def gather_fsdp(tree):
    """A parameter (tree) with its FSDP shards gathered: each DTensor
    leaf's "pod"/"data" shards redistributed to ``Replicate()`` (an
    all-gather; its backward reduce-scatters the gradient), the "model"
    shards kept.  What the layer loop does to a layer's weights before
    using them, as FSDP does; plain tensors pass unchanged."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    names = tree.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] in ("pod", "data") else p
               for i, p in enumerate(tree.placements))
    return tree if pl == tuple(tree.placements) else tree.redistribute(
        tree.device_mesh, pl)


def splits_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor whose last dim is sharded."""
    from torch.distributed.tensor import Shard
    return is_dtensor(x) and any(
        isinstance(p, Shard) and p.dim == x.ndim - 1 for p in x.placements)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx)`` for a DTensor ``x`` whose last dim may
    be sharded (vocabulary-sharded logits): each shard gathers the indices
    in its own range (zero elsewhere) and the shards' partial results sum,
    so no shard reads another's part of ``x``, and the backward scatters
    into each shard's own part."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = x.device_mesh, tuple(x.placements)
    last = x.ndim - 1
    split = [i for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == last]
    first = shard_start(x, last)
    idx = as_dtensor(idx, mesh)
    idx_pl = tuple(Replicate() if i in split else p
                   for i, p in enumerate(pl))
    out_pl = tuple(Partial() if i in split else p for i, p in enumerate(pl))

    def local(xl, il):
        j = il - first
        ok = (j >= 0) & (j < xl.shape[-1])
        return torch.gather(xl, -1, j.clamp(0, xl.shape[-1] - 1)) * ok

    # placements as lists: a tuple would read as one entry per output
    return local_map(local, out_placements=list(out_pl),
                     in_placements=(list(pl), list(idx_pl)),
                     redistribute_inputs=True, device_mesh=mesh)(x, idx)


def on_positions(fn, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The sum over positions of ``fn(x, idx)`` (per-position terms, (B,
    S')) on each shard's own positions, for a DTensor ``x`` (B, S, V)
    split on its batch and sequence only (a vocabulary that does not
    divide the "model" axis: the logits' sequence split instead) and
    indices ``idx`` (B, S', 1) for its last S' positions (a prefix with no
    index, such as an image prefix, left out: dropping it from ``x``
    would move every shard's rows).  Each shard picks its own positions'
    indices (no collective) and sums its terms; the shards' partial sums
    are reduced.  A label pick over such logits on DTensors would gather
    them, or their gradient."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
          for p in x.placements]
    rows = row_placements(x)
    prefix = x.shape[1] - idx.shape[1]
    first = shard_start(x, 1, pl) - prefix      # this shard's first label

    def local(xl, il):
        # its labelled rows [a, b) in label positions, both ends clamped:
        # a shard wholly inside the prefix has none
        a, b = max(first, 0), max(first + xl.shape[1], 0)
        return fn(xl[:, a - first:], il[:, a:b]).sum()

    out = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return reduce_partial(local_map(
        local, out_placements=out, in_placements=(pl, rows),
        redistribute_inputs=True, device_mesh=mesh)(
        reduce_partial(x), as_dtensor(idx, mesh)))


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial placements reduced (to ``Replicate()``); its
    shards kept.  Plain tensors pass unchanged."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def like_rows(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row reduction ``t`` (..., 1) of a DTensor ``x`` (..., V) in
    ``x``'s layout less its last-dim shards (those replicate), so its
    gradient comes back in that layout and meets ``x``'s shards without
    a collective.  Plain tensors pass unchanged."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1
          or not isinstance(p, Shard) else p for p in x.placements]
    return t.redistribute(x.device_mesh, pl)


def local_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` (its subscripts
    start with the batch ``b``) and a weight ``w``, at least one of them a
    DTensor, as a tensor-parallel product on each rank's shards
    (``local_map``).  Per mesh dim: ``x``'s batch split stays (``w`` whole
    there); where ``w`` splits a letter, ``x`` is split on it too if it
    has it (a contracted split: partial sums) and gathered if not (a
    column split); where ``w`` is whole, ``x`` keeps its split (the
    sequence of a sequence-parallel residual: shard-local rows), and
    ``w`` takes the same split where it has that letter.  Partial sums of
    either operand are reduced first.  Inside, the product is plain, so no
    view of a sharded DTensor is taken, whatever torch's DTensor
    supports."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    (xs, ws), out = [t.split(",") for t in eq.split("->")][0], \
        eq.split("->")[1]
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = (reduce_partial(as_dtensor(t, mesh)) for t in (x, w))

    def split(letter, subs):
        return Shard(subs.index(letter)) if letter in subs else Replicate()

    # per mesh dim: x's and w's placements, their gradients' (a rank's
    # gradient is a partial sum where it met the other operand's split on
    # a letter it does not have), and the output's
    x_pl, w_pl, xg_pl, wg_pl, o_pl = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        xl = xs[xp.dim] if isinstance(xp, Shard) else None
        wl = ws[wp.dim] if isinstance(wp, Shard) else None
        if xl == xs[0]:                     # the batch split
            pls = (xp, Replicate(), xp, Partial(), split(xl, out))
        elif wl is not None:                # w splits a letter
            xq = split(wl, xs)
            pls = (xq, wp, xq if wl in xs else Partial(), wp,
                   split(wl, out) if wl in out else Partial())
        elif xl is not None:                # x splits, w whole
            wq = split(xl, ws)
            pls = (xp, wq, xp, wq if xl in ws else Partial(),
                   split(xl, out) if xl in out else Partial())
        else:
            pls = (Replicate(),) * 5
        for acc, pl in zip((x_pl, w_pl, xg_pl, wg_pl, o_pl), pls):
            acc.append(pl)
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=o_pl, in_placements=(x_pl, w_pl),
                     in_grad_placements=(xg_pl, wg_pl),
                     redistribute_inputs=True, device_mesh=mesh)(x, w)


def shard_start(x: torch.Tensor, dim: int, placements=None) -> int:
    """The first index along ``dim`` that this rank's shard of the
    DTensor ``x`` holds, or would hold under ``placements`` (``dim``
    split in mesh-dim order, evenly)."""
    from torch.distributed.tensor import Shard
    mesh, first, width = x.device_mesh, 0, x.shape[dim]
    pl = x.placements if placements is None else placements
    for i, (p, c) in enumerate(zip(pl, mesh.get_coordinate())):
        if isinstance(p, Shard) and p.dim == dim:
            width //= mesh.size(i)
            first += c * width
    return first


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *rows):
    """``fn(q, k, v, *rows)`` on each shard's own batch rows and heads
    (``local_map``), q (B, Sq, H, hd) and k, v (B, Sk, KV, hd) DTensors:
    q's batch and head shards kept, everything else (the sequence,
    partial sums) gathered first.  k and v split their heads as q's
    where the shards divide KV; else they come whole and each shard takes
    its query heads' KV heads (a group split over shards).  ``rows`` are
    per-row tensors ((B, ...) DTensors take q's batch shards; plain ones,
    such as (S,) positions, pass as they are).  Attention is head-local,
    so this is exact: the chunked path runs on local tensors, and flash
    attention, whose kernel takes raw pointers, on each shard's heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in pl]
    n = 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 2:
            n *= mesh.size(i)
    H, KV = q.shape[2], k.shape[2]
    whole_kv = KV % n != 0
    kv_pl = row_pl if whole_kv else pl
    q_first = shard_start(q, 2, pl)

    def local(ql, kl, vl, *r):
        if whole_kv:
            idx = (q_first + torch.arange(ql.shape[2], device=ql.device)
                   ) // (H // KV)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl, *r)

    in_pl = (pl, kv_pl, kv_pl) + tuple(row_pl if is_dtensor(r) else None
                                       for r in rows)
    # whole k and v: a shard's gradient covers its query heads' share
    kv_grad = [Partial() if whole_kv and isinstance(p, Shard) and p.dim == 2
               else r for p, r in zip(pl, row_pl)] if whole_kv else pl
    grad_pl = (pl, kv_grad, kv_grad) + in_pl[3:]
    return local_map(local, out_placements=pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, redistribute_inputs=True,
                     device_mesh=mesh)(q, k, v, *rows)


def split_dims(x: torch.Tensor, dim: int) -> Tuple[int, ...]:
    """The mesh dims on which the DTensor ``x`` splits its ``dim`` (none
    for a plain tensor)."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return ()
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def row_placements(x: torch.Tensor) -> list:
    """``x``'s batch (dim 0) shards, ``Replicate()`` on every other mesh
    dim: the layout in which each shard holds whole rows."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def tp_layout(rows: torch.Tensor, dim: Optional[int], mesh=None) -> list:
    """Placements of a tensor with ``rows``' batch shards (none when
    ``rows`` is None: a weight, on ``mesh``), split on ``dim`` over the
    "model" mesh dim (whole where ``dim`` is None), ``Replicate()`` on
    every other mesh dim (a "model" dim of size 1 holds it whole)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = rows.device_mesh if rows is not None else mesh
    pl = row_placements(rows) if rows is not None else \
        [Replicate()] * mesh.ndim
    return [Shard(dim) if n == "model" and dim is not None
            and mesh.size(i) > 1 else p
            for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, pl))]


def model_size(x: torch.Tensor) -> int:
    """The size of the "model" mesh dim of the DTensor ``x`` (1 where it
    has none)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def copy_local(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for DTensors, shard by shard: ``src`` put in
    ``dst``'s layout (no collective where it already is), then each
    shard copied into its own part of ``dst``."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    src = as_dtensor(src, dst.device_mesh)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def all_reduce_over(mesh, dims) -> Any:
    """``reduce(t, op)``: ``t`` all-reduced (``op`` "sum" or "max") over
    the mesh dims ``dims``, for use on local tensors inside ``local_map``
    (functional collectives; no gradient)."""
    from torch.distributed import _functional_collectives as funcol

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        for d in dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
        return t
    return reduce


def on_sequence_shards(fn, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, q_pos: torch.Tensor,
                       k_pos: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, q_pos, k_pos, merge)`` on each shard's own keys, for
    a decode step (q (B, 1, H, hd)) over a context-parallel cache: k, v
    (B, Sk, KV, hd) DTensors whose sequence is split (``cache_specs``'s
    layout where the KV heads do not divide the "model" axis).  Each
    shard gets q's whole heads for its own rows (a gather of the one
    query token's heads at most), its own slots of k, v and of ``k_pos``
    ((B, Sk) or (Sk,), split like the keys: no collective), and
    ``merge``, an all-reduce over the mesh dims that split the keys,
    which ``fn`` calls on its running max, its sum of exponentials and
    its unnormalised output (``layers.attention``'s log-sum-exp merge).
    Neither the cache nor the sequence is gathered; the result has q's
    rows and every head whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    seq = split_dims(k, 1)
    rows = row_placements(q)
    kv_pl = [Shard(1) if i in seq else p for i, p in enumerate(rows)]
    k_pos = as_dtensor(k_pos, mesh)
    if k_pos.ndim == 1:
        kp_pl = [Shard(0) if i in seq else Replicate()
                 for i in range(len(rows))]
    else:
        kp_pl = kv_pl
    qp_pl = rows if is_dtensor(q_pos) else None
    merge = all_reduce_over(mesh, seq)
    # placements as lists: a tuple would read as one entry per output
    return local_map(lambda ql, kl, vl, qp, kp: fn(ql, kl, vl, qp, kp, merge),
                     out_placements=list(rows),
                     in_placements=(rows, kv_pl, kv_pl, qp_pl, kp_pl),
                     redistribute_inputs=True, device_mesh=mesh)(
        q, k, v, q_pos, k_pos)


def on_local_rows(fn, n_out: int, x: torch.Tensor, w: torch.Tensor):
    """``fn(x, w)`` on each shard's own whole rows of the DTensor ``x``
    (B, ...): its batch shards kept, everything else gathered (``local_map``),
    ``w`` whole.  ``fn`` returns ``n_out`` tensors of x's rows, laid out
    so (each shard on the same data coordinate computes the same).
    ``w``'s gradient is a partial sum over the rows' shards."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = row_placements(x)
    return local_map(fn, out_placements=tuple([rows] * n_out),
                     in_placements=(rows, [Replicate()] * mesh.ndim),
                     in_grad_placements=(rows, weight_grad(rows)),
                     redistribute_inputs=True, device_mesh=mesh)(
        x, as_dtensor(w, mesh))


def weight_grad(rows, placements=None) -> list:
    """The gradient placements of a weight of ``placements`` (whole on
    every mesh dim where None) met by activations of ``rows``'
    placements: a partial sum over each mesh dim that splits the batch,
    the weight's own placement elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    placements = placements or [Replicate()] * len(rows)
    return [Partial() if isinstance(r, Shard) and r.dim == 0 else p
            for r, p in zip(rows, placements)]


def on_expert_shards(fn, ob: torch.Tensor, slot_token: torch.Tensor,
                     slot_w: torch.Tensor) -> torch.Tensor:
    """The MoE combine on each shard's own experts: ``fn(ob, slot_token,
    slot_w, first)`` with ob (B, E, cap, D) this shard's experts from
    ``first`` on (its "model" shard of E) and the (B, E*cap) slot maps
    of its rows.  Where E is split, each shard's result is a partial sum
    (``Partial()``: reduce it with ``reduce_partial``), and so is the
    slot weights' gradient."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ob.device_mesh
    ob_pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
             for p in ob.placements]
    rows = row_placements(ob)
    experts = split_dims(ob, 1)
    part = [Partial() if i in experts else p for i, p in enumerate(rows)]
    first = shard_start(ob, 1, ob_pl)
    return local_map(lambda o, st, sw: fn(o, st, sw, first),
                     out_placements=part,
                     in_placements=(ob_pl, rows, rows),
                     in_grad_placements=(ob_pl, rows, part),
                     redistribute_inputs=True, device_mesh=mesh)(
        ob, slot_token, slot_w)


def full_tree(tree: M.Tree) -> M.Tree:
    """Every DTensor leaf gathered to a plain full tensor."""
    return M.tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                      tree)


# --- activation constraints -------------------------------------------------

class ActCtx:
    """Callable passed as ``ctx`` through the model: ``ctx(x, name)``
    puts a DTensor ``x`` in the reference's layout for ``name``."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, *,
                 seq_shard_resid: bool = True,
                 shard_moe_flat: bool = True):
        self.cfg = cfg
        self.mesh = mesh
        self.tp = _axis_size(mesh, "model")
        self.seq_shard_resid = seq_shard_resid
        self.shard_moe_flat = shard_moe_flat

    def _maybe(self, dim: int, axis) -> Optional[str]:
        if axis is None:
            return None
        n = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            n *= _axis_size(self.mesh, a)
        return axis if dim % n == 0 and n > 1 else None

    def spec(self, shape, name: str) -> Spec:
        """The reference's constraint for an activation of ``shape``."""
        ndim = len(shape)
        b = self._maybe(shape[0], _batch_spec(self.mesh, shape[0]))
        if name == "resid" and ndim == 3 and shape[1] > 1 \
                and self.seq_shard_resid:
            # sequence parallelism: residuals sharded on 'model' along seq
            return (b, self._maybe(shape[1], "model"), None)
        if name == "resid":                       # (B, S, D)
            return (b,) + (None,) * (ndim - 1)
        if name == "act_q" and ndim == 4:         # (B, S, H, hd)
            return (b, None, self._maybe(shape[2], "model"), None)
        if name == "moe_buf" and ndim == 4:       # (B, E, cap, D)
            return (b, self._maybe(shape[1], "model"), None, None)
        if name == "moe_flat" and ndim == 3:      # (B, S*K, D)
            tk = self._maybe(shape[1], "model") if self.shard_moe_flat \
                else None
            return (b, tk, None)
        if name == "logits":                      # (B, S, V) or (B, V)
            v = self._maybe(shape[-1], "model")
            if ndim == 3 and v is None:
                # a vocabulary not divisible by tp: shard the sequence
                # instead; the xent reduction stays local per position
                return (b, self._maybe(shape[1], "model"), None)
            return (b,) + (None,) * (ndim - 2) + (v,)
        return (b,) + (None,) * (ndim - 1)

    def __call__(self, x, name: str):
        if not is_dtensor(x):
            return x
        sh = NamedSharding(self.mesh, self.spec(tuple(x.shape), name))
        return x.redistribute(x.device_mesh, sh.placements)

    def scope(self):
        """The context a step runs in on the mesh: plain tensors the
        model makes (positions, masks, zeros) join DTensor operations as
        replicated."""
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()


def scope(ctx) -> contextlib.AbstractContextManager:
    """``ctx.scope()`` where the ctx has one, else a null context."""
    return ctx.scope() if hasattr(ctx, "scope") else contextlib.nullcontext()


# --- fleet-axis sharding (scan-superstep path) -------------------------------
#
# The surveillance fleet's folded (query, edge) row axis is embarrassingly
# parallel: the fused triage compacts escalations per ROW, and the Eqs.
# 8-9 recurrence is elementwise over rows — no collectives, so each shard
# of a 1-D ("fleet",) mesh (launch.mesh.make_fleet_mesh) runs the
# superstep kernel on its own rows and the result is bit-identical to one
# launch over all of them (system/superstep.py).

def fleet_axis_size(mesh: Mesh) -> int:
    return _axis_size(mesh, "fleet")


def can_shard_fleet(mesh: Mesh, padded_rows: int) -> bool:
    """Divisibility guard: the padded row bucket must split evenly across
    the fleet axis (power-of-two buckets make this true for any
    power-of-two device count <= the bucket)."""
    n = fleet_axis_size(mesh)
    return n > 1 and padded_rows % n == 0


def fleet_specs() -> Dict[str, Spec]:
    """Specs of the superstep slab, keyed by operand role.

    conf (S, R, N) and the triage outputs shard on the row axis R; the
    (R, 2) threshold carry, the (S, R) update mask and the (R,) per-row
    drain signal shard the same way; scalar gains replicate."""
    return {
        "conf": (None, "fleet", None),
        "thresholds": ("fleet", None),
        "mask": (None, "fleet"),
        "drain": ("fleet",),
        "gains": (None,),
        "ths_out": (None, "fleet", None),
        "routes": (None, "fleet", None),
        "slots": (None, "fleet", None),
    }
