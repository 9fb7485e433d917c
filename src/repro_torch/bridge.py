"""State bridge: rebuild the port's run inputs from plain data.

What crosses from another implementation of the system into
``repro_torch`` is the run's state — the ``Scenario`` and its detection
stream — and, for the pixel path, the CQ classifier's weights.  All of it
crosses as plain data (``dataclasses.asdict`` of the other side's
objects, nested dicts of numpy arrays), never as the objects themselves,
so this module needs nothing but the port:

    sc = scenario_from_fields(dataclasses.asdict(other_scenario))
    items = items_from_records(dataclasses.asdict(it) for it in other_items)
    params = cq_params_from_numpy(numpy_tree)   # -> PixelFrontend(params=)
    params = params_from_numpy(cfg, numpy_tree) # -> CascadeServer, prefill

Running the port on exactly the stream another run consumed separates
pipeline parity from stream parity; running it on another side's weights
separates scoring parity from initialisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch

from repro_torch.models import meta as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.api import TenantSpec, TierSpec
from repro_torch.serving.simulator import Item
from repro_torch.system.pixel_frontend import cq_config
from repro_torch.system.queries import QuerySpec
from repro_torch.system.scenario import Scenario

#: Scenario fields that hold nested dataclasses, and what rebuilds each
_NESTED = {"queries": QuerySpec, "tiers": TierSpec, "tenants": TenantSpec}


def items_from_records(rows: Iterable[Mapping[str, Any]]) -> List[Item]:
    """Port ``Item``s from ``dataclasses.asdict`` records of items."""
    return [Item(**row) for row in rows]


def scenario_from_fields(d: Mapping[str, Any]) -> Scenario:
    """A port ``Scenario`` from ``dataclasses.asdict`` of a scenario.

    Nested ``QuerySpec``/``TierSpec``/``TenantSpec`` records and an
    injected ``items`` stream are rebuilt too.  Unknown field names raise
    ``TypeError`` (the two sides' schemas must agree field for field)."""
    known = {f.name for f in dataclasses.fields(Scenario)}
    extra = set(d) - known
    if extra:
        raise TypeError(f"fields the port's Scenario does not have: "
                        f"{sorted(extra)}")
    kw: Dict[str, Any] = dict(d)
    for name, cls in _NESTED.items():
        if name in kw:
            kw[name] = tuple(cls(**row) for row in kw[name])
    if kw.get("items") is not None:
        kw["items"] = items_from_records(kw["items"])
    return Scenario(**kw)


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any]) -> M.Tree:
    """The port's parameters of ``cfg`` from a nested dict of numpy arrays
    with the reference's structure (layer weights stacked on a leading
    ``num_layers`` axis), as f32 CPU tensors.

    Every leaf path and shape must match ``models.meta.model_meta(cfg)``;
    a missing, extra or misshapen leaf raises ``ValueError``."""
    want = {path: meta.shape for path, meta in M.leaves(M.model_meta(cfg))}
    got = {path: np.shape(leaf) for path, leaf in M.leaves(dict(tree))}
    if set(got) != set(want):
        raise ValueError(f"parameter tree leaves differ from {cfg.name}'s: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    bad = {p: (got[p], want[p]) for p in want if tuple(got[p]) != want[p]}
    if bad:
        raise ValueError(f"parameter shapes (got, want) differ from "
                         f"{cfg.name}'s: {bad}")
    return M.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)),
        dict(tree))


def cq_params_from_numpy(tree: Mapping[str, Any]) -> M.Tree:
    """``params_from_numpy`` of the pixel frontend's CQ config."""
    return params_from_numpy(cq_config(), tree)
