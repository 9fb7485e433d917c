"""State bridge: rebuild the port's run inputs from plain data.

The confidence-stream path has no learned parameters, so what crosses from
another implementation of the system into ``repro_torch`` is the run's
state: the ``Scenario`` and its detection stream.  Both cross as plain
data — ``dataclasses.asdict`` of the other side's objects — never as the
objects themselves, so this module needs nothing but the port:

    sc = scenario_from_fields(dataclasses.asdict(other_scenario))
    items = items_from_records(dataclasses.asdict(it) for it in other_items)

Running the port on exactly the stream another run consumed separates
pipeline parity from stream parity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping

from repro_torch.serving.api import TenantSpec, TierSpec
from repro_torch.serving.simulator import Item
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
