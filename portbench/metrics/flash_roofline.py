"""The flash-attention kernel's share of its roofline in the traced
slice: the least time of each launch (``portbench/roofline.py``, from
its shape) summed, over the device time of the launches.  Every cloud
admission in the slice launches the kernel once a layer at (1, heads,
kv_heads, S, S, head_dim), and every edge triage once an edge layer at
the edge's heads; the reader finds the launches by the kernel's names
and gives nothing where their count is not that sum."""
import re

from portbench.roofline import KERNELS, bound_s

NAME = re.compile(r"\b(tc_kernel|tc_bf16_kernel|simt_kernel)<")


def _bounds(m, lengths):
    return [bound_s(*KERNELS["flash"](1, m["num_heads"], m["num_kv_heads"],
                                      S, S, m["head_dim"]))
            for S in lengths for _ in range(m["num_layers"])]


def read(run):
    tr = run.trace
    if tr is None or not (tr["admits"] or tr["submits"]):
        return None
    times = [d for name, _, d in tr["kernels"] if NAME.search(name)]
    bounds = _bounds(run.model, tr["admits"]) + _bounds(run.edge,
                                                        tr["submits"])
    if len(times) != len(bounds) or not times:
        return None
    return 100.0 * sum(bounds) / sum(times)
