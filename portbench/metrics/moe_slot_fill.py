"""Share of the expert rows the decode MoE runs that hold a request's
choice, over the window's ticks: each tick's choices (the program's
``tick.active``, the slots that held a request, times the model's
``top_k`` and the ``moe`` spans under its ``tick.launch``) over the
expert rows its grouped products ran (``moe.slots``, summed in its
``tick.launch``)."""
import collections

from portbench import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    ticks, launches = w.decode()
    slots = w.counted(launches, "moe.slots")
    if not slots:
        return None
    active = w.counted(ticks, "tick.active")
    layers = collections.Counter(s.parent for s in w.under(launches, "moe"))
    chosen = sum(active.get(s.parent, 0) * layers[s.sid]
                 for s in launches if s.sid in slots)
    return 100.0 * chosen * run.model["top_k"] / sum(slots.values())
