"""The program's spans (``tensoir_tpu_torch.profiling.span``) in the events
of a traced span (``trace.profile_span``): the device time of each span
the program opened, the backward's included, and the card's idle time
inside the march's spans. Additive to ``trace.reduce_events``, over the same events and the
same device operations.

- A device operation belongs to the host operation that launched it: the
  profiler lists it among that operation's ``kernels``.
- Launched inside an autograd node (``autograd::engine::evaluate_function:
  ...``), it is backward. The node's ``sequence_nr`` is the one the forward
  operation that built it recorded on the node's ``fwd_thread``; the
  operation's device time goes to the spans open when that operation ran.
- A forward operation that autograd's own thread ran (the inner gradient of
  the derived normals, under ``create_graph``) has no span of its own
  thread: it takes those open at the same moment on the thread that built
  the graph that node belongs to, which waited for it.
- Idle inside a span: its host intervals less the union of the device's
  operation intervals (the union ``busy_s`` is).
"""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from portbench.harness.trace import RANGES, SPAN, _is_device

NODE = "autograd::engine::evaluate_function: "
# the spans whose device ms the per-layer numbers read, and those whose
# idle time is reduced
SPAN_MS = ("primary", "field", "plane_pack", "mlp_inputs")
SPAN_IDLE = ("secondary_march", "visibility")


class _Open:
    """Intervals (start, end, payload) per thread, asked which of them
    contain given moments."""

    def __init__(self, items):
        self.by_thread = defaultdict(list)
        for thread, a, b, payload in items:
            self.by_thread[thread].append((a, b, payload))
        for ivs in self.by_thread.values():
            ivs.sort(key=lambda iv: (iv[0], -iv[1]))

    def at(self, queries) -> list:
        """For each (thread, t): the payloads of the intervals of that
        thread that contain t, outermost first."""
        out = [()] * len(queries)
        order = sorted(range(len(queries)), key=lambda i: queries[i])
        thread, ivs, i, stack = None, [], 0, []
        for q in order:
            th, t = queries[q]
            if th != thread:
                thread, ivs, i, stack = th, self.by_thread.get(th, []), 0, []
            while i < len(ivs) and ivs[i][0] <= t:
                while stack and stack[-1][1] < ivs[i][0]:
                    stack.pop()
                stack.append(ivs[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[q] = tuple(iv[2] for iv in stack if iv[1] >= t)
        return out


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(merged, a: float, b: float) -> float:
    """Length of [a, b] that the sorted disjoint intervals cover."""
    k = max(bisect_right(merged, [a]) - 1, 0)
    total = 0.0
    while k < len(merged) and merged[k][0] < b:
        total += max(0.0, min(b, merged[k][1]) - max(a, merged[k][0]))
        k += 1
    return total


def _outermost(events) -> list:
    """The instances not inside another of the same name on their
    thread."""
    out = []
    by = defaultdict(list)
    for e in events:
        by[(e.name, e.thread)].append(e)
    for evs in by.values():
        end = None
        for e in sorted(evs, key=lambda e: (e.time_range.start,
                                            -e.time_range.end)):
            if end is None or e.time_range.start > end:
                out.append(e)
                end = e.time_range.end
    return out


def reduce_spans(events) -> dict:
    cpu = [e for e in events if not _is_device(e)]
    annot = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    skip = set(RANGES) | {SPAN} | annot
    dev = [e for e in events if _is_device(e) and e.name not in skip
           and e.time_range.end > e.time_range.start]
    spans = [e for e in cpu if getattr(e, "is_user_annotation", False)
             and e.name != SPAN]
    nodes = [e for e in cpu if e.name.startswith(NODE)]
    open_spans = _Open((e.thread, e.time_range.start, e.time_range.end,
                        e.name) for e in spans)
    open_nodes = _Open((e.thread, e.time_range.start, e.time_range.end, e)
                       for e in nodes)
    # the forward operations that may have built a node: by thread and
    # sequence number, in the order they started
    built = defaultdict(list)
    for e in cpu:
        if getattr(e, "sequence_nr", -1) >= 0 and not e.name.startswith(NODE):
            built[(e.thread, e.sequence_nr)].append(e)

    def forward_op(node):
        fn = node.name[len(NODE):]
        best = None
        for e in built.get((node.fwd_thread, node.sequence_nr), ()):
            if (e.name != fn and e.time_range.start <= node.time_range.start
                    and (best is None
                         or e.time_range.start > best.time_range.start)):
                best = e
        return best

    def spans_of(hosts):
        """The spans open when each host operation started; on a thread
        with none, inside a node built elsewhere, those of the node's
        forward thread at that moment."""
        qs = [(h.thread, h.time_range.start) for h in hosts]
        names = open_spans.at(qs)
        inner = open_nodes.at(qs)
        again = [k for k, h in enumerate(hosts) if not names[k] and inner[k]
                 and inner[k][-1].fwd_thread != h.thread]
        for k, found in zip(again, open_spans.at(
                [(inner[k][-1].fwd_thread, qs[k][1]) for k in again])):
            names[k] = found
        return names

    # each host operation's own kernels (the profiler links them to the
    # operation that launched them)
    launched = []
    for e in cpu:
        us = sum(k.duration for k in getattr(e, "kernels", ())
                 if k.name not in skip)
        if us > 0 and e.name not in annot:
            launched.append((e, us))
    node_of = [n[-1] if n else None for n in open_nodes.at(
        [(op.thread, op.time_range.start) for op, _ in launched])]
    fwd_of = {}
    for n in node_of:
        if n is not None and id(n) not in fwd_of:
            fwd_of[id(n)] = forward_op(n)
    hosts = [fwd_of[id(n)] if n is not None else op
             for (op, _), n in zip(launched, node_of)]
    found = [k for k, h in enumerate(hosts) if h is not None]
    names = [()] * len(hosts)
    for k, s in zip(found, spans_of([hosts[k] for k in found])):
        names[k] = s

    span_us = {e.name: {"forward": 0.0, "backward": 0.0} for e in spans}
    back_us = charged_us = linked_us = 0.0
    for (_, us), n, s in zip(launched, node_of, names):
        linked_us += us
        part = "forward" if n is None else "backward"
        if n is not None:
            back_us += us
            charged_us += us if s else 0.0
        for name in set(s):
            span_us[name][part] += us

    merged = _union((d.time_range.start, d.time_range.end) for d in dev)
    idle = {}
    for e in _outermost([e for e in spans if e.name in SPAN_IDLE]):
        a, b = e.time_range.start, e.time_range.end
        w = idle.setdefault(e.name, {"wall_ms": 0.0, "idle_ms": 0.0})
        w["wall_ms"] += (b - a) / 1e3
        w["idle_ms"] += (b - a - _covered(merged, a, b)) / 1e3
    return {"span_ms": {s: {k: v / 1e3 for k, v in p.items()}
                        for s, p in span_us.items()},
            "backward_ms": {"total": back_us / 1e3,
                            "charged": charged_us / 1e3},
            "unlinked_ms": (sum(d.time_range.end - d.time_range.start
                                for d in dev) - linked_us) / 1e3,
            "span_idle": idle}


def _per(red: dict, ms: float, per_krays: bool) -> float:
    return ms / red["rays"] * 1e3 if per_krays else ms / red["units"]


def metrics(red: dict, per_krays: bool) -> dict:
    """The per-layer numbers of a reduction (``reduce_spans`` over a span
    of ``units`` steps or chunks of ``rays`` camera rays): device ms per
    step (``.train``) or per 1,000 camera rays (``.render``) of each span,
    forward and backward; the backward's ms per step; the share of the
    march's span (``visibility`` in relighting, else ``secondary_march``)
    in which the card was idle. A span the program did not open is left
    out."""
    tag = "render" if per_krays else "train"
    out = {}
    if not per_krays:
        out["backward_ms.train"] = red["backward_ms"]["total"] / red["units"]
    for name in SPAN_MS:
        p = red["span_ms"].get(name)
        if p is not None:
            out[f"{name}_ms.{tag}"] = _per(red, p["forward"] + p["backward"],
                                           per_krays)
    for name in ("visibility", "secondary_march"):
        w = red["span_idle"].get(name)
        if w and w["wall_ms"] > 0:
            out[f"march_idle_pct.{tag}"] = w["idle_ms"] / w["wall_ms"] * 100.0
            break
    return out
