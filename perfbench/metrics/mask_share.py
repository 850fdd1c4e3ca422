"""mask_share (update round, ``slam/graph.py::round_weights``): of the
window's active edge-rounds, the share whose edge the short-baseline mask
down-weighted (x1e-3: its frames less than ``graph.mask_threshold`` apart,
under the IMU), in %.  The masked ones are the program's tracer's
``masked_edges``, a device sum kept while tracing is on and read once from
the marks at the window's ends (``perfbench/spans.py``); the edge-rounds
are the harness's (``run.work``, the rounds the frontend counts times the
active edges).  Rounds that the asynchronous step runs before its cull
decision is in and then undoes count in the first and not in the second.
A program without the counter reads nothing."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    opened = run.state.get("spans", {}).get("open", {})
    if w is None or "masked_edges" not in opened or not run.work["edge_rounds"]:
        return None
    o, c = opened["masked_edges"], w.closed["masked_edges"]
    masked = (0 if c is None else int(c)) - (0 if o is None else int(o))
    return 100.0 * masked / run.work["edge_rounds"]
