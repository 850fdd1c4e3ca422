"""lm_iters_per_pass (factor graph, ``fusion/device_graph.py``): realized
Levenberg-Marquardt iterations per LM pass over the traced window.  The
asynchronous coupled pipeline counts them on the device (its ``stats()``,
read at the window's ends); a synchronous coupled step leaves them in the
graph's ``lm_stats`` (rounds x passes), read after each frame that ran
one, as the port's smoke phase 5 reads it."""


def _async(run):
    ca = run.system.frontend._casync
    return ca if ca is not None and ca.active else None


def at_open(run):
    ca = _async(run)
    st = ca.stats() if ca is not None else None
    run.state["lm"] = dict(iters=0, passes=0, ca=ca, st0=st,
                           megas=run.system.graph.mega_count, active=ca is not None)


def after_frame(run):
    s, g = run.state["lm"], run.system.graph
    active = _async(run) is not None
    if not (active and s["active"]) and g.mega_count > s["megas"] and g.lm_stats is not None:
        lm = g.lm_stats.cpu()
        s["iters"] += int(lm.sum())
        s["passes"] += int((lm > 0).sum())
    s["megas"], s["active"] = g.mega_count, active


def at_close(run):
    s = run.state["lm"]
    ca = s["ca"]
    if ca is not None and s["st0"] is not None:
        st = ca.stats()
        s["iters"] += st["lm_iters"] - s["st0"]["lm_iters"]
        s["passes"] += st["lm_passes"] - s["st0"]["lm_passes"]


def read(run):
    s = run.state.get("lm")
    if not s or s["passes"] == 0:
        return None
    return s["iters"] / s["passes"]
