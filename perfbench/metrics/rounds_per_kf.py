"""rounds_per_kf (update round): update rounds per keyframe step over the
traced window, from the frontend's counters (``update_rounds``,
``keyframe_steps``; the asynchronous step counts its rounds when it drains
the step's pack, one frame later)."""


def at_open(run):
    fe = run.system.frontend
    run.state["rounds"] = {"r0": fe.update_rounds, "k0": fe.keyframe_steps}


def at_close(run):
    fe = run.system.frontend
    run.state["rounds"].update(r1=fe.update_rounds, k1=fe.keyframe_steps)


def read(run):
    s = run.state.get("rounds")
    if not s or "k1" not in s or s["k1"] == s["k0"]:
        return None
    return (s["r1"] - s["r0"]) / (s["k1"] - s["k0"])
