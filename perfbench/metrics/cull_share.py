"""cull_share (coupled step: ``slam/frontend.py`` ``_cull``, the drained
packs of ``slam/coupled_async.py``): keyframe culls the host learned of in
the window, over the window's frames, in %, from the frontend's counter
(``Frontend.culls``).  The asynchronous step learns of a cull when it
drains the step's pack, one frame later."""


def at_open(run):
    run.state["culls"] = {"c0": run.system.frontend.culls}


def at_close(run):
    run.state["culls"]["c1"] = run.system.frontend.culls


def read(run):
    s = run.state.get("culls")
    if not s or "c1" not in s or not run.work["frames"]:
        return None
    return 100.0 * (s["c1"] - s["c0"]) / run.work["frames"]
