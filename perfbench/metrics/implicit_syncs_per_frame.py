"""implicit_syncs_per_frame (coupled step): synchronising CUDA calls the
program makes inside ``DBAFusion.track`` outside its deliberate waits
(CUDA's sync debug mode ``"warn"``, counted by the program's tracer:
``TRACER.syncs``), over the window's frames (``perfbench/spans.py``)."""

from perfbench import spans

at_open, at_close = spans.at_open, spans.at_close


def read(run):
    w = spans.window(run)
    return None if w is None else w.syncs / w.frames
