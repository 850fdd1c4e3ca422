"""Multi-process scale-out layer on ``torch.distributed`` (port of
``dbaf_tpu/parallel``).

Lazy exports: importing this package creates no process group and loads
no submodule; the submodules load on first attribute access.
"""

_EXPORTS = {
    "make_mesh": "mesh",
    "make_mesh_2d": "mesh",
    "sharded_ba_step": "mesh",
    "sharded_feature_step": "mesh",
    "make_sharded_ba_iteration": "shard_ba",
}

_SUBMODULES = ("mesh", "shard_ba", "dist", "dist_worker", "collectives", "launch")


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
