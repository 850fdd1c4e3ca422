"""Every module of the port's output surface imports where cv2, h5py and
matplotlib are missing (the card's machine has none of them), and the
functions that need one raise ``ImportError`` naming it when called.  The
parallel layer's modules import without JAX and without creating a process
group.

Each case runs in a fresh interpreter whose ``sys.modules`` maps the three
libraries to ``None`` (an import of them raises), so a module that imported
one at its top fails its import there.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "dbaf_tpu_torch.utils.profiling", "dbaf_tpu_torch.data.streams", "dbaf_tpu_torch.data.hdf5",
    "dbaf_tpu_torch.eval.monitor", "dbaf_tpu_torch.eval.visualize", "dbaf_tpu_torch.apps.runner",
    "dbaf_tpu_torch.apps.demo_tumvi", "dbaf_tpu_torch.apps.demo_kitti360",
    "dbaf_tpu_torch.apps.demo_whu", "dbaf_tpu_torch.apps.demo_subt",
    "dbaf_tpu_torch.apps.batch_tumvi", "dbaf_tpu_torch.apps.batch_kitti360",
    "dbaf_tpu_torch.apps.batch_whu", "dbaf_tpu_torch.apps.batch_subt",
    "dbaf_tpu_torch.slam.frontend", "dbaf_tpu_torch.slam.system",
    "dbaf_tpu_torch.slam.coupled_async",
]

PRELUDE = "import sys\nfor m in ('cv2', 'h5py', 'matplotlib'):\n    sys.modules[m] = None\n"


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_new_modules_import_without_cv2_h5py_matplotlib():
    code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in MODULES)
    code += ("assert not any(m in sys.modules and sys.modules[m] is not None "
             "for m in ('cv2', 'h5py', 'matplotlib', 'jax', 'dbaf_tpu'))\nprint('ok')\n")
    assert _run(code).strip() == "ok"


PARALLEL = ["dbaf_tpu_torch.parallel", "dbaf_tpu_torch.parallel.dist",
            "dbaf_tpu_torch.parallel.mesh", "dbaf_tpu_torch.parallel.shard_ba",
            "dbaf_tpu_torch.parallel.dist_worker", "dbaf_tpu_torch.parallel.collectives",
            "dbaf_tpu_torch.parallel.launch"]


def test_parallel_modules_import_without_jax_or_a_process_group():
    """``dbaf_tpu_torch.parallel.*`` (and its lazy exports) import without
    JAX and create no process group: one must exist only once a job is
    joined (``dist.initialize``) or a mesh is made."""
    code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in PARALLEL)
    code += ("import dbaf_tpu_torch.parallel as par\n"
             "for name in par._EXPORTS:\n    getattr(par, name)\n"
             "import torch.distributed as dist\n"
             "assert not dist.is_initialized()\n"
             "assert not any(m in sys.modules for m in ('jax', 'dbaf_tpu'))\nprint('ok')\n")
    assert _run(code).strip() == "ok"


@pytest.mark.parametrize("call,library", [
    ("from dbaf_tpu_torch.data.streams import image_stream\n"
     "next(image_stream('.', 'calib.txt'))", "cv2"),
    ("from dbaf_tpu_torch.data.hdf5 import h5_stream\nnext(h5_stream('frames.h5'))", "h5py"),
    ("from dbaf_tpu_torch.eval.monitor import Monitor\n"
     "import tempfile\nMonitor(tempfile.mkdtemp()).dump_summary()", "matplotlib"),
])
def test_a_missing_library_is_named(call, library):
    code = f"try:\n    exec({call!r})\nexcept ImportError as e:\n    print(e.name)\n"
    assert _run(code).strip() == library
