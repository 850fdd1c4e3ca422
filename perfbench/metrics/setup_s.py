"""setup_s: from the process's start to the window's opening: imports, CUDA
start-up, the scene, the weights, the system, the kernels' build or load,
and the frames up to the configuration's window-opening events and the
warm frames after them."""


def read(run):
    return run.setup_s
