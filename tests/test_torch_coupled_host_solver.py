"""The coupled scenario of ``test_torch_coupled.py`` (26 frames, VIO,
oracle update operator) on the port's host f64 solver
(``device_solver=False``), held to the JAX test's accuracy asserts
(``test_slam_multisensor.py:122-143``): VI initialization runs, the
SE3-aligned ATE under 8 % of the span, every |bias| under 0.2, the plane's
disparity within 0.8-1.25 of truth.  It needs no JAX run, so it has a file
of its own."""

from tests.test_torch_coupled import _accuracy_asserts, _port_run, _scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def test_coupled_e2e_host_solver():
    scene = _scene()
    got = _port_run(scene, device_solver=False)
    assert got["megas"] == 0  # the host f64 path never takes the fused step
    _accuracy_asserts(got, scene[3])
