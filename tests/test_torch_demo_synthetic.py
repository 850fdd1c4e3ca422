"""The port's dataset-free demo end to end on the CPU, held to
``tests/test_slam_e2e.py::test_long_run_multisensor_stays_bounded``'s
assertions at its device-solver leg (34 frames, one LM pass, slow in the
JAX package): VI initialization runs, at least 14 keyframes, and the
SE3-aligned ATE of the body positions under 8 % of the trajectory's span."""

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def test_demo_synthetic_multisensor_device_solver(tmp_path):
    from dbaf_tpu_torch.apps.demo_synthetic import main
    from dbaf_tpu_torch.eval.traj_io import read_tum

    out = str(tmp_path / "traj.txt")
    res = main(["--frames", "34", "--multisensor", "--lm-iters", "1", "--device-solver",
                "--device", "cpu", "--traj_out", out])
    assert res["imu_enabled"]
    assert res["keyframes"] >= 14
    assert res["ate_pct_of_span"] < 8.0, res
    assert read_tum(out).shape == (res["keyframes"], 8)
