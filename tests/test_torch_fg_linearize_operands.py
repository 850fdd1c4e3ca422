"""The hand kernel's wrapper (``fusion/device_graph.py::_kernel_operands``) on
the CPU: the operands it hands the kernel, in the order of the kernel's
``FgLinearizeArgs`` (``csrc/fg_linearize.cu``), each contiguous and of the
dtype the kernel reads, and the inputs it refuses before any launch.  The
kernel itself runs only on the card (``tests/test_torch_linearize_cuda.py``)."""

import os.path as osp
import re

import pytest
import torch

from dbaf_tpu_torch.fusion import device_graph as tdg
from dbaf_tpu_torch.utils import cuda_build
from tests.lm_windows import lm_inputs


def test_the_operand_order_and_limits_are_the_kernels():
    with open(osp.join(cuda_build.CSRC, "fg_linearize.cu")) as f:
        src = f.read()
    body = re.search(r"struct FgLinearizeArgs \{(.*?)\};", src, re.S).group(1)
    assert tuple(re.findall(r"(\w+);", body)) == tdg.KERNEL_OPERANDS
    limits = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", src))
    assert limits == {"kMaxFrames": str(tdg.MAX_FRAMES), "kMaxPriors": str(tdg.MAX_PRIORS)}
    assert "fg_linearize" in cuda_build.KERNELS
    assert set(cuda_build._SIGNATURES) == set(cuda_build.KERNELS)


@pytest.mark.parametrize("with_marginal", [True, False])
def test_the_operands_in_order_contiguous_and_typed(with_marginal):
    st, pg, vH, vv, lR, lt, mgd = lm_inputs(nw=8, n=5, seed=7)
    # the state as the coupled step holds it: strided views of the flat rows
    st = tdg.unflatten_state(tdg.flatten_state(st), 5, 8)
    assert not st.R.is_contiguous()
    ins, dims = tdg._kernel_operands(st, pg, vH, vv, lR, lt, None if not with_marginal else mgd)
    assert dims == (8, 4, 4)
    assert len(ins) == len(tdg.KERNEL_OPERANDS) - 4  # the outputs come from the wrapper
    given = [*st, *pg, vH, vv, lR, lt, *(mgd if with_marginal else (None,) * 4)]
    for name, x, y in zip(tdg.KERNEL_OPERANDS, ins, given):
        if y is None:
            assert x is None, name
            continue
        assert x.is_contiguous() and torch.equal(x, y), name
        want = torch.bool if name.endswith(("mask", "valid")) else (
            torch.int64 if name.endswith("frame") else torch.float32)
        assert x.dtype == want, name


def _refused(st, pg, vH, vv, lR, lt, mgd):
    with pytest.raises(ValueError, match="linearize"):
        tdg._kernel_operands(st, pg, vH, vv, lR, lt, mgd)


REFUSALS = {
    "f64_visual": lambda a: a[:2] + (a[2].double(),) + a[3:],
    "f64_state": lambda a: (a[0]._replace(t=a[0].t.double()),) + a[1:],
    "int32_frames": lambda a: (a[0], a[1]._replace(pp_frame=a[1].pp_frame.int())) + a[2:],
    "float_mask": lambda a: (a[0], a[1]._replace(imu_mask=a[1].imu_mask.float())) + a[2:],
    "marginal_shape": lambda a: a[:6] + (a[6]._replace(H=a[6].H[:-15, :-15]),),
    "too_many_priors": lambda a: (a[0], a[1]._replace(
        **{k: torch.cat([getattr(a[1], k)] * 17) for k in
           ("pp_mask", "pp_frame", "pp_R", "pp_t", "pp_info")})) + a[2:],
}


@pytest.mark.parametrize("case", REFUSALS)
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    st, pg, vH, vv, lR, lt, mgd = lm_inputs(nw=8, n=5, seed=7)
    _refused(*REFUSALS[case]((st, pg, vH, vv, lR, lt, mgd)))


def test_the_window_sizes_the_kernel_takes():
    """2 frames up to MAX_FRAMES (at least the 64 asked of it); one frame
    has no IMU factor slot and is refused."""
    assert tdg.MAX_FRAMES >= 64
    st, pg, vH, vv, lR, lt, mgd = lm_inputs(nw=2, n=2, seed=5)
    ins, dims = tdg._kernel_operands(st, pg, vH, vv, lR, lt, mgd)
    assert dims == (2, 4, 4)
    one = tdg.FgState(*(x[:1] for x in st))
    _refused(one, pg, vH, vv, lR, lt, None)
