"""The asynchronous steps' device row moves (``DepthVideo.move_rows_device``
and ``rollup_device``, ``dbaf_tpu_torch/slam/video.py``) against the
synchronous flow's host moves on the same seeded video: ``rm_keyframe``,
``rollup`` and the frontend's whole roll of a slot-keyed aux leaf
(``torch.roll``).  Index moves, so exact.
"""

import pytest
import torch

from dbaf_tpu_torch.slam.video import DepthVideo
from dbaf_tpu_torch.utils.config import DBAFusionConfig, FrontendConfig

B = 16


def _video(seed: int = 0) -> DepthVideo:
    cfg = DBAFusionConfig(image_size=(32, 48), buffer=B,
                          frontend=FrontendConfig(rollup_start=9, rollup_shift=4))
    v = DepthVideo(cfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for name in v._SHIFT_BUFFERS:
        buf = getattr(v, name)
        buf.copy_(torch.randn(buf.shape, generator=g).to(buf.dtype))
    return v


def _rows(v: DepthVideo, n: int = B):
    return {name: getattr(v, name)[:n].clone() for name in v._SHIFT_BUFFERS}


def _assert_rows_equal(a: dict, b: dict):
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("roll", [False, True], ids=["no_roll", "roll"])
def test_rollup_device_matches_the_host_rollup(roll):
    """The rows that can be live (below ``rollup_start + 1 - rollup_shift``
    after the roll) equal the host's; a shift of 0 moves nothing; a
    slot -> frame map rolls whole, so the slots later keyframes take keep
    their frames; other aux leaves and the caller's dict are untouched."""
    host, dev = _video(), _video()
    fc = host.cfg.frontend
    r = fc.rollup_shift if roll else 0
    id_map = torch.arange(B)
    other = torch.zeros(3)
    aux = {"id_map": id_map, "other": other}
    if roll:
        host.rollup(r)
    got = dev.rollup_device(torch.tensor(r), aux)
    n_live = fc.rollup_start + 1 - fc.rollup_shift
    _assert_rows_equal(_rows(dev, n_live if roll else B), _rows(host, n_live if roll else B))
    assert torch.equal(got["id_map"], torch.roll(torch.arange(B), -r))
    assert got["other"] is other
    assert aux["id_map"] is id_map and torch.equal(id_map, torch.arange(B))


@pytest.mark.parametrize("n,on", [(1, True), (2, True), (2, False)],
                         ids=["one_row", "two_rows", "off"])
def test_move_rows_device_matches_rm_keyframe(n, on):
    """A cull's moves at device indices: the visual step moves one row
    (``ixc + 1 -> ixc``), the coupled step the two above the culled slot;
    every row equals the host's ``copy_row`` moves, and nothing moves
    where the flag is off."""
    host, dev = _video(), _video()
    c = 5
    if on:
        for k in range(n):
            host.copy_row(c + k, c + k + 1)
    dst = c + torch.arange(n)
    aux = dev.move_rows_device(dst, dst + 1, torch.tensor(on), {"id_map": torch.arange(B)})
    _assert_rows_equal(_rows(dev), _rows(host))
    want = torch.arange(B)
    if on:
        want[c:c + n] = torch.arange(c + 1, c + n + 1)
    assert torch.equal(aux["id_map"], want)
