"""The port's POA kernel module against the Pallas kernel it replaces
(interpret mode) and the numpy oracle in abPOA banded mode: stored windows
that move off column 0, K=2 stacked banded input, and a band wider than the
window.  Helpers and tolerance (none) as in test_torch_poa_win.py."""
import numpy as np
import pytest

from smoothxg_tpu.ops.poa_host import POAParams

from test_poa_pallas_win import family
from test_torch_poa_win import P_DEF, _check_block, _run


@pytest.mark.parametrize("local", [True, False])
def test_banded_offsets_match(local):
    """W < V: late rows move their window off column 0."""
    rng = np.random.default_rng(11)
    blocks = [family(rng, 600, 4)]
    p = POAParams(*P_DEF, local=local, wb=40, wf_milli=30)
    res = _run(blocks, [p], 1, 1024, 768, 384, 8, local, True)
    got = _check_block(res, 0, blocks[0], p, 1024, 768, 8)
    assert got[0][0] > 384, "fixture too small: no row moved its window"


def test_banded_stacked_k2_matches():
    rng = np.random.default_rng(23)
    blocks = [family(rng, 500, 4), family(rng, 420, 5)]
    p = POAParams(*P_DEF, local=False, wb=40, wf_milli=30)
    res = _run(blocks, [p] * 2, 2, 1024, 640, 384, 8, False, True)
    for b, sq in enumerate(blocks):
        _check_block(res, b, sq, p, 1024, 640, 8)


def test_band_wider_than_window_overflows():
    """A band wider than the stored window sets the overflow flag in both
    kernels, and the port's overflowed outputs are canonical."""
    rng = np.random.default_rng(3)
    blocks = [family(rng, 500, 3)]
    p = POAParams(*P_DEF, local=False, wb=200, wf_milli=30)
    pal, port = _run(blocks, [p], 1, 1024, 640, 256, 8, False, True)
    assert pal[0][0, 1] == 1
    assert port[0][0].tolist() == [0, 1, 3, 0]
    assert (port[1][0] == -1).all() and (port[2][0] == -1).all()
