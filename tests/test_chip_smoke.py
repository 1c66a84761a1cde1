"""chip_smoke.py's phases at a tiny size on the CPU, kernels in
interpret mode: the same control flow, comparisons and tolerances the
card runs at 1200x600, so a wrong path or argument shows here first."""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs


def test_smoke_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_walled_small():
    cs.phase_walled(jax.devices()[0], width=64, height=32, spp=4, interpret=True)


def test_smoke_mesh_small():
    cs.phase_mesh(jax.devices()[0], width=64, height=32, spp=2, interpret=True, small=True)


def test_smoke_gradients_small():
    cs.fd_check(*cs.phase_gradients(jax.devices()[:1], 32, 16)[:-1])


def test_smoke_multi_small():
    devices = jax.devices()[:4]
    if len(devices) < 4:
        pytest.skip("needs 4 (virtual) devices")
    cs.phase_multi(devices, width=64, height=32, interpret=True, small=True)


def test_compare_hits_tie_rule():
    """Id mismatches pass only where both hits lie at the same distance."""
    import numpy as np

    t = np.array([1.0, 2.0, np.inf], np.float32)
    i = np.array([3, 4, -1], np.int32)
    cs.compare_hits((t, i), (t.copy(), np.array([5, 4, -1], np.int32)), "tie")
    with pytest.raises(AssertionError):
        cs.compare_hits((t * np.float32(1.000005), i), (t, np.array([5, 4, -1], np.int32)), "far")
