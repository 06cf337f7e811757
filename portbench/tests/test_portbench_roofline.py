"""The frozen count from the call's shape equals the program's roofline.pair_bound (from
its own tables) at the shapes of PERF.md's kernel table."""
import numpy as np
import pytest
import torch

from portbench.harness import roofline

# (lmax, spin, two inputs, rings, batch, f64, bound ms in PERF.md's table)
SHAPES = [(2048, 1, True, 3073, 8, False, 6.167),     # K1/K2 on the f32 QE grid
          (2048, 1, True, 3073, 4, False, 3.084),
          (2048, 0, False, 2049, 8, True, 1.028),     # CinvT
          (2048, 2, True, 2049, 4, True, 2.056),      # CinvP
          (2048, 0, False, 2049, 4, True, 0.514),     # CinvTP mode 0
          (2048, 2, True, 2049, 1, True, 0.633)]      # lensed E/B map2alm


@pytest.mark.parametrize('lmax,spin,two,nrings,B,f64,perf_ms', SHAPES)
def test_pair_bound_matches_the_program(lmax, spin, two, nrings, B, f64, perf_ms):
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    from plancklens_tpu_torch.ops.sht import roofline as prog
    theta = gl_geometry(nrings - 1).theta[:(nrings + 1) // 2]
    t_m = core.tables_to_device(core.recursion_tables(lmax, lmax, -spin, theta), 'cpu')
    tabs = (t_m,) if spin == 0 else \
        (t_m, core.tables_to_device(core.recursion_tables(lmax, lmax, spin, theta), 'cpu'))
    want, by = prog.pair_bound(tabs, 0 if spin == 0 and not two else 1, B, nrings, f64)
    got, by2 = roofline.pair_bound(lmax, 0, lmax + 1, spin, two, nrings, B, f64)
    assert by == by2
    assert got * 1e3 == pytest.approx(want, rel=1e-12)
    assert got * 1e3 == pytest.approx(perf_ms, abs=6e-4)


def test_plain_bound_matches_the_program():
    from plancklens_tpu_torch.ops.sht import core
    from plancklens_tpu_torch.ops.sht import roofline as prog
    theta = np.linspace(0.1, 3.0, 301)
    t = core.tables_to_device(core.recursion_tables(256, 256, -2, theta), 'cpu')
    want, by = prog.plain_bound(t, 4, 301, True)
    got, by2 = roofline.plain_bound(256, 0, 257, -2, 301, 4, True)
    assert by == by2 and got * 1e3 == pytest.approx(want, rel=1e-12)
    # K3/K4 on all 8191 rings of HEALPix nside 2048, f64, batch 4: PERF.md's 4.108 ms
    got, _ = roofline.plain_bound(2048, 0, 2049, -2, 8191, 4, True)
    assert got * 1e3 == pytest.approx(4.108, abs=6e-4)


def test_m_block_columns():
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    from plancklens_tpu_torch.ops.sht import roofline as prog
    theta = gl_geometry(64).theta[:33]
    tabs = tuple(core.tables_to_device(core.recursion_tables(64, 63, n, theta, 20), 'cpu')
                 for n in (-1, 1))
    want, _ = prog.pair_bound(tabs, 1, 2, 65, True)
    got, _ = roofline.pair_bound(64, 20, 44, 1, True, 65, 2, True)
    assert got * 1e3 == pytest.approx(want, rel=1e-12)
    assert torch.__version__
