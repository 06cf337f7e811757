"""Port parity of the lensed simulation libraries, f64 on the CPU. Both packages get the
reference's unit phases (compat.phases_from_numpy) and unit pixel-noise maps
(compat.noise_from_numpy), as numpy:

  * `CMBLenLib` maps and alms (T, Q/U, t/e/b/p/o lm) with and without a curl potential
    deflecting the maps: <= 1e-10 of max (never bitwise: tests/test_parity_accessors.py's
    array_equal of two lensings is the reference's known flaky test);
  * `MapsLenNlevLib` maps with the injected noise <= 1e-10, the noise-only maps and
    `ninv_t`/`ninv_p` <= 1e-12; the port's own noise generator: per (seed, idx, tag),
    reproducible, unit variance;
  * `qecl.InputPlmLib` and `n0s.gauss_beam`.
The port's parameter file runs on the CPU in tests/test_torch_lensed_chain.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile
from plancklens_tpu.ops.sht import gl_geometry as rgl
from plancklens_tpu.models import sims as rsims, qecl as rqecl, n0s as rn0s
from plancklens_tpu_torch import compat
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import sims as psims, qecl as pqecl, n0s as pn0s
from plancklens_tpu_torch.utils import alm as palm

torch.set_num_threads(1)

LMAX, DLMAX = 32, 16
FIELDS = ('t', 'e', 'b', 'p', 'o')


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def lensed_libs(idxs, fields=FIELDS, nlev_t=35., nlev_p=55., transf=None):
    """Reference and port CMBLenLib + MapsLenNlevLib on the GL grid of LMAX over the same
    unit phases and unit noise maps (the reference's own draws, as numpy)."""
    cls = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lenspotentialCls.dat'))
    cls['oo'] = 0.1 * cls['pp']                 # a curl potential, drawn when 'o' in fields
    if transf is None:
        transf = rn0s.gauss_beam(5., LMAX)
    rlen = rsims.CMBLenLib(cls, LMAX, rgl(LMAX), fields=fields, seed=0, dlmax=DLMAX)
    rmaps = rsims.MapsLenNlevLib(rlen, transf, nlev_t, nlev_p, seed=2000)
    nf, lu = len(fields), LMAX + DLMAX
    phases = {i: np.asarray(rsims.unit_phases(rsims.sim_key(rlen.unl_lib._base_key, i), nf, lu))
              for i in idxs}
    g = rgl(LMAX)
    noise = {}
    for i in idxs:
        for tag, shape in ((0, (g.nrings, g.nphi)), (1, (2, g.nrings, g.nphi))):
            noise[i, tag] = np.asarray(jax.random.normal(rmaps._noise_key(i, tag), shape,
                                                         dtype=jnp.float64))
    plen = psims.CMBLenLib(cls, LMAX, pgl(LMAX), fields=fields, seed=0, dlmax=DLMAX,
                           device='cpu', phases=compat.phases_from_numpy(phases))
    pmaps = psims.MapsLenNlevLib(plen, transf, nlev_t, nlev_p, seed=2000,
                                 noise=compat.noise_from_numpy(noise))
    return (rlen, rmaps), (plen, pmaps)


def test_cmblenlib_matches_reference_with_curl():
    (rlen, _), (plen, _) = lensed_libs([0, 3])
    assert plen.hashdict() == rlen.hashdict()
    for i in (0, 3):
        assert _err(plen.get_sim_tmap(i), rlen.get_sim_tmap(i)) <= 1e-10
        for a, b in zip(plen.get_sim_pmap(i), rlen.get_sim_pmap(i)):
            assert _err(a, b) <= 1e-10
        for f in 'tebpo':
            assert _err(plen.get_sim_alm(i, f), rlen.get_sim_alm(i, f)) <= 1e-10, f
    # the curl potential deflects the maps: without it the lensed T differs
    (rlen2, _), (plen2, _) = lensed_libs([0], fields=FIELDS[:4])
    d = _err(plen2.get_sim_tmap(0), plen.get_sim_tmap(0))
    assert 1e-6 < d and _err(plen2.get_sim_tmap(0), rlen2.get_sim_tmap(0)) <= 1e-10


def test_mapslennlevlib_matches_reference():
    (_, rmaps), (_, pmaps) = lensed_libs([1])
    assert pmaps.hashdict() == rmaps.hashdict()
    assert _err(pmaps.ninv_t(), rmaps.ninv_t()) <= 1e-12
    assert _err(pmaps.ninv_p(), rmaps.ninv_p()) <= 1e-12
    assert _err(pmaps.get_sim_tmap(1), rmaps.get_sim_tmap(1)) <= 1e-10
    for a, b in zip(pmaps.get_sim_pmap(1), rmaps.get_sim_pmap(1)):
        assert _err(a, b) <= 1e-10
    for f in ('tnoise', 'qnoise', 'unoise'):
        assert _err(getattr(pmaps, 'get_sim_' + f)(1), getattr(rmaps, 'get_sim_' + f)(1)) <= 1e-12


def test_port_noise_generator():
    """Without injected noise: one stream per (seed, idx, tag), reproducible, unit variance
    after the pixel sigma, the same realisation in the map and the noise-only accessors."""
    _, (plen, _) = lensed_libs([0])
    lib = psims.MapsLenNlevLib(plen, np.ones(LMAX + 1), 35., 55., seed=7)
    n0, n1 = lib.get_sim_tnoise(0), lib.get_sim_tnoise(1)
    assert torch.equal(n0, lib.get_sim_tnoise(0)) and not torch.equal(n0, n1)
    q, u = lib.get_sim_qnoise(0), lib.get_sim_unoise(0)
    assert not torch.equal(q, u) and not torch.equal(q / lib._sig_p, n0 / lib._sig_t)
    unit = torch.cat([(n0 / lib._sig_t).ravel(), (q / lib._sig_p).ravel(),
                      (u / lib._sig_p).ravel()])
    assert abs(float(unit.std()) - 1.) < 0.05 and abs(float(unit.mean())) < 0.05
    other = psims.MapsLenNlevLib(plen, np.ones(LMAX + 1), 35., 55., seed=8)
    assert not torch.equal(other.get_sim_tnoise(0), n0)


def test_input_plm_lib_and_gauss_beam():
    (rlen, _), (plen, _) = lensed_libs([2])
    r, p = rqecl.InputPlmLib(rlen, LMAX - 4), pqecl.InputPlmLib(plen, LMAX - 4, device='cpu')
    assert p.hashdict() == r.hashdict() and p.get_lmax_qlm('ptt') == LMAX - 4
    assert _err(p.get_sim_qlm('ptt', 2), r.get_sim_qlm('ptt', 2)) <= 1e-10
    assert _err(p.get_sim_qlm_batch('p_p', [2]), r.get_sim_qlm_batch('p_p', [2])) <= 1e-10
    z = p.get_sim_qlm('xtt', 2)
    assert z.shape == (palm.getsize(LMAX - 4),) and not torch.any(z)
    assert not torch.any(p.get_sim_qlm_mf('ptt', [0, 1]))
    assert np.array_equal(pn0s.gauss_beam(5., 2048), rn0s.gauss_beam(5., 2048))
