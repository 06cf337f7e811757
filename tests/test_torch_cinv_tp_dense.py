"""Port parity of joint T/P masked filtering with the dense low-l block:
plancklens_tpu_torch.models.cinv.CinvTP against plancklens_tpu.models.cinv.CinvTP on
identical numpy inputs, f64, on the CPU (the plain twins of the Legendre kernels).

  * a dense T/E/B block stored by the reference loads in the port under the same key and
    preconditions as the reference's (1e-12 of max), and the port's own probe (of the
    operator built at band limit lmax_dense on the full grid) equals the reference's
    full-band operator on the same basis (1e-12 of max);
  * at Planck-like T noise the joint system amplifies rounding by its condition (ROADMAP
    fault 3.6): the same iteration count, and the solutions within 10x the port's own
    change under a 1e-15 change of its maps and of its inverted dense block, measured here.
"""
import numpy as np
import torch

from plancklens_tpu.utils import alm as ralm
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import cinv as pcinv
from plancklens_tpu_torch.utils.cachers import cacher_mem
from test_torch_cinv_tp import _err, _sky, _pair

torch.set_num_threads(1)


def test_cinv_tp_planck_noise_matches_reference_to_its_conditioning():
    """35 uK-arcmin in T over the cut, monopole and dipole marginalised, dense block to l
    12: the same iteration count, and the solutions within 10x the port's own change under
    a 1e-15 change of its maps and inverted dense block (ROADMAP fault 3.6)."""
    lmax, ld = 24, 12
    cls, geom, T, Q, U, ninv_t, ninv_p, rng = _sky(lmax, 35., 0.2, 0.5, pol_fac=55. / 35.)
    kw = dict(eps_min=1e-5, lmax_dense=ld, marge_monopole=True, marge_dipole=True)
    # the port loads the reference's block; its own differs from it by rounding times the
    # block's condition, which moves the iteration count of this system
    held = cacher_mem()
    r, p = _pair(lmax, cls, geom, ninv_t, ninv_p, cacher=held, rcacher=held, **kw)
    (key, minv), = held._cache.items()

    def perturbed(a):
        return a * (1. + 1e-15 * rng.standard_normal(a.shape))
    pert = cacher_mem()
    pert.cache(key, 0.5 * (perturbed(minv) + perturbed(minv).T))
    p_n = pcinv.CinvTP(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv_t, ninv_p,
                       dense_cacher=pert, device='cpu', **kw)
    rx, rit, _ = r.solve_wf(T, Q, U)
    px, pit, _ = p.solve_wf(T, Q, U)
    px2, pit2, _ = p_n.solve_wf(perturbed(T), perturbed(Q), perturbed(U))
    floor = _err(px2, px)
    assert pit == int(rit) == pit2 and pit > 20, (pit, int(rit), pit2)
    assert 0. < floor < 1e-1, floor
    assert _err(px, rx) <= 10. * floor, (_err(px, rx), floor)


def test_dense_tp_block_from_reference_loads_in_port():
    """A dense T/E/B block built and stored by the reference loads in the port under the
    same key (no probe: the cacher keeps one entry) and preconditions as the reference's;
    the port's own probe at band limit lmax_dense gives the same block (1e-12 of max)."""
    lmax, ld = 24, 8
    cls, geom, T, Q, U, ninv_t, ninv_p, rng = _sky(lmax, 100., 0.2, 0.5)
    shared = cacher_mem()
    r, p = _pair(lmax, cls, geom, ninv_t, ninv_p, cacher=shared, rcacher=shared,
                 lmax_dense=ld, marge_monopole=True)
    (key, minv_ref), = shared._cache.items()
    assert key.startswith('dense_tp_%d_%d_' % (ld, lmax))
    nalm = ralm.getsize(lmax)
    x = rng.standard_normal((2, 3, nalm)) + 1j * rng.standard_normal((2, 3, nalm))
    got, ref = p.pre_op(torch.as_tensor(x)), r.pre_op(x)
    assert _err(got, ref) <= 1e-12, _err(got, ref)
    own = cacher_mem()
    pcinv.CinvTP(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv_t, ninv_p, lmax_dense=ld,
                 marge_monopole=True, dense_cacher=own, device='cpu')
    (key2, _), = own._cache.items()
    assert key2 == key
    # the blocks themselves (their inverses amplify rounding by the block's condition):
    # the port probes the operator built at band limit ld; the reference's full-band
    # operator applied to the same real-harmonic basis gives the block it inverts
    nrlm = (ld + 1) ** 2
    basis = np.eye(3 * nrlm).reshape(3 * nrlm, 3, nrlm)
    cols = r.fwd_op(ralm.alm_copy(ralm.rlm2alm(basis, ld), ld, lmax))
    M_ref = np.asarray(ralm.alm2rlm(ralm.alm_copy(cols, lmax, ld), ld)).reshape(3 * nrlm, -1)
    fwd_ld = p.filt.make_ops(ld, cls, rescal_cl=p.rescal_cl[:ld + 1])[0]
    M_own = pcinv._probe(fwd_ld, ld, ld, 3, 64, torch.float64, torch.device('cpu'))
    assert _err(M_own, 0.5 * (M_ref + M_ref.T)) <= 1e-12, _err(M_own, M_ref)
