"""Power-spectrum dictionary algebra and CAMB file IO.

Pure numpy (these are config-time operations on O(lmax) arrays); the hot per-multipole work
lives in :mod:`plancklens_tpu_torch.ops`.
Copied from plancklens_tpu/utils/cls.py; the mask helpers (smooth_map, apodize_mask) run
their transforms on a given device and return host numpy maps.

Behaviour matched to the reference helpers:
 - camb_clfile      (reference: plancklens/utils.py:307-333)
 - cli              (reference: plancklens/utils.py:132-138)
 - joincls          (reference: plancklens/utils.py:140-142)
 - cl_inverse       (reference: plancklens/utils.py:336-374)
 - cls_dot          (reference: plancklens/utils.py:376-409)
"""
import numpy as np

_TEB = ('t', 'e', 'b')
_KEYS6 = ('tt', 'ee', 'bb', 'te', 'tb', 'eb')


# CAMB output column layout: key and the power p of the l(l+1) prefactor CAMB applies,
# column i+1 holds (l(l+1))^p C_l / 2pi (lensedCls/tensCls files carry the first four
# columns, lenspotentialCls files all seven)
_CAMB_COLUMNS = (('tt', 1.), ('ee', 1.), ('bb', 1.), ('te', 1.),
                 ('pp', 2.), ('pt', 1.5), ('pe', 1.5))


def camb_clfile(fname, lmax=None):
    """Load a CAMB spectra file (lensedCls / lenspotentialCls / tensCls layout) as a dict
    of bare C_l arrays indexed by multipole (entries below the file's first l are zero)."""
    data = np.atleast_2d(np.loadtxt(fname))
    ls = data[:, 0].astype(int)
    if lmax is None:
        lmax = int(ls[-1])
    assert int(ls[-1]) >= lmax, (ls[-1], lmax)
    keep = ls <= lmax
    ls = ls[keep]
    dlfac = (ls * (ls + 1.)) / (2. * np.pi)  # p = 1 prefactor; higher p via powers
    out = {}
    for col, (key, p) in enumerate(_CAMB_COLUMNS[:data.shape[1] - 1], start=1):
        cl = np.zeros(lmax + 1, dtype=float)
        cl[ls] = data[keep, col] / (dlfac ** p * (2. * np.pi) ** (p - 1.))
        out[key] = cl
    return out


def cli(cl):
    """Pseudo-inverse of a cl array: 1/cl where cl > 0, else 0."""
    ret = np.zeros_like(cl)
    ii = cl > 0
    ret[ii] = 1. / cl[ii]
    return ret


def clinv(cl):
    """Pseudo-inverse where cl != 0 (signed version of :func:`cli`)."""
    ret = np.zeros_like(cl)
    ii = cl != 0
    ret[ii] = 1. / cl[ii]
    return ret


def joincls(cls_list):
    """Elementwise product of cl arrays, truncated to the shortest one."""
    lmaxp1 = np.min([len(cl) for cl in cls_list])
    ret = cls_list[0][:lmaxp1].copy()
    for cl in cls_list[1:]:
        ret = ret * cl[:lmaxp1]
    return ret


def extcl(lmax, cl):
    """Zero-pad or truncate a cl array to lmax + 1 entries."""
    if len(cl) - 1 < lmax:
        ret = np.zeros(lmax + 1, dtype=cl.dtype if hasattr(cl, 'dtype') else float)
        ret[:len(cl)] = cl
        return ret
    return cl[:lmax + 1]


def clpp_to_cldd(clpp):
    r"""Lensing-potential spectrum to deflection 'D'-spectrum
    :math:`(L(L+1))^2 C_L^{\phi\phi} / 2\pi` (the convention of the lensed-cls operator)."""
    ls = np.arange(len(clpp), dtype=float)
    return np.asarray(clpp) * (ls * (ls + 1.)) ** 2 / (2. * np.pi)


def cldd_to_clpp(cldd):
    """Inverse of :func:`clpp_to_cldd` (pseudo-inverse at the L=0 monopole)."""
    ls = np.arange(len(cldd), dtype=float)
    return np.asarray(cldd) * cli((ls * (ls + 1.)) ** 2 / (2. * np.pi))


def cldict2arr(cls_dict):
    """(3, 3, lmax+1) TEB spectral-matrix array from a cls dict (missing keys are zero)."""
    lmaxp1 = np.max([len(cl) for cl in cls_dict.values()])
    ret = np.zeros((3, 3, lmaxp1), dtype=float)
    for i, x in enumerate(_TEB):
        for j, y in enumerate(_TEB):
            ret[i, j] = extcl(lmaxp1 - 1, np.atleast_1d(
                cls_dict.get(x + y, cls_dict.get(y + x, np.array([0.])))))
    return ret


def arr2cldict(arr):
    """Inverse of :func:`cldict2arr`, dropping identically-zero entries."""
    clsi = {}
    for k, (i, j) in zip(_KEYS6, [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]):
        a = arr[i, j].copy()
        if np.any(a):
            clsi[k] = a
    return clsi


def cls_dot(cls_list, ret_dict=False):
    """Product of TEB spectral matrices (dicts or (3,3,lmax+1) arrays), per multipole."""
    arrs = [cldict2arr(c) if isinstance(c, dict) else c for c in cls_list]
    lmaxp1 = min(a.shape[-1] for a in arrs)
    ret = arrs[0][:, :, :lmaxp1]
    for a in arrs[1:]:
        ret = np.einsum('ikl,kjl->ijl', ret, a[:, :, :lmaxp1])
    return arr2cldict(ret) if ret_dict else ret


def cl_inverse(cls):
    """Per-multipole pseudo-inverse of the 3x3 TEB spectral matrix, as a dict."""
    lmax = np.max([len(cl) for cl in cls.values()]) - 1
    clsm = np.zeros((lmax + 1, 3, 3))
    get = lambda k: extcl(lmax, np.atleast_1d(np.asarray(cls.get(k, [0.]), dtype=float)))
    clsm[:, 0, 0] = get('tt')
    clsm[:, 1, 1] = get('ee')
    clsm[:, 2, 2] = get('bb')
    clsm[:, 0, 1] = clsm[:, 1, 0] = get('te')
    clsm[:, 0, 2] = clsm[:, 2, 0] = get('tb')
    clsm[:, 1, 2] = clsm[:, 2, 1] = get('eb')
    clsmi = np.linalg.pinv(clsm)
    clsi = {}
    for k, (i, j) in zip(_KEYS6, [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]):
        arr = clsmi[:, i, j].copy()
        if np.any(arr):
            clsi[k] = arr
    return clsi


def smooth_map(m, geom, sigma_rad, lmax=None, *, device):
    """Gaussian smoothing of a map on a ring geometry (healpy hp.smoothing role), the
    transforms on `device`; host numpy out."""
    import torch
    from ..ops.sht import SHT
    from . import alm as ualm
    if lmax is None:
        lmax = geom.nrings - 1
    sht = SHT(geom, lmax, device=device)
    alm = sht.map2alm(torch.as_tensor(np.asarray(m, dtype=float), device=sht.device))
    ls = np.arange(lmax + 1)
    bl = np.exp(-0.5 * ls * (ls + 1.) * sigma_rad ** 2)
    return sht.alm2map(ualm.almxfl(alm, lmax, bl)).cpu().numpy()


def apodize_mask(mask, geom, sigma_arcmin=12., lmax=None, method='hybrid',
                 mult_factor=3, min_factor=0.1, verbose=False, *, device):
    """Apodize a binary mask for pseudo-CL use (reference: plancklens/utils.py:268-305):
    Gaussian smoothing, or the hybrid scheme (enlarge + truncate + re-smooth) that mostly
    smooths outside the existing mask. The smoothings run on `device`."""
    if not sigma_arcmin:
        return mask
    sigma_rad = sigma_arcmin / 180. / 60. * np.pi
    ap = smooth_map(mask, geom, sigma_rad, lmax=lmax, device=device)
    if method == 'gaussian':
        return ap
    if method != 'hybrid':
        raise ValueError('Unknown apodization method ' + method)
    ap = 1 - np.minimum(1., np.maximum(0., mult_factor * (1 - ap) - min_factor))
    ap = smooth_map(ap, geom, sigma_rad / 2, lmax=lmax, device=device)
    if verbose:
        w = np.outer(geom.weight, np.full(geom.nphi, 1. / geom.nphi)) / 2.
        print('apodize_mask: fsky = %.4f' % np.sum(w * ap ** 2))
    return ap


def cls2dls(cls):
    """Cls dict -> (CAMB-layout (lmax+1, 4) D_l array, deflection D-spectrum) —
    the interchange format of the iterative-forecast loop (role of reference
    plancklens/nhl.py:191-205)."""
    lmax = np.max([len(cl) for cl in cls.values()]) - 1
    fac = np.arange(lmax + 1) * np.arange(1, lmax + 2, dtype=float) / (2. * np.pi)
    dls = np.zeros((lmax + 1, 4), dtype=float)
    for i, k in enumerate(('tt', 'ee', 'bb', 'te')):
        cl = extcl(lmax, np.asarray(cls.get(k, np.zeros(1))))
        dls[:, i] = cl * fac
    cldd = clpp_to_cldd(cls['pp']) if 'pp' in cls else None
    return dls, cldd


def dls2cls(dls):
    """Inverse of :func:`cls2dls` for the four TEB spectra (reference
    plancklens/nhl.py:207-214)."""
    assert dls.shape[1] == 4, dls.shape
    lmax = dls.shape[0] - 1
    fac = 2. * np.pi * cli(np.arange(lmax + 1) * np.arange(1, lmax + 2, dtype=float))
    return {k: dls[:, i] * fac for i, k in enumerate(('tt', 'ee', 'bb', 'te'))}
