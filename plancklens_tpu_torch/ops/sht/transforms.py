r"""Spin-s spherical harmonic transforms on iso-latitude ring geometries, in torch.

Port of plancklens_tpu/ops/sht/transforms.py (SHT, transforms.py:80-288), two phases:
  (1) Legendre phase: the fused north-south pair transforms of core.py (the Hopper
      kernels for CUDA tensors, the plain torch engine for CPU tensors); on a grid that
      is not north-south symmetric, two plain transforms, as in the reference;
  (2) longitude phase: one batched FFT over rings (torch.fft, cuFFT on the card).

Conventions (healpy's, as relied on by the reference's spin algebra,
cf. plancklens/utils_spin.py:1-34):
  _sY_lm = sqrt((2l+1)/4pi) d^l_{m,-s}(theta) e^{im phi}
  _{+s}a_lm = -(g_lm + i c_lm),   _{-s}a_lm = -(-1)^s (g_lm - i c_lm)
  alm2map_spin((g, c), s) = (re, im) of _sf = sum_lm (_s a_lm) _sY_lm
  spin 0: alm2map(tlm) uses +t_lm like healpy; the -T convention lives in the QE layer.

map2alm uses the geometry quadrature weights: exact on the GL grid for band-limited input.
"""
import numpy as np
import torch

from ...utils import alm as ualm
from .core import legendre_synth_pair, legendre_anal_pair
from .geometry import RingGeometry, gl_geometry

_CDTYPE = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _facl(lmax):
    return np.sqrt((2. * np.arange(lmax + 1) + 1.) / (4. * np.pi))


def _to_rings(Fp, Fm, nphi, phi0):
    """Assemble FFT bins and synthesize rings: f_k = sum_m Fp e^{im phi_k} + Fm e^{-im phi_k}.

    m is folded mod nphi into the FFT bins, so the synthesis stays exact at the grid
    points even when nphi < 2 mmax + 1 (the map is then merely non-invertible)."""
    batch, nrings, mmaxp1 = Fp.shape
    if phi0 != 0.:
        rot = torch.exp(1j * phi0 * torch.arange(mmaxp1, device=Fp.device,
                                                 dtype=torch.float64)).to(Fp.dtype)
        Fp = Fp * rot
        Fm = Fm * torch.conj(rot)
    X = torch.zeros((batch, nrings, nphi), dtype=Fp.dtype, device=Fp.device)
    if mmaxp1 <= nphi - (mmaxp1 - 1):  # disjoint bins: slice placement
        X[..., :mmaxp1] = Fp
        if mmaxp1 > 1:
            X[..., nphi - mmaxp1 + 1:] += Fm[..., 1:].flip(-1)
    else:
        mm = np.arange(mmaxp1)
        X.index_add_(-1, torch.as_tensor(mm % nphi, device=Fp.device), Fp)
        X.index_add_(-1, torch.as_tensor((-mm[1:]) % nphi, device=Fp.device),
                     Fm[..., 1:].contiguous())
    # X is freed before the scaling, which runs in place: the synthesis holds two map-sized
    # buffers at once, not three
    f = torch.fft.ifft(X, dim=-1)
    del X
    return f.mul_(nphi)


def _from_rings(maps, mmax, phi0):
    """Extract G+_m, G-_m = (2pi/nphi) sum_k f_k e^{-+ im phi_k} from complex ring maps."""
    nphi = maps.shape[-1]
    if nphi < 2 * mmax + 1:
        raise ValueError('analysis needs nphi >= 2 mmax + 1 (%d < %d)'
                         % (nphi, 2 * mmax + 1))
    T = torch.fft.fft(maps, dim=-1).mul_(2. * np.pi / nphi)
    Gp = T[..., :mmax + 1]
    neg = T[..., nphi - mmax:].flip(-1) if mmax > 0 else T[..., :0]
    Gm = torch.cat([T[..., :1], neg], dim=-1)
    if phi0 != 0.:
        rot = torch.exp(-1j * phi0 * torch.arange(mmax + 1, device=maps.device,
                                                  dtype=torch.float64)).to(Gp.dtype)
        Gp = Gp * rot
        Gm = Gm * torch.conj(rot)
    return Gp, Gm


def _resolve_device(device):
    """torch.device with the current card's index made explicit for 'cuda'."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def _on_device(x, device):
    """numpy input -> tensor on `device`; a tensor on another device raises."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(x), device=device)
    if x.device != device:
        raise ValueError('input on %s, transform on %s' % (x.device, device))
    return x


class SHT:
    """Spin-s synthesis/analysis bound to a geometry, band limit, dtype and device.

    Entry points accept healpy-layout triangular alm tensors with arbitrary leading batch
    dimensions, and maps shaped (..., nrings, nphi). Input tensors must lie on the
    transform's device (numpy arrays are placed there) and are cast to its precision; a
    tensor on another device raises. On a CUDA device the Legendre phase runs the Hopper
    kernels."""

    def __init__(self, geom_or_lmax, lmax=None, mmax=None, dtype=torch.float64, *, device):
        if isinstance(geom_or_lmax, RingGeometry):
            assert lmax is not None
            self.geom = geom_or_lmax
        else:
            lmax = geom_or_lmax if lmax is None else lmax
            self.geom = gl_geometry(geom_or_lmax)
        self.lmax = lmax
        self.mmax = lmax if mmax is None else mmax
        self.dtype = dtype
        self.cdtype = _CDTYPE[dtype]
        self.device = _resolve_device(device)
        self._fac = torch.as_tensor(_facl(lmax), dtype=dtype, device=self.device)[:, None]
        self._w = torch.as_tensor(self.geom.weight, dtype=dtype, device=self.device)[:, None]

    def _tok(self):
        return self.geom.token()

    def _synth_pair(self, A, Abar, spin):
        """F+ and F- theta-functions for all m >= 0: one fused Legendre call runs both the
        (-spin) and (+spin) recursions on the northern half."""
        Cp = A * self._fac
        Cm = ((-1.) ** spin) * torch.conj(Abar) * self._fac
        return legendre_synth_pair(Cp, Cm, spin, self.geom.theta, grid_token=self._tok())

    def _anal_pair(self, maps_c, spin):
        """A = _sa_lm and B = -(g - ic)_lm grids from complex ring maps."""
        Gp, Gm = _from_rings(maps_c, self.mmax, self.geom.phi0)
        # the weighted grids replace Gp and Gm, so the rings' FFT that Gp views is freed
        # before the Legendre phase
        Gp, Gm = Gp * self._w, Gm * self._w
        A, Bc = legendre_anal_pair(Gp, Gm, spin, self.geom.theta, self.lmax,
                                   grid_token=self._tok())
        return A * self._fac, ((-1.) ** spin) * torch.conj(Bc) * self._fac

    def _on_device(self, x):
        return _on_device(x, self.device)

    def _to_grid(self, alm):
        """Full-layout triangular alm -> (lmax+1, mmax+1) dense grid (an mmax < lmax
        truncates the azimuthal band, as healpy's mmax does)."""
        alm = alm.to(self.cdtype)
        A = ualm.alm2lm(alm, self.lmax)
        return A if self.mmax == self.lmax else A[..., :self.mmax + 1]

    def _from_grid(self, A):
        """(lmax+1, mmax+1) dense grid -> full-layout triangular alm, zero beyond mmax
        (padded before the triangular gather, which would otherwise read m > mmax)."""
        if self.mmax < self.lmax:
            A = torch.nn.functional.pad(A, (0, self.lmax - self.mmax))
        return ualm.lm2alm(A, self.lmax)

    # ------------------------------------------------------------------ spin 0
    def alm2map(self, tlm):
        """Real map from scalar alm (healpy convention, map = sum t_lm Y_lm)."""
        tlm = self._on_device(tlm)
        batch_shape = tlm.shape[:-1]
        A = self._to_grid(tlm.reshape((-1, tlm.shape[-1]))) * self._fac
        Fp, _ = legendre_synth_pair(A, None, 0, self.geom.theta, grid_token=self._tok())
        del A       # the grids go before the ring phase, the synthesis' largest
        f = _to_rings(Fp, torch.conj(Fp), self.geom.nphi, self.geom.phi0).real
        return f.reshape(batch_shape + f.shape[-2:])

    def map2alm(self, m):
        """Scalar alm from real map, exact quadrature: the negative-m spectrum of a real
        map is the conjugate of the positive-m one, so one spin-0 analysis suffices."""
        m = self._on_device(m)
        batch_shape = m.shape[:-2]
        mc = m.reshape((-1,) + m.shape[-2:]).to(self.cdtype)
        Gp = _from_rings(mc, self.mmax, self.geom.phi0)[0] * self._w
        A, _ = legendre_anal_pair(Gp, None, 0, self.geom.theta, self.lmax,
                                  grid_token=self._tok())
        out = self._from_grid(A * self._fac)
        return out.reshape(batch_shape + out.shape[-1:])

    # ------------------------------------------------------------------ spin s
    def alm2map_spin(self, gclm, spin):
        """(re, im) maps of _sf from (glm, clm); spin > 0."""
        assert spin > 0, spin
        glm, clm = gclm
        glm = self._on_device(glm)
        clm = self._on_device(clm).broadcast_to(glm.shape)
        batch_shape = glm.shape[:-1]
        G = self._to_grid(glm.reshape((-1, glm.shape[-1])))
        C = self._to_grid(clm.reshape((-1, clm.shape[-1])))
        A = -(G + 1j * C)
        Abar = -(G - 1j * C)
        del G, C
        Fp, Fm = self._synth_pair(A, Abar, spin)
        del A, Abar     # the grids go before the ring phase, the synthesis' largest
        f = _to_rings(Fp, Fm, self.geom.nphi, self.geom.phi0)
        f = f.reshape(batch_shape + f.shape[-2:])
        return f.real, f.imag

    def map2alm_spin(self, maps, spin):
        """(glm, clm) from (re, im) maps of _sf; spin > 0, exact quadrature."""
        assert spin > 0, spin
        m1, m2 = self._on_device(maps[0]), self._on_device(maps[1])
        batch_shape = m1.shape[:-2]
        mc = torch.complex(m1.to(self.dtype), m2.to(self.dtype))
        mc = mc.reshape((-1,) + m1.shape[-2:])
        A, B = self._anal_pair(mc, spin)
        glm = self._from_grid(-0.5 * (A + B))
        clm = self._from_grid(0.5j * (A - B))
        return glm.reshape(batch_shape + glm.shape[-1:]), \
            clm.reshape(batch_shape + clm.shape[-1:])
