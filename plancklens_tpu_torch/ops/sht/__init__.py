from .geometry import RingGeometry, gl_geometry, ecp_geometry, good_fft_size
from .healpix import HealpixGeometry, HealpixSHT
from .transforms import SHT
from . import core, legendre_kernels
