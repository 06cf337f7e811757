"""legendre_synth_roofline of the HEALPix map cell: the roofline share of the window's
Legendre syntheses off the HEALPix rings, those of the QEs on their GL grid (K1/K2)
(reader: portbench/metrics/_healpix.py)."""
from portbench.metrics._healpix import share


def read(ctx):
    return share(ctx, 'synth', healpix=False)


LAYER = 'SHT Legendre phase: ops/sht core, kernels K1-K4'
UNIT = '%'
MOVES = 'sims_per_hour.isotropic'
