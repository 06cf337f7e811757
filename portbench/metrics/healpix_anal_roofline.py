"""healpix_anal_roofline of the HEALPix map cell: the roofline share of the window's
plain Legendre analyses on the HEALPix rings (K4) (reader: portbench/metrics/_healpix.py)."""
from portbench.metrics._healpix import share


def read(ctx):
    return share(ctx, 'anal')


LAYER = 'HEALPix filter: models/sims HealpixMapLib, HealpixAlmLib -> ops/sht/healpix HealpixSHT (K3/K4)'
UNIT = '%'
MOVES = 'sims_per_hour.isotropic'
