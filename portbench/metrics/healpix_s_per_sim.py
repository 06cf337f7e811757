"""healpix_s_per_sim of the HEALPix map cell (reader: portbench/metrics/_healpix.py)."""
from portbench.metrics._healpix import healpix_s_per_sim as read  # noqa: F401

LAYER = 'HEALPix filter: models/sims HealpixMapLib, HealpixAlmLib -> ops/sht/healpix HealpixSHT (K3/K4)'
UNIT = 's'
MOVES = 'sims_per_hour.isotropic'
