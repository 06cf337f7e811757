"""filter_s_per_sim of the isotropic cells (reader: portbench/metrics/_readers.py)."""
from portbench.metrics._readers import filter_s_per_sim as read  # noqa: F401

LAYER = 'filtering: models/filt IVFSepTP, models/cinv IVFCinv + filt.IVFFtl'
UNIT = 's'
MOVES = 'sims_per_hour.isotropic'
