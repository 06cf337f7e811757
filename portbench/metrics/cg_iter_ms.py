"""cg_iter_ms of the masked cells (reader: portbench/metrics/_readers.py)."""
from portbench.metrics._readers import cg_iter_ms as read  # noqa: F401

LAYER = 'C^-1 solver: models/cinv CinvT, CinvP -> ops/cg'
UNIT = 'ms'
MOVES = 'sims_per_hour.masked'
