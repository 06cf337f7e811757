"""cg_iters_per_sim of the masked cells (reader: portbench/metrics/_readers.py)."""
from portbench.metrics._readers import cg_iters_per_sim as read  # noqa: F401

LAYER = 'C^-1 solver: models/cinv CinvT, CinvP -> ops/cg'
UNIT = 'iters'
MOVES = 'sims_per_hour.masked'
