"""qe_s_per_sim of the masked cells (reader: portbench/metrics/_readers.py)."""
from portbench.metrics._readers import qe_s_per_sim as read  # noqa: F401

LAYER = 'QE: models/qest QELib'
UNIT = 's'
MOVES = 'sims_per_hour.masked'
