"""legendre_anal_roofline of the masked cells (reader: portbench/metrics/_readers.py)."""
from portbench.metrics._readers import legendre_anal_roofline as read  # noqa: F401

LAYER = 'SHT Legendre phase: ops/sht core, kernels K1-K4'
UNIT = '%'
MOVES = 'sims_per_hour.masked'
