"""device_idle_pct of the masked cells (reader: portbench/metrics/_readers.py)."""
from portbench.metrics._readers import device_idle_pct as read  # noqa: F401

LAYER = 'device: NVIDIA H100'
UNIT = '%'
MOVES = 'sims_per_hour.masked'
