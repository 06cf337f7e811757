"""setup_tables_s of every cell (reader: portbench/metrics/_program.py)."""
from portbench.metrics._program import setup_tables_s as read  # noqa: F401

LAYER = 'SHT Legendre phase: ops/sht core, kernels K1-K4'
UNIT = 's'
MOVES = 'setup_s'
