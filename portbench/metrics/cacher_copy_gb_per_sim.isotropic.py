"""cacher_copy_gb_per_sim of the isotropic cells (reader: portbench/metrics/_program.py)."""
from portbench.metrics._program import cacher_copy_gb_per_sim as read  # noqa: F401

LAYER = 'cachers: host copies of the QE, spectrum and filter products (models/qest QELib, qecl QeClLib, cinv IVFCinv)'
UNIT = 'GB'
MOVES = 'sims_per_hour.isotropic'
