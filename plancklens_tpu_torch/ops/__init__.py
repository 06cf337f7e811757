from . import gauleg, sht, cg
