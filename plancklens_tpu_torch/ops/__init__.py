from . import gauleg, sht, cg, n1kern
