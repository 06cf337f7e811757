from . import spin, qe, qresp, sims, filt, qest, qecl, cinv, n1, bandpowers
