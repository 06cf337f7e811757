from . import alm, cls, hashing, cachers, fitsio, maps
from .cls import camb_clfile, cli, clinv, joincls, extcl, cls_dot, cl_inverse
from .hashing import clhash, mchash, hash_check
