r"""Minimal pure-numpy FITS binary-table IO for healpy-format alm / map / cl files.

Copied from plancklens_tpu/utils/fitsio.py (numpy only): both packages write
byte-identical files and read each other's.

The reference pipeline exchanges data as healpy FITS files (reference:
plancklens/sims/planck2018_sims.py:30-60 reads FFP10 alm/map FITS via hp.read_alm /
hp.read_map). astropy is not a dependency here; this module implements the small subset
of the FITS standard those files use — BINTABLE extensions with scalar or fixed-length
vector columns, big-endian, 2880-byte blocking — so external products can be loaded and
results exported without healpy.

Conventions matched to healpy:
  * alm files: one BINTABLE with columns (index, real, imag), index = l^2 + l + m + 1
    (hp.write_alm / hp.read_alm).
  * map files: one BINTABLE whose columns are 1024-element float vectors chunking each
    RING-ordered map, with NSIDE / ORDERING header cards (hp.write_map / hp.read_map).
  * cl files: one BINTABLE with one scalar float column per spectrum (hp.write_cl).
"""
import numpy as np

_BLOCK = 2880

# ----------------------------------------------------------------- header primitives
_TFORM_DTYPES = {'L': 'i1', 'B': 'u1', 'I': '>i2', 'J': '>i4', 'K': '>i8',
                 'E': '>f4', 'D': '>f8', 'C': '>c8', 'M': '>c16', 'A': 'S'}


def _card(key, value, comment=''):
    if isinstance(value, bool):
        v = 'T' if value else 'F'
        s = "%-8s= %20s" % (key, v)
    elif isinstance(value, (int, np.integer)):
        s = "%-8s= %20d" % (key, value)
    elif isinstance(value, float):
        s = "%-8s= %20s" % (key, ('%G' % value))
    else:
        s = "%-8s= %-20s" % (key, "'%s'" % str(value))
    if comment:
        s += ' / ' + comment
    return s[:80].ljust(80)


def _parse_header_blocks(f):
    """Read 2880-byte blocks until the END card; return dict of parsed cards."""
    cards = {}
    while True:
        block = f.read(_BLOCK)
        if len(block) < _BLOCK:
            raise IOError('truncated FITS header')
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode('ascii', errors='replace')
            key = card[:8].strip()
            if key == 'END':
                done = True
                break
            if card[8:10] != '= ':
                continue
            raw = card[10:].split('/')[0].strip()
            if raw.startswith("'"):
                val = raw[1:raw.rindex("'")].strip()
            elif raw in ('T', 'F'):
                val = raw == 'T'
            else:
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
            cards[key] = val
        if done:
            return cards


def _tform_to_dtype(tform):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    rep = int(tform[:i]) if i else 1
    code = tform[i]
    if code == 'A':
        return np.dtype('S%d' % rep), 1
    base = _TFORM_DTYPES[code]
    return np.dtype(base), rep


def _open_fits(path):
    """Seekable binary reader for a FITS file, transparently gunzipping '.fits.gz'
    (or any gzip-magic) input — Planck masks ship gzipped and the header parser
    needs tell/seek, so gzip members are decompressed into memory first."""
    import io
    with open(path, 'rb') as f:
        head = f.read(2)
    if head == b'\x1f\x8b':
        import gzip
        with gzip.open(path, 'rb') as g:
            return io.BytesIO(g.read())
    return open(path, 'rb')


def read_bintables(path):
    """All BINTABLE HDUs of a FITS file -> list of (header, {name: column}) pairs.
    Vector columns come back as (nrows, rep) arrays, scalar columns as (nrows,)."""
    out = []
    with _open_fits(path) as f:
        primary = _parse_header_blocks(f)
        if not primary.get('SIMPLE', False):
            raise IOError('%s: not a FITS file' % path)
        # primary data (usually empty)
        _skip_data(f, primary)
        while True:
            pos = f.tell()
            probe = f.read(80)
            if len(probe) < 80:
                break
            f.seek(pos)
            hdr = _parse_header_blocks(f)
            if hdr.get('XTENSION', '').strip() != 'BINTABLE':
                _skip_data(f, hdr)
                continue
            nrow = hdr['NAXIS2']
            rowbytes = hdr['NAXIS1']
            nfield = hdr['TFIELDS']
            names, dtypes = [], []
            for j in range(1, nfield + 1):
                names.append(str(hdr.get('TTYPE%d' % j, 'col%d' % j)).strip())
                dt, rep = _tform_to_dtype(str(hdr['TFORM%d' % j]))
                dtypes.append((dt, rep))
            rec = np.dtype([('f%d' % j, dt if rep == 1 else (dt, rep))
                            for j, (dt, rep) in enumerate(dtypes)])
            assert rec.itemsize == rowbytes, (rec.itemsize, rowbytes)
            nbytes = nrow * rowbytes
            data = np.frombuffer(f.read(nbytes), dtype=rec, count=nrow)
            f.read((-nbytes) % _BLOCK)
            cols = {}
            for j, name in enumerate(names):
                arr = np.ascontiguousarray(data['f%d' % j])
                cols[name] = arr.astype(arr.dtype.newbyteorder('='))
            out.append((hdr, cols))
    return out


def _skip_data(f, hdr):
    n = abs(hdr.get('BITPIX', 8)) // 8
    for ax in range(1, hdr.get('NAXIS', 0) + 1):
        n *= hdr['NAXIS%d' % ax]
    if hdr.get('NAXIS', 0) == 0:
        n = 0
    n *= hdr.get('GCOUNT', 1)
    n += hdr.get('PCOUNT', 0)
    f.seek((n + (-n) % _BLOCK), 1)


def write_bintable(path, columns, extra_cards=()):
    """Write a single-BINTABLE FITS file. columns: list of (name, array); 2-D arrays
    become fixed-length vector columns."""
    code_of = {'i1': 'L', 'u1': 'B', 'i2': 'I', 'i4': 'J', 'i8': 'K',
               'f4': 'E', 'f8': 'D', 'c8': 'C', 'c16': 'M'}
    nrows = len(columns[0][1])
    fields, tcards = [], []
    for j, (name, arr) in enumerate(columns):
        arr = np.asarray(arr)
        assert len(arr) == nrows, name
        rep = 1 if arr.ndim == 1 else arr.shape[1]
        code = code_of[arr.dtype.str.lstrip('<>|=')]
        be = np.dtype(arr.dtype.str.lstrip('<>|=')).newbyteorder('>')
        fields.append(('f%d' % j, be if rep == 1 else (be, rep)))
        tcards += [_card('TTYPE%d' % (j + 1), name),
                   _card('TFORM%d' % (j + 1), ('%d%s' % (rep, code)) if rep > 1 else code)]
    rec = np.dtype(fields)
    data = np.zeros(nrows, dtype=rec)
    for j, (_, arr) in enumerate(columns):
        data['f%d' % j] = np.asarray(arr)
    with open(path, 'wb') as f:
        prim = (_card('SIMPLE', True) + _card('BITPIX', 8) + _card('NAXIS', 0)
                + _card('EXTEND', True) + 'END'.ljust(80))
        f.write(prim.ljust((-len(prim)) % _BLOCK + len(prim)).encode('ascii'))
        hdr = (_card('XTENSION', 'BINTABLE') + _card('BITPIX', 8) + _card('NAXIS', 2)
               + _card('NAXIS1', rec.itemsize) + _card('NAXIS2', nrows)
               + _card('PCOUNT', 0) + _card('GCOUNT', 1)
               + _card('TFIELDS', len(columns)) + ''.join(tcards)
               + ''.join(extra_cards) + 'END'.ljust(80))
        f.write(hdr.ljust((-len(hdr)) % _BLOCK + len(hdr)).encode('ascii'))
        raw = data.tobytes()
        f.write(raw)
        f.write(b'\0' * ((-len(raw)) % _BLOCK))


# ------------------------------------------------------------------ healpy formats
def write_alm(path, alm, lmax=None):
    """healpy hp.write_alm format: columns (index, real, imag), index = l^2+l+m+1."""
    from . import alm as ualm
    alm = np.asarray(alm)
    if lmax is None:
        lmax = ualm.getlmax(alm.shape[-1])
    ls, ms = ualm._lm_indices(lmax)
    idx = (ls * ls + ls + ms + 1).astype(np.int64)
    write_bintable(path, [('index', idx),
                          ('real', alm.real.astype(np.float64)),
                          ('imag', alm.imag.astype(np.float64))])


def read_alm(path, hdu=0):
    """Read a healpy alm FITS file into the triangular layout (any lmax/mmax subset)."""
    from . import alm as ualm
    hdr, cols = read_bintables(path)[hdu]
    keys = {k.lower(): k for k in cols}
    idx = np.asarray(cols[keys['index']], dtype=np.int64)
    re = np.asarray(cols[keys['real']], dtype=np.float64)
    im = np.asarray(cols[keys['imag']], dtype=np.float64)
    ls = (np.floor(np.sqrt(idx - 1))).astype(np.int64)
    ms = idx - 1 - ls * ls - ls
    lmax = int(ls.max())
    out = np.zeros(ualm.getsize(lmax), dtype=np.complex128)
    out[ualm.getidx(lmax, ls, ms)] = re + 1j * im
    return out


def write_map(path, maps, nside=None):
    """healpy hp.write_map format: RING-ordered maps chunked into 1024-float vector
    columns, NSIDE/ORDERING cards."""
    maps = np.atleast_2d(np.asarray(maps, dtype=np.float64))
    npix = maps.shape[-1]
    if nside is None:
        nside = int(np.sqrt(npix / 12))
    assert 12 * nside * nside == npix, (npix, nside)
    chunk = 1024 if npix % 1024 == 0 else npix
    cols = [('TEMPERATURE' if i == 0 else 'COL%d' % i,
             m.reshape(-1, chunk) if chunk > 1 else m) for i, m in enumerate(maps)]
    cards = [_card('PIXTYPE', 'HEALPIX'), _card('ORDERING', 'RING'),
             _card('NSIDE', nside), _card('FIRSTPIX', 0), _card('LASTPIX', npix - 1),
             _card('INDXSCHM', 'IMPLICIT')]
    write_bintable(path, cols, extra_cards=cards)


def read_map(path, field=0, hdu=0):
    """Read a healpy map FITS file (RING ordering; NESTED files are reordered)."""
    hdr, cols = read_bintables(path)[hdu]
    name = list(cols)[field]
    m = np.asarray(cols[name], dtype=np.float64).reshape(-1)
    if str(hdr.get('ORDERING', 'RING')).strip().upper() == 'NESTED':
        nside = int(hdr['NSIDE'])
        m = m[_ring2nest_index(nside)]
    return m


def write_cl(path, cls):
    """healpy hp.write_cl format: one scalar float64 column per spectrum."""
    cls = np.atleast_2d(np.asarray(cls, dtype=np.float64))
    names = ['TEMPERATURE', 'GRADIENT', 'CURL', 'G-T', 'C-T', 'C-G']
    write_bintable(path, [(names[i] if i < len(names) else 'COL%d' % i, c)
                          for i, c in enumerate(cls)])


def read_cl(path, hdu=0):
    hdr, cols = read_bintables(path)[hdu]
    out = [np.asarray(c, dtype=np.float64).reshape(-1) for c in cols.values()]
    return out[0] if len(out) == 1 else np.asarray(out)


def _ring2nest_index(nside):
    """Permutation such that map_ring = map_nest[idx]: rank every nested pixel by its
    (ring, in-ring) position (the ring ordering). Used only for NESTED-file ingestion."""
    npix = 12 * nside * nside
    ix, iy, face = _nest2xyf(nside, np.arange(npix))
    ri_n, jj_n = _xyf2ring(nside, ix, iy, face)
    nest_keys = (ri_n.astype(np.int64) << 32) + jj_n
    order = np.argsort(nest_keys)
    # map_ring[p_ring] = map_nest[perm[p_ring]]; ring pixel index of key k is its rank
    return order


def _nest2xyf(nside, p):
    face = p // (nside * nside)
    pp = p % (nside * nside)
    ix = _compress_bits(pp)
    iy = _compress_bits(pp >> 1)
    return ix, iy, face


def _compress_bits(v):
    """Extract even bits of v (de-interleave)."""
    v = np.asarray(v, dtype=np.uint64)
    v &= np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v.astype(np.int64)


def _xyf2ring(nside, ix, iy, face):
    """Face coords -> (ring index 0-based from north, longitude index 0-based)."""
    jr = (np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])[face]) * nside - ix - iy - 1
    nr = np.where(jr < nside, jr,
                  np.where(jr > 3 * nside, 4 * nside - jr, nside))
    kshift = np.where((jr >= nside) & (jr <= 3 * nside), (jr - nside) & 1, 0)
    jp = (np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])[face] * nr
          + ix - iy + 1 + kshift) // 2
    nphi = np.where((jr >= nside) & (jr <= 3 * nside), 4 * nside, 4 * nr)
    jp = np.where(jp > nphi, jp - nphi, jp)
    jp = np.where(jp < 1, jp + nphi, jp)
    return jr - 1, jp - 1
