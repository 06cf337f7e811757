"""sqlite-backed persistent array and scalar stores (port of plancklens_tpu/utils/sql.py).

Same role as the reference caches for responses/N0s/N1/spectra (reference:
plancklens/helpers/sql.py): npdb maps string ids to numpy arrays, fldb to floats. They are
optional persistence layers behind the cacher interface; correctness never depends on
them (products are pure functions of configuration). The sqlite schema, the array
encoding (np.save bytes) and the add-if-absent semantics are the JAX package's, so a
database written by either package reads back in the other. Torch tensors are stored as
their host numpy arrays; reads return numpy arrays."""
import io
import os
import sqlite3

import numpy as np
import torch


def _adapt_array(arr):
    out = io.BytesIO()
    np.save(out, arr)
    out.seek(0)
    return memoryview(out.read())


def _convert_array(blob):
    out = io.BytesIO(bytes(blob))
    out.seek(0)
    return np.load(out)


def _host(arr):
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr)


class npdb:
    """id -> numpy array store (reference: plancklens/helpers/sql.py:28-66)."""

    def __init__(self, fname):
        os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
        sqlite3.register_adapter(np.ndarray, _adapt_array)
        sqlite3.register_converter('array', _convert_array)
        self.con = sqlite3.connect(fname, timeout=3600.,
                                   detect_types=sqlite3.PARSE_DECLTYPES)
        self.con.execute('create table if not exists db (id text primary key, arr array)')
        self.con.commit()

    def add(self, idx, arr):
        try:
            self.con.execute('insert into db (id, arr) values (?, ?)', (idx, _host(arr)))
            self.con.commit()
        except sqlite3.IntegrityError:
            pass  # id already present: keep the first write (add-if-absent semantics)

    def get(self, idx):
        cur = self.con.execute('select arr from db where id = ?', (idx,))
        row = cur.fetchone()
        return None if row is None else row[0]

    def remove(self, idx):
        self.con.execute('delete from db where id = ?', (idx,))
        self.con.commit()

    # cacher interface
    def cache(self, fn, obj):
        self.add(fn, obj)

    def load(self, fn):
        ret = self.get(fn)
        assert ret is not None, fn
        return ret

    def is_cached(self, fn):
        return self.get(fn) is not None


class fldb:
    """id -> float store (reference: plancklens/helpers/sql.py:68-106)."""

    def __init__(self, fname):
        os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
        self.con = sqlite3.connect(fname, timeout=3600.)
        self.con.execute('create table if not exists db (id text primary key, fl real)')
        self.con.commit()

    def add(self, idx, fl):
        try:
            self.con.execute('insert into db (id, fl) values (?, ?)', (idx, float(fl)))
            self.con.commit()
        except sqlite3.IntegrityError:
            pass

    def get(self, idx):
        cur = self.con.execute('select fl from db where id = ?', (idx,))
        row = cur.fetchone()
        return None if row is None else row[0]

    def remove(self, idx):
        self.con.execute('delete from db where id = ?', (idx,))
        self.con.commit()
