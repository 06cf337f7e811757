"""Least time an H100 could take for one Legendre transform call, from the call's shape.

Frozen copy of the arithmetic of plancklens_tpu_torch/ops/sht/roofline.py (pair_bound,
plain_bound), counted from the shape alone (band limit, columns m0..m0 + M - 1, spin,
rings, batch, data type), never from the program's tables: any implementation of the same
call is held to the same work. The larger of the bytes the call must move over HBM's rate
and the operations it must do over the peak rate of their type:

  * operations over the (l >= l0(m), ring, m) points, l0(m) = max(m, |s|): 5 f64 flops a
    recursion step, on the FP64 units; 4 flops a complex-by-real multiply-add per map and
    accumulator, on the FP64 tensor cores for f64 data and on FP32 for f32 data;
  * bytes: every input read once, every output written once, and the recursion tables
    the call's shape implies (alpha, beta, gamma: (lmax + 1, M) f64; l0: M int32; the
    seed value (rows, M) f64 and exponent (rows, M) int32; cos theta: rows f64).

Pair calls (a north-south symmetric grid) recur on the ceil(R / 2) northern rings: mode 0
(spin 0, one input) one recursion and one accumulator a map; mode 1 (two inputs) two
recursions, four accumulators a map (two an input: its southern sum runs on the other
recursion); mode 2 (spin != 0, one input; not counted by the program's file) two
recursions and two accumulators. Plain calls (any other ring set) recur on every ring,
one recursion and one accumulator a map.
"""
import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W)
PEAK_BYTES, PEAK_F32, PEAK_F64, PEAK_F64_TC = 3.35e12, 67e12, 34e12, 67e12

# mode -> (recursions, accumulators a map, inputs = outputs a map)
PAIR_WORK = {0: (1, 1, 1), 1: (2, 4, 2), 2: (2, 2, 1)}


def _points(lmax, m0, M, spin, rows):
    l0 = np.maximum(np.arange(m0, m0 + M), abs(spin))
    return float(rows) * float(np.maximum(lmax + 1 - l0, 0).sum())


def _table_bytes(lmax, M, rows):
    return 3 * (lmax + 1) * M * 8 + M * 4 + rows * M * (8 + 4) + rows * 8


def bound(points, nrec, nacc, B, f64_data, nbytes):
    """(bound seconds, 'operations' or 'bytes')."""
    rec = points * nrec * 5.
    acc = points * nacc * B * 4.
    t_ops = max(rec / PEAK_F64, acc / (PEAK_F64_TC if f64_data else PEAK_F32))
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def pair_mode(spin, two_inputs):
    return 1 if two_inputs else (0 if spin == 0 else 2)


def pair_bound(lmax, m0, M, spin, two_inputs, nrings, B, f64_data):
    """Bound of a pair call (synthesis or analysis) of B maps on a symmetric grid."""
    nrec, nacc, nio = PAIR_WORK[pair_mode(spin, two_inputs)]
    rows = (nrings + 1) // 2
    csize = 16 if f64_data else 8
    nbytes = nio * B * (lmax + 1 + nrings) * M * csize \
        + nrec * _table_bytes(lmax, M, rows)
    return bound(_points(lmax, m0, M, spin, rows), nrec, nacc, B, f64_data, nbytes)


def plain_bound(lmax, m0, M, spin, nrings, B, f64_data):
    """Bound of a plain call (synthesis or analysis) of B maps on every ring."""
    nbytes = B * (lmax + 1 + nrings) * M * (16 if f64_data else 8) \
        + _table_bytes(lmax, M, nrings)
    return bound(_points(lmax, m0, M, spin, nrings), 1, 1, B, f64_data, nbytes)
