"""Least time an H100 could take for one Legendre kernel call (K1-K4), for the timing
scripts (chip_smoke.py, examples/bench_legendre_torch.py): the larger of the bytes the call
must move over HBM's rate and the operations it must do over the peak rate of their type.

Operations are counted over the (l >= l0(m), ring, m) points the call's tables need: 5 f64
flops per recursion step ((a x + b) d - g d_prev), and a complex-by-real multiply-add of 4
flops per map and accumulator in the data type. Bytes: each input read once, each output
written once, plus the recursion tables.

How many accumulators a point needs, per map (`PAIR_WORK`):
  * mode 0 (spin 0, one input, one recursion): one. A ring's southern value is its
    northern one with (-1)^(l+m) on each term, so the sums over even and odd l + m, E and
    O, give both: north E + O, south (-1)^m (E - O). Every term enters one of them.
  * mode 1 (spin != 0, two inputs, both recursions): two per input. d^l_{mn}(pi - t) =
    (-1)^(l+m) d^l_{m,-n}(t), so an input's southern sum runs on the other recursion than
    its northern one: two different products a term, which no parity split merges.
  * mode 3 (plain, every ring): one per map.
The accumulate is a matrix product over l (per m: maps x l by l x rings), which in f64 can
run on the FP64 tensor cores; the recursion cannot. So f64 data are held to the larger of
the recursion over FP64 and the accumulate over the FP64 tensor cores, f32 data to the
larger of the recursion over FP64 and the accumulate over FP32 (the recursion runs in f64
for f32 data too; TF32 would not compute the same function).
"""
import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s; flop/s of FP32 and FP64 outside
# the tensor cores, and of FP64 on them
PEAK_BYTES, PEAK_F32, PEAK_F64, PEAK_F64_TC = 3.35e12, 67e12, 34e12, 67e12

# pair mode -> (recursions, accumulators a map, inputs = outputs a map)
PAIR_WORK = {0: (1, 1, 1), 1: (2, 4, 2)}


def bound(l0, L, rows, nrec, nacc, B, f64_data, nbytes):
    """(bound_ms, bound_by) of a call of B maps whose recursions run on `rows` rings, with
    `nrec` recursions and `nacc` accumulators a map at each point and `nbytes` to move;
    bound_by is 'operations' or 'bytes'."""
    points = float(rows) * float(np.maximum(L - np.asarray(l0, dtype=np.int64), 0).sum())
    rec = points * nrec * 5.
    acc = points * nacc * B * 4.
    t_ops = max(rec / PEAK_F64, acc / (PEAK_F64_TC if f64_data else PEAK_F32))
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def table_bytes(t):
    """Bytes of one recursion-table set (its scalar entries excluded)."""
    return sum(v.numel() * v.element_size() for k, v in t.items() if k != 'S')


def pair_bound(tables, mode, B, nrings, f64_data):
    """bound() of a pair call (K1 synthesis or K2 analysis, mode 0 or 1) of B maps on a
    north-south symmetric grid of `nrings` rings: `tables` = (t_m,) in mode 0, (t_m, t_p)
    otherwise; the recursions run on the ceil(nrings / 2) northern rings."""
    nrec, nacc, nio = PAIR_WORK[mode]
    L, M = tables[0]['alpha'].shape
    csize = 16 if f64_data else 8
    nbytes = nio * B * (L + nrings) * M * csize + sum(table_bytes(t) for t in tables)
    return bound(tables[0]['l0'].cpu().numpy(), L, (nrings + 1) // 2, nrec, nacc, B,
                 f64_data, nbytes)


def plain_bound(t, B, nrings, f64_data):
    """bound() of a plain call (K3 synthesis or K4 analysis) of B maps on `nrings` rings:
    one recursion and one accumulator a map on every ring."""
    L, M = t['alpha'].shape
    nbytes = B * (L + nrings) * M * (16 if f64_data else 8) + table_bytes(t)
    return bound(t['l0'].cpu().numpy(), L, nrings, 1, 1, B, f64_data, nbytes)
