"""The benchmark of plancklens_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json at the root of the checkout, its configuration from
portbench/configs/<config>.json and its traffic from portbench/traffic/<traffic>.json,
builds the configuration's chain from the program's libraries
(portbench/builders/<builder>.py), warms it up, runs whole steps for `--seconds`, then
checks the sampled step against the configuration's plain reference and comparison
(portbench/reference/<reference>.py, or the chain's reference and harness/check.py's
comparison where the configuration names none) and prints one JSON line last. With
--trace 1 the window runs under torch.profiler and the line carries the per-layer metrics
(portbench/metrics/<metric>.py) instead of the end-to-end ones.
Needs a CUDA device; without one it exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '_cache')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'plancklens_tpu')
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ['USE_FLAX'] = '0'
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def say(*a):
    print(*a, flush=True)


def load_cell(name):
    """(cell, configuration, traffic, BENCHMARK.json) of the cell `name`."""
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell = next(w for w in bench['workloads'] if w['name'] == name)
    conf = next(c for c in bench['configs'] if c['name'] == cell['config'])
    with open(os.path.join(ROOT, conf['file'])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, 'traffic', cell['traffic'] + '.json')) as f:
        traffic = json.load(f)
    cfg['qe_keys'] = list(traffic['keys'])
    return cell, cfg, traffic, bench


def metric_names(bench, cell, trace):
    """The cell's end-to-end (trace 0) or per-layer (trace 1) metrics."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group if cell['name'] in m.get('workloads', [cell['name']])]


def load_metric(name):
    """The reader of per-layer metric `name`: portbench/metrics/<name>.py."""
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('portbench_metric_' + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(cfg):
    """(Reference, compare) of a configuration: those of portbench/reference/<name>.py where
    it names a `reference`, else the chain's reference and harness/check.py's comparison."""
    if 'reference' in cfg:
        mod = importlib.import_module('portbench.reference.' + cfg['reference'])
        return mod.Reference, mod.compare
    from portbench.harness.check import compare
    from portbench.reference.chain import Reference
    return Reference, compare


def forbidden_modules():
    return sorted({n.split('.')[0] for n in sys.modules} & set(FORBIDDEN))


def device_lines():
    """nvidia-smi's reading of the card (name, power limit, clocks), for the record."""
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
                            'clocks.max.sm,temperature.gpu', '--format=csv,noheader'],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return 'nvidia-smi: %s' % e


def run(args, device):
    """One run on `device`; returns the result's dict (printed by main)."""
    import numpy as np
    import torch
    from portbench.harness import trace as tr
    from portbench.harness.chain import Chain
    from portbench.harness.check import program_products
    from portbench.inputs import Inputs

    cuda = torch.device(device).type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell, cfg, traffic, bench = load_cell(args.workload)
    cfg.update(args.override or {})
    traffic.update(args.traffic_override or {})
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    split = {}
    t = time.perf_counter()
    import plancklens_tpu_torch
    from plancklens_tpu_torch.ops.sht import core
    from plancklens_tpu_torch.models.qest import QELib
    tables_s = [0.]
    rt = core.recursion_tables

    def timed_tables(*a, **kw):
        t0 = time.perf_counter()
        try:
            return rt(*a, **kw)
        finally:
            tables_s[0] += time.perf_counter() - t0
    core.recursion_tables = timed_tables
    inp = Inputs(cfg, args.seed, device, traffic)
    split['imports_inputs_s'] = time.perf_counter() - t
    t = time.perf_counter()
    rec = tr.Recorder(sync=bool(args.trace) and cuda)
    builder = importlib.import_module('portbench.builders.' + cfg['builder'])
    par = builder.build(cfg, traffic, inp, device, CACHE, control=args.control)
    sync()
    split['libraries_s'] = time.perf_counter() - t
    t = time.perf_counter()
    chain = Chain(par, traffic, args.seed, rec)
    chain.setup()
    split['warmup_s'] = time.perf_counter() - t
    split['recursion_tables_host_s'] = tables_s[0]
    if args.trace:
        tr.wrap_legendre(rec, core, plancklens_tpu_torch.__name__)
        for name in ('get_sim_qlm_batch', 'get_sim_qlm'):
            tr.wrap_method(rec, QELib, name, 'qe')
        for solver in par.solvers.values():
            tr.wrap_method(rec, solver, 'solve_wf', 'cg', count=_count_iters)
    sync()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - T_START
    prof = tr.profiler() if args.trace else None
    if prof is not None:
        prof.__enter__()
    n, secs = chain.window(args.seconds)
    sync()
    layer = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            layer = tr.read_trace(path, rec)
        finally:
            os.remove(path)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    failed = sorted(set().union(*(s['bad'] for s in chain.steps)))
    say('window: %d sims in %d steps, %.3f s; set-up %.3f s %s; peak %d bytes'
        % (n, len(chain.steps), secs, setup_s, json.dumps(split), peak))

    t = time.perf_counter()
    prog = program_products(cfg, chain)
    if args.control == 'tf32':
        prog = control_products(cfg, inp, prog, device)
    del chain, par
    if cuda:
        torch.cuda.empty_cache()
    Reference, compare = load_reference(cfg)
    ref = Reference(cfg, inp, device)
    nums, detail = compare(cfg, prog, ref)
    sync()
    say('reference and comparison: %.3f s' % (time.perf_counter() - t))
    say('readings: ' + json.dumps(detail))
    limits = cfg['limits']
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in nums.items()}
    correct = all(np.isfinite(v) and v <= limits[k] for k, v in nums.items()) \
        and not failed

    if args.trace:
        ctx = dict(rec=rec, layer=layer, sims=n, window_s=secs, cfg=cfg)
        legendre = load_metric('_legendre')
        for kind in ('synth', 'anal'):
            say('legendre %s shapes [calls, device s, bound s, bound by]: %s'
                % (kind, json.dumps(legendre.shapes(ctx, kind))))
        metrics = {}
        for m in metric_names(bench, cell, True):
            v = load_metric(m['name']).read(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': setup_s if m['name'] == 'setup_s' else 3600. * n / secs,
                               'unit': m['unit']}
                   for m in metric_names(bench, cell, False)}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
           'count': 1, 'memory_peak_bytes': peak}
    out = {'correct': bool(correct), 'attempted': int(n), 'failed': len(failed),
           'metrics': metrics, 'device': dev}
    if layer is not None:
        dev['busy_s'] = layer['busy_s']
        dev['window_s'] = layer['window_s']
        out['breakdown'] = {'device_ops': layer['device_ops'],
                            'idle_gaps': layer['idle_gaps']}
    out['checks'] = checks
    return out


def _count_iters(rec, out):
    rec.counts['cg_iters'] += int(out[1])
    rec.counts['cg_solves'] += 1


def control_products(cfg, inp, prog, device):
    """The control of an f32 configuration: the reference itself, its products of f32
    data run on the TF32 tensor cores, in the program's place."""
    import torch
    Reference, _ = load_reference(cfg)
    ref = Reference(cfg, inp, device, dtype=torch.float32, tf32=True)
    idxs = prog['idxs']
    cur = ref.filtered(idxs)
    qlm, mf = ref.estimators(cur, ref.filtered([-1]), ref.filtered([i - 1 for i in idxs]),
                             ref.filtered(prog['warm']))
    cpu = lambda x: tuple(t.cpu() for t in x) if isinstance(x, tuple) else x.cpu()
    return dict(prog, filt=cpu(cur), qlm={k: cpu(v) for k, v in qlm.items()},
                mf={k: cpu(v) for k, v in mf.items()},
                qcl={k: v.cpu() for k, v in ref.spectra(qlm, mf).items()})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, default=0, choices=(0, 1))
    p.add_argument('--control', default=None, choices=('f32', 'qe_f32', 'tf32'),
                   help='run the control in the program\'s place (the checks must fail)')
    args = p.parse_args(argv)
    args.override = args.traffic_override = None
    import torch
    cell, _, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print('no CUDA device (or fewer than the cell\'s %d): the benchmark runs on the '
              'card only' % cell['chips'], file=sys.stderr)
        return 2
    say('device: ' + device_lines())
    out = run(args, 'cuda:0')
    bad = forbidden_modules()
    if bad:
        print('modules of JAX or the JAX package were loaded: %s' % ', '.join(bad),
              file=sys.stderr)
        return 3
    for k, c in out['checks'].items():
        print('check %s %.6e limit %.6e' % (k, c['value'], c['limit']), file=sys.stderr)
    say(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
