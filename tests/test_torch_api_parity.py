"""The port's public surface held to the JAX package's, by `ast` over both source trees
(neither package is imported here).

For every public name of plancklens_tpu/**.py (module-level functions and classes, and the
methods of public classes, `__init__` included; none starting with '_'), the port module
with the same relative path must define it, of the same kind; its signature must accept
every JAX parameter by the same name (not through **kwargs); and each JAX positional
parameter must sit at the same position in the port: a required one as a positional
parameter, one with a default either there or keyword-only. So a caller written against
the JAX package neither raises TypeError nor binds an argument to another parameter.

The deliberate departures are the table DEPARTURES (module, name[, parameter]) -> reason,
and MODULE_MAP for a JAX module whose port is other modules; each entry must still be a
departure (a stale entry fails), and each carries its reason.

The repo's entry points likewise: every examples/*.py that imports plancklens_tpu has its
port examples/<name>_torch.py, or a DEPARTURES row ('examples/<name>.py',) with its reason.
A port script accepts every option and positional argument its JAX script declares with
`add_argument` (rows ('examples/<name>.py', option) name the exceptions), and `--device`;
where the JAX script's `main` takes parameters, the port's `main` takes them by the same
names, at the same positions, with the same defaults (and may add keyword-only ones).

Also: no import in plancklens_tpu_torch/**.py, chip_smoke.py or examples/*_torch.py names
jax or plancklens_tpu (the port's run-time rule; chip_smoke.py checks it on the card too).
"""
import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, 'plancklens_tpu')
PORT_PKG = os.path.join(REPO, 'plancklens_tpu_torch')

_TPU = ("TPU dispatch (XLA scan, MXU or Pallas), not ported (ROADMAP rule): a CUDA tensor "
        "takes kernels K1-K4, a CPU tensor their plain twins")
_F64 = ("the data's type is the tensor's, and the recursion runs in f64 for every data "
        "type (ROADMAP fault 3.2)")

DEPARTURES = {
    ('__init__.py', 'enable_x64'): "a JAX switch; the port takes each tensor's dtype",
    ('ops/sht/core.py', 'recursion_tables', 'grid_token'):
        "the port caches device tables in core.TABLES by grid token; recursion_tables is "
        "the uncached host build",
    ('ops/sht/core.py', 'recursion_tables', 'dtype'): _F64,
    ('ops/sht/core.py', 'legendre_synth_pair', 'dtype'): _F64,
    ('ops/sht/core.py', 'legendre_anal_pair', 'dtype'): _F64,
    ('ops/sht/core.py', 'legendre_synth', 'dtype'): _F64,
    ('ops/sht/core.py', 'legendre_anal', 'dtype'): _F64,
    ('ops/sht/core.py', 'legendre_synth_pair', 'engine'): _TPU,
    ('ops/sht/core.py', 'legendre_anal_pair', 'engine'): _TPU,
    ('ops/sht/core.py', 'legendre_synth', 'engine'): _TPU,
    ('ops/sht/core.py', 'legendre_anal', 'engine'): _TPU,
    ('ops/sht/transforms.py', 'SHT.__init__', 'engine'): _TPU,
    ('models/sims.py', 'sim_key'):
        "a jax.random key; the port draws from torch generators (ROADMAP fault 3.3)",
    ('models/sims.py', 'unit_phases', 'key'):
        "a torch.Generator `gen` in the jax.random key's place (ROADMAP fault 3.3)",
    ('parallel/mesh.py', 'sims_sharding'):
        "a GSPMD layout annotation; a rank's block of the sims is mesh.shard_batch",
    ('parallel/mesh.py', 'maps_sharding'):
        "a GSPMD layout annotation; a rank's ring block of a map is ShardedSHT.rings",
    ('parallel/mesh.py', 'make_mesh', 'devices'):
        "torch.distributed orders each axis group's ranks by rank, which the collectives "
        "rely on, so a mesh is every rank in rank order",
    ('parallel/distributed.py', 'host_array_to_global', 'spec'):
        "a jax PartitionSpec; the port all-gathers along the mesh's 'sims' axis",
    ('examples/bench_ondevice.py',):
        "the JAX package's TPU timing probe; its port waits for the port bench (ROADMAP "
        "queue 1 item 4)",
    ('examples/bench_qe_throughput.py',):
        "the JAX package's TPU QE throughput probe; its port waits for the port bench "
        "(ROADMAP queue 1 item 4)",
    ('examples/f32_precision_jax.py',):
        "the JAX package's side of ROADMAP fault 3.2's f32 record; the port's side is "
        "bench_legendre_torch.precision_rows",
    ('examples/run_qlms.py', '--cpu'):
        "pins the JAX backend to the CPU; the port's driver takes --device cpu",
    ('examples/run_qlms.py', '--x64'):
        "a JAX switch enabling float64; the port's dtypes are its parameter file's",
}

# JAX module -> (port modules, {JAX name: 'port module.name'}, reason)
MODULE_MAP = {
    'ops/sht/pallas_kernel.py': (
        ('ops/sht/legendre_kernels.py', 'ops/sht/roofline.py'),
        {'legendre_synth_pair_pallas': 'ops/sht/legendre_kernels.py:synth_pair',
         'legendre_anal_pair_pallas': 'ops/sht/legendre_kernels.py:anal_pair',
         'legendre_synth_pallas': 'ops/sht/legendre_kernels.py:synth',
         'legendre_anal_pallas': 'ops/sht/legendre_kernels.py:anal',
         'synth_pair_cost': 'ops/sht/roofline.py:pair_bound',
         'anal_pair_cost': 'ops/sht/roofline.py:pair_bound'},
        "the Pallas kernels K1-K4 are hand-written CUDA (ops/sht/csrc/legendre_pair.cu) "
        "bound in legendre_kernels.py; their cost model is roofline.py"),
}


def _modules(pkg):
    return sorted(os.path.relpath(p, pkg)
                  for p in glob.glob(os.path.join(pkg, '**', '*.py'), recursive=True))


def _public(path):
    """{name: ast node} of a module's public functions and classes, and 'Class.method'
    for the public methods (and __init__) of its public classes, methods of base classes
    defined in the same module included."""
    with open(path) as f:
        tree = ast.parse(f.read())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def methods(cls, seen=()):
        out = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
                out.update(methods(classes[base.id], seen + (cls.name,)))
        for n in cls.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                    not n.name.startswith('_') or n.name == '__init__'):
                out[n.name] = n
        return out

    out = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                or node.name.startswith('_'):
            continue
        out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for m, f in methods(node).items():
                out['%s.%s' % (node.name, m)] = f
    return out


def _params(fn):
    """(positional names, {positional name: has a default}, keyword-only names)."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    first_default = len(pos) - len(a.defaults)
    has_default = {p: i >= first_default for i, p in enumerate(pos)}
    return pos, has_default, [x.arg for x in a.kwonlyargs]


def _gaps(rel):
    """Every departure of the port's module `rel` from the JAX one, as (name[, param],
    what) tuples."""
    jax_names = _public(os.path.join(JAX_PKG, rel))
    port_path = os.path.join(PORT_PKG, rel)
    if not os.path.exists(port_path):
        return [((name,), 'no port module') for name in sorted(jax_names)]
    port_names = _public(port_path)
    gaps = []
    for name, jnode in sorted(jax_names.items()):
        pnode = port_names.get(name)
        if pnode is None:
            gaps.append(((name,), 'not defined'))
            continue
        if isinstance(jnode, ast.ClassDef) != isinstance(pnode, ast.ClassDef):
            gaps.append(((name,), 'a class in one package, a function in the other'))
            continue
        if isinstance(jnode, ast.ClassDef):
            continue
        jpos, jdef, jkw = _params(jnode)
        ppos, _, pkw = _params(pnode)
        for i, p in enumerate(jpos):
            if p in ppos:
                if ppos.index(p) != i:
                    gaps.append(((name, p), 'at position %d, the JAX package\'s %d'
                                 % (ppos.index(p), i)))
            elif p in pkw:
                if not jdef[p]:
                    gaps.append(((name, p), 'keyword-only, positional in the JAX package'))
            else:
                gaps.append(((name, p), 'not accepted'))
        gaps += [((name, p), 'not accepted') for p in jkw if p not in ppos + pkw]
    return gaps


JAX_MODULES = [m for m in _modules(JAX_PKG) if m not in MODULE_MAP]


@pytest.mark.parametrize('rel', JAX_MODULES)
def test_port_module_matches_the_jax_surface(rel):
    gaps = [(key, what) for key, what in _gaps(rel) if (rel,) + key not in DEPARTURES]
    assert not gaps, '%s of the port departs from the JAX package: %s' % (rel, gaps)


def _imports(path):
    """Top-level names of every module a file imports (absolute imports, nested too)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def _jax_examples(root=REPO):
    """'examples/<name>.py' of every example that imports the JAX package (not a port's)."""
    paths = glob.glob(os.path.join(root, 'examples', '*.py'))
    return sorted(os.path.relpath(p, root) for p in paths
                  if not p.endswith('_torch.py') and 'plancklens_tpu' in _imports(p))


def _arguments(path):
    """Option strings and positional names of every `add_argument` call in a script."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == 'add_argument':
            out.update(a.value for a in node.args
                       if isinstance(a, ast.Constant) and isinstance(a.value, str))
    return out


def _main(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return next((n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == 'main'),
                None)


def _example_gaps(rel, root=REPO):
    """Every departure of the port of the JAX example `rel` ('examples/<name>.py'), as
    (key, what) tuples: key () when it has no port, (option,) for an argument of the JAX
    script the port does not declare, ('--device',) when the port lacks it, ('main',
    parameter) for a parameter of the JAX script's main that the port's main lacks, moves or
    defaults otherwise."""
    jax_path = os.path.join(root, rel)
    port_path = jax_path[:-len('.py')] + '_torch.py'
    if not os.path.exists(port_path):
        return [((), 'no port script')]
    port_args = _arguments(port_path)
    gaps = [((a,), 'not declared') for a in sorted(_arguments(jax_path) - port_args)]
    if '--device' not in port_args:
        gaps.append((('--device',), 'not declared'))
    jmain, pmain = _main(jax_path), _main(port_path)
    if jmain is None or not jmain.args.args + jmain.args.kwonlyargs:
        return gaps
    if pmain is None:
        return gaps + [(('main',), 'not defined')]
    jpos, _, jkw = _params(jmain)
    ppos, _, pkw = _params(pmain)
    for i, p in enumerate(jpos):
        if p not in ppos or ppos.index(p) != i:
            gaps.append((('main', p), 'not at position %d' % i))
    gaps += [(('main', p), 'not accepted') for p in jkw if p not in ppos + pkw]

    def defaults(fn):
        a = fn.args
        pos = (a.posonlyargs + a.args)[len(a.posonlyargs + a.args) - len(a.defaults):]
        out = {x.arg: ast.literal_eval(d) for x, d in zip(pos, a.defaults)}
        out.update({x.arg: ast.literal_eval(d) for x, d in zip(a.kwonlyargs, a.kw_defaults)
                    if d is not None})
        return out
    jdef, pdef = defaults(jmain), defaults(pmain)
    gaps += [(('main', p), 'default %r, the JAX package\'s %r' % (pdef.get(p), v))
             for p, v in jdef.items() if pdef.get(p, object()) != v]
    return gaps


@pytest.mark.parametrize('rel', _jax_examples())
def test_jax_example_has_its_port(rel):
    gaps = [(key, what) for key, what in _example_gaps(rel) if (rel,) + key not in DEPARTURES]
    assert not gaps, '%s: %s' % (rel, gaps)


def test_example_check_finds_a_missing_port(tmp_path):
    """The check fails on a JAX example with no port, on a port missing an option, on one
    without --device, and on a port's main that moves or redefaults a parameter."""
    ex = tmp_path / 'examples'
    ex.mkdir()
    (ex / 'a.py').write_text('import plancklens_tpu\n')
    (ex / 'b.py').write_text('from plancklens_tpu.models import n0s\n'
                             'p.add_argument("--lmax")\np.add_argument("--iter")\n'
                             'def main(lmax=1, nsims=2):\n    pass\n')
    (ex / 'b_torch.py').write_text('p.add_argument("--lmax")\n'
                                   'def main(nsims=2, lmax=3, *, device):\n    pass\n')
    (ex / 'c.py').write_text('import numpy\n')
    assert _jax_examples(str(tmp_path)) == ['examples/a.py', 'examples/b.py']
    assert _example_gaps('examples/a.py', str(tmp_path)) == [((), 'no port script')]
    keys = [k for k, _ in _example_gaps('examples/b.py', str(tmp_path))]
    assert keys == [('--iter',), ('--device',), ('main', 'lmax'), ('main', 'nsims'),
                    ('main', 'lmax')]


@pytest.mark.parametrize('entry', sorted(DEPARTURES, key=str))
def test_departure_is_current_and_reasoned(entry):
    """Each departure still holds (the port still lacks the name or parameter) and names
    its reason, so the table stays as short as the code allows."""
    assert len(DEPARTURES[entry].split()) >= 5, DEPARTURES[entry]
    rel, key = entry[0], entry[1:]
    gaps = _example_gaps(rel) if rel.startswith('examples/') else _gaps(rel)
    assert key in [k for k, _ in gaps], (entry, 'is no longer a departure')


@pytest.mark.parametrize('rel', sorted(MODULE_MAP))
def test_module_map(rel):
    """A JAX module ported into other modules: each of its public names has its
    counterpart there, and nothing in it is left unmapped."""
    targets, names, reason = MODULE_MAP[rel]
    assert len(reason.split()) >= 5
    assert not os.path.exists(os.path.join(PORT_PKG, rel))
    assert sorted(_public(os.path.join(JAX_PKG, rel))) == sorted(names)
    for target in names.values():
        mod, name = target.split(':')
        assert mod in targets and name in _public(os.path.join(PORT_PKG, mod)), target


def _run_time_files():
    files = [os.path.join(PORT_PKG, m) for m in _modules(PORT_PKG)]
    files += [os.path.join(REPO, 'chip_smoke.py')]
    files += sorted(glob.glob(os.path.join(REPO, 'examples', '*_torch.py')))
    return [os.path.relpath(f, REPO) for f in files]


@pytest.mark.parametrize('rel', _run_time_files())
def test_run_time_code_imports_neither_jax_nor_the_jax_package(rel):
    bad = _imports(os.path.join(REPO, rel)) & {'jax', 'jaxlib', 'plancklens_tpu'}
    assert not bad, (rel, bad)
