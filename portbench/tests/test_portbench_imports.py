"""No module of the benchmark imports JAX or the JAX package; the reference and the
inputs import nothing of the program either; a run loads none of them."""
import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {'jax', 'jaxlib', 'flax', 'plancklens_tpu'}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]


def _files(sub=''):
    for d, _, fs in os.walk(os.path.join(HERE, sub)):
        for f in fs:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: sorted(set(_imports(p)) & JAX) for p in _files()}
    assert not {p: b for p, b in bad.items() if b}, bad


def test_reference_and_inputs_import_no_program():
    paths = list(_files('reference')) + [os.path.join(HERE, 'inputs.py')]
    for p in paths:
        assert 'plancklens_tpu_torch' not in set(_imports(p)), p
        assert not set(_imports(p)) & JAX, p


def test_top_level_names_compared_whole():
    # the port's name begins with the JAX package's: it is allowed
    assert 'plancklens_tpu_torch'.split('.')[0] not in JAX


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, types; sys.path.insert(0, %r); sys.argv = ['x']\n"
            "import portbench.run as R\n"
            "a = types.SimpleNamespace(workload='ideal_l2048.mc_chain', seed=5, seconds=0.01,"
            " trace=0, control=None, override=dict(lmax_ivf=8, lmax_qlm=12, lmin_ivf=2,"
            " qe_dtype='float64'), traffic_override=dict(sims_per_step=2, warm_sims=2))\n"
            "out = R.run(a, 'cpu')\n"
            "print('FORBIDDEN', R.forbidden_modules(), out['correct'])\n"
            % os.path.dirname(HERE))
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    r = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert 'FORBIDDEN [] True' in r.stdout, r.stdout[-2000:]
