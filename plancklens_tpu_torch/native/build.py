"""Build the native host kernels: `python -m plancklens_tpu_torch.native.build`.

Compiles plkcore.cc with g++ (or $CXX) into the gitignored `plancklens_tpu_torch/_build/`,
the directory of the CUDA kernels' library, under a file lock, named by a hash of the
source, the compiler and its flags (role of the reference's setup-time f2py compilation of
plancklens/wigners/wigners.f90). With OpenMP where the compiler has it; a compiler without
OpenMP's runtime (no libgomp) builds the same source serially (its `omp` pragmas are then
ignored, and `_OPENMP` guards the rest), and the library's name says which (`plkcore_omp_*`
or `plkcore_serial_*`). The flags carry no -march=native: the build directory may be copied
to another host, and the library must run there. A build that fails both ways raises."""
import fcntl
import hashlib
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'plkcore.cc')
BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17')
# (name, extra flags), in the order tried
VARIANTS = (('omp', ('-fopenmp',)), ('serial', ()))


def compiler():
    return os.environ.get('CXX') or 'g++'


def library_path(source=None, build_dir=None, variant='omp'):
    source = source or SOURCE
    flags = CXX_FLAGS + dict(VARIANTS)[variant]
    with open(source, 'rb') as f:
        src = f.read()
    key = hashlib.sha1(src + ' '.join((compiler(),) + flags).encode()).hexdigest()[:16]
    return os.path.join(build_dir or BUILD_DIR, 'plkcore_%s_%s.so' % (variant, key))


def build(verbose=False, source=None, build_dir=None):
    """Compile `source` (default plkcore.cc) if it has no library in `build_dir` (default
    BUILD_DIR) yet, with OpenMP, else serially; returns the library's path. Raises
    RuntimeError when the compiler is missing or both builds fail."""
    source, build_dir = source or SOURCE, build_dir or BUILD_DIR
    for variant, _ in VARIANTS:
        so = library_path(source, build_dir, variant)
        if os.path.exists(so):
            return so
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, 'build.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        errors = []
        for variant, extra in VARIANTS:
            so = library_path(source, build_dir, variant)
            if os.path.exists(so):
                return so
            tmp = so + '.tmp%d' % os.getpid()
            cmd = [compiler(), *CXX_FLAGS, *extra, source, '-o', tmp]
            if verbose:
                print(' '.join(cmd))
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError('native build: cannot run %s (%s)' % (cmd[0], e)) from e
            if res.returncode == 0:
                os.replace(tmp, so)
                return so
            errors.append('%s (%d):\n%s' % (variant, res.returncode, res.stderr))
        raise RuntimeError('native build failed: %s' % '\n'.join(errors))


if __name__ == '__main__':
    print('built', build(verbose=True))
    sys.exit(0)
