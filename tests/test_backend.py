"""Backend choices, the compile-cache helper, matmul precision, and the
column solves the fast loop and the projection rest on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import breeze_tpu as bz
from breeze_tpu import backend
from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver
from breeze_tpu.dynamics.tridiagonal import thomas_solve


@pytest.mark.parametrize("platform,bounded,expect", [
    ("cpu", False, ("fourier", "scan")),
    ("cpu", True, ("real", "scan")),
    ("gpu", False, ("real", "eigen")),
    ("gpu", True, ("real", "eigen")),
    ("rocm", False, ("fourier", "scan")),
])
def test_poisson_path(platform, bounded, expect):
    assert backend.poisson_path(bounded, platform) == expect


@pytest.mark.parametrize("topology", [
    (bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
    (bz.BOUNDED, bz.PERIODIC, bz.BOUNDED),
    (bz.BOUNDED, bz.FLAT, bz.BOUNDED),
], ids=["periodic", "channel", "channel_2d"])
def test_solver_follows_backend_choice(topology):
    g = bz.make_grid(size=(8, 1 if topology[1] == bz.FLAT else 8, 8),
                     extent=(1.0, 1.0, 1.0), topology=topology)
    rho = np.ones(9)
    s = build_anelastic_poisson_solver(g, rho[:8], rho)
    bounded = bz.BOUNDED in topology[:2]
    assert (s.transform, s.vertical_solve) == backend.poisson_path(bounded)


def test_explicit_fourier_takes_the_scan():
    g = bz.make_grid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED))
    rho = np.ones(9)
    s = build_anelastic_poisson_solver(g, rho[:8], rho, transform="fourier")
    assert (s.transform, s.vertical_solve) == ("fourier", "scan")
    gb = bz.make_grid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                      topology=(bz.BOUNDED, bz.PERIODIC, bz.BOUNDED))
    with pytest.raises(ValueError):
        build_anelastic_poisson_solver(gb, rho[:8], rho, transform="fourier")


@pytest.mark.parametrize("platform,expect", [("cpu", False), ("gpu", True)])
def test_auto_distribute(platform, expect):
    assert backend.auto_distribute(platform) is expect


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_environment(monkeypatch, tmp_path,
                                        restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    import os
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_compile_cache()
    assert path == backend.DEFAULT_CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.abspath(backend.__file__)))
    assert os.path.dirname(path) == root
    assert path == backend.enable_compile_cache()      # stable across calls
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _dot_precisions(fn, *args):
    """Precision of every dot_general in ``fn``'s jaxpr (sub-jaxprs too)."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


HIGHEST = jax.lax.Precision.HIGHEST


@pytest.mark.parametrize("x_topology,vertical", [
    (bz.PERIODIC, "eigen"), (bz.PERIODIC, "scan"), (bz.BOUNDED, "eigen"),
])
def test_poisson_matmuls_run_at_highest_precision(x_topology, vertical):
    g = bz.make_grid(size=(8, 6, 8), extent=(1.0, 1.0, 1.0),
                     topology=(x_topology, bz.PERIODIC, bz.BOUNDED),
                     dtype=jnp.float32)
    rho = np.linspace(1.2, 0.8, 9)
    s = build_anelastic_poisson_solver(g, rho[:8], rho, transform="real",
                                       vertical_solve=vertical)
    precisions = _dot_precisions(lambda d: s.solve(d, 1.0),
                                 jnp.zeros(g.shape, jnp.float32))
    assert precisions, "expected matrix products on this path"
    for p in precisions:
        assert p in (HIGHEST, (HIGHEST, HIGHEST)), p


def test_pencil_eigen_solve_runs_at_highest_precision():
    from jax.sharding import PartitionSpec as P

    from breeze_tpu.parallel.shard_step import PencilPoissonSolver, make_x_mesh
    g = bz.make_grid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                     dtype=jnp.float32)
    rho = np.linspace(1.2, 0.8, 9)
    base = build_anelastic_poisson_solver(g, rho[:8], rho, transform="real",
                                          vertical_solve="eigen")
    pencil = PencilPoissonSolver(base=base, nx_global=g.nx)
    fn = jax.shard_map(lambda d: pencil.solve(d, 1.0), mesh=make_x_mesh(2),
                       in_specs=P(None, None, "x"),
                       out_specs=P(None, None, "x"))
    precisions = _dot_precisions(fn, jnp.zeros(g.shape, jnp.float32))
    assert len(precisions) >= 4
    for p in precisions:
        assert p in (HIGHEST, (HIGHEST, HIGHEST)), p


@pytest.mark.parametrize("n,batch,dtype", [
    (2, (), np.float64), (7, (3,), np.float64), (16, (4, 5), np.float64),
    (33, (2, 3), np.float64), (16, (4, 5), np.float32), (64, (8,), np.float32),
])
def test_thomas_solve_matches_solve_banded(n, batch, dtype):
    rng = np.random.default_rng(n)
    shape = (n,) + batch
    lower = rng.uniform(-1.0, 1.0, shape)
    upper = rng.uniform(-1.0, 1.0, shape)
    diag = 3.0 + rng.uniform(0.0, 1.0, shape)     # diagonally dominant
    rhs = rng.normal(size=shape)
    got = np.asarray(thomas_solve(*(jnp.asarray(a, dtype)
                                    for a in (lower, diag, upper, rhs))))
    cols = int(np.prod(batch)) if batch else 1
    flat = [a.reshape(n, cols) for a in (lower, diag, upper, rhs)]
    ref = np.empty((n, cols))
    for j in range(cols):
        ab = np.zeros((3, n))
        ab[0, 1:] = flat[2][:-1, j]       # super-diagonal
        ab[1] = flat[1][:, j]
        ab[2, :-1] = flat[0][1:, j]       # sub-diagonal
        ref[:, j] = scipy.linalg.solve_banded((1, 1), ab, flat[3][:, j])
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got.reshape(n, cols), ref, rtol=tol,
                               atol=tol)
