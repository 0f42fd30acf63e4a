"""Codebook-update equivalence tests.

Mirrors the reference's cross-implementation strategy
(`test/chainq.jl:2-23`: fastbin-LU vs explicit-inverse; chain LSQR vs
chain blockwise) — here: chunked one-hot-matmul statistics vs a dense
numpy solve of the same ridge system.
"""

import numpy as np
import pytest

from tests.conftest import random_dataset


def dense_stats(X, B, h):
    n, m = B.shape
    U = np.zeros((n, m * h), np.float32)
    for i in range(m):
        U[np.arange(n), i * h + B[:, i]] = 1.0
    return U.T @ U, U.T @ X


def test_stats_match_dense(rng):
    from rayuela_tpu.ops.codebook_update import codebook_stats
    X, _, B = random_dataset(rng, d=24, n=533, m=4, h=16)
    G, F = codebook_stats(X, B, h=16, chunk=128)
    Gd, Fd = dense_stats(X, B, 16)
    np.testing.assert_allclose(np.asarray(G), Gd, atol=1e-4)
    np.testing.assert_allclose(np.asarray(F), Fd, atol=1e-3)


@pytest.mark.parametrize("method", ["fastbin", "lsqr"])
def test_update_matches_dense_ridge(rng, method):
    from rayuela_tpu.ops.codebook_update import update_codebooks
    h, rho = 16, 1e-4
    X, _, B = random_dataset(rng, d=24, n=800, m=4, h=h)
    C = update_codebooks(X, B, h=h, method=method, chunk=256)
    Gd, Fd = dense_stats(X, B, h)
    Cd = np.linalg.solve(Gd + rho * np.eye(4 * h, dtype=np.float32), Fd)
    np.testing.assert_allclose(
        np.asarray(C).reshape(4 * h, 24), Cd, rtol=2e-2, atol=2e-2)


def test_update_reduces_qerror(rng):
    """The solved codebooks must beat random ones on the LS objective."""
    from rayuela_tpu.ops.codebook_update import update_codebooks
    from rayuela_tpu.ops.qerror import qerror
    X, C0, B = random_dataset(rng, d=16, n=600, m=4, h=16)
    C = update_codebooks(X, B, h=16, chunk=256)
    assert float(qerror(X, C, B)) < float(qerror(X, C0, B))


def test_chain_solution_has_chain_support(rng):
    from rayuela_tpu.ops.codebook_update import (chain_dims,
                                                 update_codebooks_chain)
    d, m, h = 26, 4, 16  # uneven split: 26 dims over 3 ranges
    X, _, B = random_dataset(rng, d=d, n=700, m=m, h=h)
    C = np.asarray(update_codebooks_chain(X, B, h=h, chunk=256))
    sub = chain_dims(d, m)
    # codebook i spans ranges i-1 and i; zero elsewhere
    for i in range(m):
        active = np.zeros(d, bool)
        for r in ([i - 1] if i > 0 else []) + ([i] if i < m - 1 else []):
            st, sz = sub[r]
            active[st:st + sz] = True
        assert np.allclose(C[i][:, ~active], 0.0)
        assert not np.allclose(C[i][:, active], 0.0)


def test_generic_on_chain_supports_matches_chain_solver(rng):
    """`update_codebooks_generic(get_cbdims_chain)` must reproduce the
    dedicated chain solver — the reference derives
    `update_codebooks_chain` from the generic path the same way
    (`src/codebook_update.jl:353-365`)."""
    from rayuela_tpu.ops.codebook_update import (get_cbdims_chain,
                                                 update_codebooks_chain,
                                                 update_codebooks_generic)
    d, m, h = 26, 4, 16
    X, _, B = random_dataset(rng, d=d, n=700, m=m, h=h)
    Cg = np.asarray(update_codebooks_generic(X, B, h, get_cbdims_chain,
                                             chunk=256))
    Cc = np.asarray(update_codebooks_chain(X, B, h=h, chunk=256))
    np.testing.assert_allclose(Cg, Cc, rtol=2e-2, atol=2e-2)


def test_generic_on_full_supports_matches_dense(rng):
    """All-ones support = the unstructured update."""
    from rayuela_tpu.ops.codebook_update import update_codebooks_generic
    d, m, h, rho = 24, 4, 16, 1e-4
    X, _, B = random_dataset(rng, d=d, n=800, m=m, h=h)
    C = np.asarray(update_codebooks_generic(
        X, B, h, np.ones((d, m), bool), chunk=256))
    Gd, Fd = dense_stats(X, B, h)
    Cd = np.linalg.solve(Gd + rho * np.eye(m * h, dtype=np.float32), Fd)
    np.testing.assert_allclose(C.reshape(m * h, d), Cd,
                               rtol=2e-2, atol=2e-2)


def test_generic_on_random_supports_matches_per_dim_ridge(rng):
    """Arbitrary (random) supports: every dimension's slice must equal
    the dense ridge solve restricted to its covering codebooks —
    exactly `updatecb_struct!`'s per-dim restricted LS
    (`src/codebook_update.jl:296-310`). Its own seeded draw: the
    f32 solves are checked at a fixed tolerance, so the data must not
    depend on which tests consumed the shared generator before."""
    from rayuela_tpu.ops.codebook_update import update_codebooks_generic
    rng = np.random.default_rng(0)
    d, m, h, rho = 18, 5, 8, 1e-4
    X, _, B = random_dataset(rng, d=d, n=900, m=m, h=h)
    dim2C = rng.random((d, m)) < 0.5
    dim2C[3] = False                       # an unsupported dim → zeros
    C = np.asarray(update_codebooks_generic(X, B, h, dim2C, chunk=256))
    Gd, Fd = dense_stats(X, B, h)
    for i in range(d):
        cbs = np.nonzero(dim2C[i])[0]
        if len(cbs) == 0:
            assert np.allclose(C[:, :, i], 0.0)
            continue
        cols = np.concatenate([np.arange(c * h, (c + 1) * h)
                               for c in cbs])
        A = Gd[np.ix_(cols, cols)] + rho * np.eye(len(cols),
                                                  dtype=np.float32)
        sol = np.linalg.solve(A, Fd[cols, i])
        for j, c in enumerate(cbs):
            np.testing.assert_allclose(C[c, :, i], sol[j * h:(j + 1) * h],
                                       rtol=2e-2, atol=2e-2)
        # non-covering codebooks stay zero on this dim
        for c in np.nonzero(~dim2C[i])[0]:
            assert np.allclose(C[c, :, i], 0.0)


def test_chain_matches_full_solve_on_chain_dims(rng):
    """For dims in range i, the chain solve must equal the dense ridge
    solve restricted to codebooks (i, i+1) — the decoupling the
    reference's blockwise method exploits."""
    from rayuela_tpu.ops.codebook_update import (chain_dims,
                                                 update_codebooks_chain)
    d, m, h, rho = 24, 4, 16, 1e-4
    X, _, B = random_dataset(rng, d=d, n=900, m=m, h=h)
    C = np.asarray(update_codebooks_chain(X, B, h=h, chunk=256))
    Gd, Fd = dense_stats(X, B, h)
    sub = chain_dims(d, m)
    for i, (st, sz) in enumerate(sub):
        blk = slice(i * h, (i + 2) * h)
        A = Gd[blk, blk] + rho * np.eye(2 * h, dtype=np.float32)
        sol = np.linalg.solve(A, Fd[blk, st:st + sz])
        np.testing.assert_allclose(C[i][:, st:st + sz], sol[:h],
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(C[i + 1][:, st:st + sz], sol[h:],
                                   rtol=2e-2, atol=2e-2)


def test_update_codebooks_scale_invariant_ridge(rng):
    """Duplicating every vector scales (G, F) uniformly; with the
    ridge relative to diag(G) the solution must not change (an
    absolute ridge silently de-regularizes as n grows — the device-scale
    LSQ divergence of round 2)."""
    import jax.numpy as jnp

    from rayuela_tpu.ops.codebook_update import update_codebooks
    from tests.conftest import random_dataset
    X, C, B = random_dataset(rng, d=12, n=300, m=3, h=8)
    X, B = jnp.asarray(X), jnp.asarray(B)
    C1 = update_codebooks(X, B, h=8)
    Xd = jnp.concatenate([X] * 50)
    Bd = jnp.concatenate([B] * 50)
    C2 = update_codebooks(Xd, Bd, h=8)
    np.testing.assert_allclose(np.asarray(C1), np.asarray(C2),
                               rtol=2e-4, atol=2e-4)
