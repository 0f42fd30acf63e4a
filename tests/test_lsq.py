"""LSQ / ICM / SR tests — energy-model equivalence and improvement
guarantees (the properties the reference validates by eyeballing demo
recall; SURVEY.md §4 'what the reference lacks')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import random_dataset


def np_energy(X, C, B):
    """|x - sum_i C[i, b_i]|^2 via numpy decode."""
    Xh = np.zeros_like(X)
    for i in range(C.shape[0]):
        Xh += C[i][B[:, i]]
    return ((X - Xh) ** 2).sum(-1)


def test_chunk_energy_matches_veccost(rng):
    """MRF energy (unaries+binaries) + |x|^2 == reconstruction cost."""
    from rayuela_tpu.ops.icm import _chunk_energy
    from rayuela_tpu.ops.qerror import get_binaries, get_unaries
    X, C, B = random_dataset(rng, d=16, n=100, m=4, h=8)
    u = jnp.transpose(get_unaries(X, C), (1, 0, 2))       # (m, n, h)
    Bin = get_binaries(C)
    Bin = Bin * (1.0 - jnp.eye(4))[:, :, None, None]
    e = np.asarray(_chunk_energy(u, Bin, jnp.asarray(B)))
    expect = np_energy(X, C, B) - (X ** 2).sum(-1)
    np.testing.assert_allclose(e, expect, rtol=1e-3, atol=1e-3)


def test_icm_sweep_is_exact_coordinate_descent(rng):
    """After one ICM visit of node i, its code must be the exact argmin
    of the conditional energy given all other codes."""
    from rayuela_tpu.ops.icm import _icm_sweeps
    from rayuela_tpu.ops.qerror import get_binaries, get_unaries
    m, h, d, n = 4, 8, 16, 50
    X, C, B = random_dataset(rng, d=d, n=n, m=m, h=h)
    u = jnp.transpose(get_unaries(X, C), (1, 0, 2))
    Bin = get_binaries(C)
    Bin = Bin * (1.0 - jnp.eye(m))[:, :, None, None]
    T = jnp.transpose(Bin, (1, 0, 2, 3)).reshape(m, m * h, h)
    order = jnp.arange(m, dtype=jnp.int32)
    Bout = np.asarray(_icm_sweeps(u, T, jnp.asarray(B), order, 1))
    # node m-1 was visited last: check it is conditionally optimal
    i = m - 1
    for v in range(n):
        best, bestcost = None, np.inf
        for b in range(h):
            Bv = Bout[v].copy()
            Bv[i] = b
            c = np_energy(X[v:v + 1], C, Bv[None])[0]
            if c < bestcost:
                best, bestcost = b, c
        cur = np_energy(X[v:v + 1], C, Bout[v][None])[0]
        assert cur <= bestcost + 1e-4


def test_encoding_icm_never_worse_and_improves(rng):
    from rayuela_tpu.ops.icm import encoding_icm
    from rayuela_tpu.ops.qerror import veccost
    X, C, B0 = random_dataset(rng, d=16, n=300, m=4, h=16)
    B = encoding_icm(jax.random.PRNGKey(0), jnp.asarray(X),
                     jnp.asarray(C), jnp.asarray(B0),
                     ilsiter=4, icmiter=2, npert=1, chunk=128)
    c0 = np.asarray(veccost(X, C, B0))
    c1 = np.asarray(veccost(X, C, np.asarray(B)))
    assert (c1 <= c0 + 1e-4).all()          # per-vector accept-if-better
    assert c1.mean() < 0.7 * c0.mean()      # and substantial improvement


def test_encoding_icm_ragged_n(rng):
    from rayuela_tpu.ops.icm import encoding_icm
    X, C, B0 = random_dataset(rng, d=8, n=77, m=3, h=8)
    B = encoding_icm(jax.random.PRNGKey(1), jnp.asarray(X),
                     jnp.asarray(C), jnp.asarray(B0),
                     ilsiter=2, icmiter=1, npert=1, chunk=32)
    B = np.asarray(B)
    assert B.shape == (77, 3) and (B >= 0).all() and (B < 8).all()


def test_train_lsq_improves(rng):
    from rayuela_tpu.models.lsq import train_lsq
    d, m, h, n = 16, 4, 8, 512
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    B0 = jnp.asarray(rng.integers(0, h, (n, m)).astype(np.int32))
    model, B, obj = train_lsq(jax.random.PRNGKey(0), X, B0,
                              jnp.eye(d, dtype=jnp.float32),
                              h=h, niter=4, ilsiter=2, icmiter=2,
                              npert=1, chunk=128)
    obj = np.asarray(obj)
    assert obj[-1] < obj[0]
    assert model.codebooks.shape == (m, h, d)


@pytest.mark.parametrize("method", ["SR_C", "SR_D"])
def test_train_sr_improves(rng, method):
    from rayuela_tpu.models.sr import train_sr
    from rayuela_tpu.ops.qerror import qerror
    d, m, h, n = 16, 4, 8, 512
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    B0 = jnp.asarray(rng.integers(0, h, (n, m)).astype(np.int32))
    model, B, obj = train_sr(jax.random.PRNGKey(0), X, B0,
                             jnp.eye(d, dtype=jnp.float32), h=h,
                             niter=4, ilsiter=2, icmiter=2, npert=1,
                             method=method, chunk=128)
    obj = np.asarray(obj)
    assert obj[-1] < obj[0]
    # final codebooks are in the original space: recon error ≈ obj[-1]
    e = float(qerror(X, model.codebooks, B))
    assert abs(e - obj[-1]) / obj[-1] < 0.05


def test_apply_schedule_forms():
    from rayuela_tpu.models.sr import apply_schedule
    s = jnp.ones((3,))
    np.testing.assert_allclose(
        np.asarray(apply_schedule(s, 5, 10, 1, 0.5)),
        np.full(3, (1 - 0.5) ** 0.5), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(apply_schedule(s, 3, 10, 2, 0.5)),
        np.full(3, 1 / 2.0), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(apply_schedule(s, 4, 10, 3, 0.5)),
        np.full(3, 0.25), rtol=1e-6)


def test_icm_running_sweep_is_exact_coordinate_descent(rng):
    """Running-sum form: after one visit of node i its code is the
    exact argmin of the conditional energy given all other codes, and
    the carried reconstruction S equals the decode of the codes."""
    from rayuela_tpu.ops.icm import _icm_sweeps_running
    from rayuela_tpu.ops.qerror import get_unaries, reconstruct
    m, h, d, n = 4, 8, 16, 50
    X, C, B = random_dataset(rng, d=d, n=n, m=m, h=h)
    u = jnp.transpose(get_unaries(X, C), (1, 0, 2))
    order = jnp.asarray([2, 0, 3, 1], jnp.int32)
    Bout, S = _icm_sweeps_running(u, jnp.asarray(C), jnp.asarray(B),
                                  order, 1, jnp.float32)
    Bout = np.asarray(Bout)
    np.testing.assert_allclose(np.asarray(S), np.asarray(
        reconstruct(jnp.asarray(C), jnp.asarray(Bout))), rtol=1e-5,
        atol=1e-4)
    i = 1                                  # visited last
    for v in range(n):
        costs = []
        for b in range(h):
            Bv = Bout[v].copy()
            Bv[i] = b
            costs.append(np_energy(X[v:v + 1], C, Bv[None])[0])
        cur = np_energy(X[v:v + 1], C, Bout[v][None])[0]
        assert cur <= min(costs) + 1e-4


@pytest.mark.parametrize("m,npert", [(3, 1), (4, 2)])
def test_icm_forms_agree_in_f32(rng, m, npert):
    """On the CPU (f32 everywhere) the running-sum and table forms
    visit the same nodes with the same conditionals: same codes."""
    from rayuela_tpu.ops.icm import encoding_icm
    X, C, B0 = random_dataset(rng, d=16, n=300, m=m, h=8)
    key = jax.random.PRNGKey(3)
    kw = dict(ilsiter=3, icmiter=2, npert=npert, chunk=128)
    Br = encoding_icm(key, jnp.asarray(X), jnp.asarray(C),
                      jnp.asarray(B0), form="running", **kw)
    Bt = encoding_icm(key, jnp.asarray(X), jnp.asarray(C),
                      jnp.asarray(B0), form="table", **kw)
    assert (np.asarray(Br) == np.asarray(Bt)).mean() > 0.99


def test_encoding_icm_rejects_unknown_form(rng):
    from rayuela_tpu.ops.icm import encoding_icm
    X, C, B0 = random_dataset(rng, d=8, n=20, m=2, h=4)
    with pytest.raises(ValueError, match="form"):
        encoding_icm(jax.random.PRNGKey(0), X, C, B0, form="pallas")
