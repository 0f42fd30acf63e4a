"""ChainQ / Viterbi tests — cross-implementation equivalence, mirroring
reference `test/chainq.jl:27-39` (Julia == CUDA == C++ exact code
equality); here: batched lax.scan Viterbi == brute-force enumeration."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import random_dataset


def brute_force_chain(X, C):
    """Exact minimizer of |x - sum_i C[i, b_i]|^2 by enumerating all h^m
    code combinations (tiny m, h only)."""
    m, h, d = C.shape
    combos = np.stack(np.meshgrid(*[np.arange(h)] * m,
                                  indexing="ij"), -1).reshape(-1, m)
    decode = np.zeros((len(combos), d), np.float32)
    for i in range(m):
        decode += C[i][combos[:, i]]
    d2 = ((X[:, None, :] - decode[None]) ** 2).sum(-1)   # (n, h^m)
    return combos[np.argmin(d2, axis=1)], d2.min(1)


def chain_supported_codebooks(rng, m, h, d):
    """Random codebooks with chain support (codebook i nonzero only on
    dim ranges i-1 and i) — the structure under which the chain MRF's
    adjacent-only binaries are exact."""
    from rayuela_tpu.ops.codebook_update import chain_dims
    C = np.zeros((m, h, d), np.float32)
    sub = chain_dims(d, m)
    for i in range(m):
        for r in ([i - 1] if i > 0 else []) + ([i] if i < m - 1 else []):
            st, sz = sub[r]
            C[i, :, st:st + sz] = rng.standard_normal((h, sz)) * 0.5
    return C


def test_viterbi_matches_brute_force(rng):
    from rayuela_tpu.ops.viterbi import viterbi_encode
    from rayuela_tpu.ops.qerror import veccost
    m, h, d, n = 3, 5, 8, 64
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = chain_supported_codebooks(rng, m, h, d)
    B = np.asarray(viterbi_encode(jnp.asarray(X), jnp.asarray(C), chunk=32))
    _, best_cost = brute_force_chain(X, C)
    got_cost = np.asarray(veccost(X, C, B))
    # cost equality (codes can tie); Viterbi must achieve the optimum
    np.testing.assert_allclose(got_cost, best_cost, rtol=1e-4, atol=1e-4)


def test_viterbi_ragged_n(rng):
    from rayuela_tpu.ops.viterbi import viterbi_encode
    m, h, d, n = 4, 6, 8, 37   # n not a multiple of chunk
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((m, h, d)).astype(np.float32)
    B = np.asarray(viterbi_encode(jnp.asarray(X), jnp.asarray(C), chunk=16))
    assert B.shape == (n, m) and (B >= 0).all() and (B < h).all()


def test_viterbi_beats_greedy(rng):
    """Chain-optimal encoding must never be worse than greedy RVQ-style
    encoding with the same codebooks."""
    from rayuela_tpu.ops.viterbi import viterbi_encode
    from rayuela_tpu.models.rvq import quantize_rvq
    from rayuela_tpu.ops.qerror import qerror
    m, h, d, n = 4, 16, 12, 200
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = chain_supported_codebooks(rng, m, h, d)
    Bv = viterbi_encode(jnp.asarray(X), jnp.asarray(C), chunk=64)
    Bg, _ = quantize_rvq(jnp.asarray(C), jnp.asarray(X))
    assert float(qerror(X, C, Bv)) <= float(qerror(X, C, Bg)) + 1e-5


def test_train_chainq_improves_over_init(rng):
    from rayuela_tpu.models.chainq import train_chainq
    from rayuela_tpu.ops.qerror import qerror
    d, m, h, n = 16, 4, 8, 512
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    B0 = jnp.asarray(rng.integers(0, h, (n, m)).astype(np.int32))
    R0 = jnp.eye(d, dtype=jnp.float32)
    model, B, obj = train_chainq(X, B0, R0, h=h, niter=5, chunk=128)
    obj = np.asarray(obj)
    assert obj[-1] < obj[0]
    # monotone non-increasing objective (alternating exact minimizations)
    assert np.all(np.diff(obj) <= 1e-3 * obj[0])
    # codebooks respect chain support
    from rayuela_tpu.ops.codebook_update import chain_dims
    C = np.asarray(model.codebooks)
    sub = chain_dims(d, m)
    st0, sz0 = sub[1]
    assert np.allclose(C[3][:, st0:st0 + sz0], 0.0)  # cb 3 spans ranges 1+2... not 1
    # R stays orthonormal
    R = np.asarray(model.R)
    np.testing.assert_allclose(R @ R.T, np.eye(d), atol=1e-4)


def test_quantize_chainq_roundtrip(rng):
    from rayuela_tpu.models.chainq import (ChainQModel, quantize_chainq,
                                           train_chainq)
    d, m, h, n = 12, 3, 8, 256
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    B0 = jnp.asarray(rng.integers(0, h, (n, m)).astype(np.int32))
    model, B, _ = train_chainq(X, B0, jnp.eye(d, dtype=jnp.float32),
                               h=h, niter=3, chunk=64)
    B2 = quantize_chainq(model, X, chunk=64)
    np.testing.assert_array_equal(np.asarray(B), np.asarray(B2))


@pytest.mark.parametrize("chunk", [64, 256, 4096])
def test_viterbi_chunking_is_invariant(rng, chunk):
    """Chunked batched min-plus == one-chunk encode on ragged n (pad
    rows are encoded and dropped)."""
    import jax.numpy as jnp
    from rayuela_tpu.ops.viterbi import viterbi_encode
    d, m, h, n = 24, 4, 16, 700
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((m, h, d)).astype(np.float32)
    B_ref = np.asarray(viterbi_encode(jnp.asarray(X), jnp.asarray(C),
                                      chunk=1024))
    B = np.asarray(viterbi_encode(jnp.asarray(X), jnp.asarray(C),
                                  chunk=chunk))
    assert B.shape == (n, m)
    np.testing.assert_array_equal(B, B_ref)


def test_viterbi_single_codebook(rng):
    """m=1 degenerates to nearest-center assignment."""
    import jax.numpy as jnp
    from rayuela_tpu.ops.viterbi import viterbi_encode
    d, h, n = 8, 16, 300
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((1, h, d)).astype(np.float32)
    B = np.asarray(viterbi_encode(jnp.asarray(X), jnp.asarray(C),
                                  chunk=128))
    ref = np.argmin(((X[:, None, :] - C[0][None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(B[:, 0], ref)
