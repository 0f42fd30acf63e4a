"""ADC scan equivalence vs brute-force numpy LUT scan (the reference's
cross-implementation testing style, `test/chainq.jl:27-39`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rayuela_tpu.search.linscan import (eval_recall, linscan_cq, linscan_lsq,
                                        linscan_opq, linscan_pq, scan_topk)
from tests.conftest import random_dataset


def np_lut_scan_pq(Q, C, B):
    """Per-subspace squared-distance LUT accumulation — exactly
    deps/src/linscan_aqd.cpp:66-89."""
    nq, n, (m, h, ds) = Q.shape[0], B.shape[0], C.shape
    out = np.zeros((nq, n), np.float32)
    for i in range(m):
        qs = Q[:, i * ds:(i + 1) * ds]
        lut = ((qs[:, None] - C[i][None]) ** 2).sum(-1)   # (nq, h)
        out += lut[:, B[:, i]]
    return out


def np_lut_scan_full(Q, C, B, dbnorms):
    """Dot-product LUTs + dbnorms — linscan_aqd_pairwise_byte.cpp:14-94."""
    nq, n, m = Q.shape[0], B.shape[0], B.shape[1]
    out = np.tile(dbnorms[None], (nq, 1)).astype(np.float32)
    for i in range(m):
        lut = -2.0 * Q @ C[i].T
        out += lut[:, B[:, i]]
    return out


def test_scan_pq_matches_lut(rng):
    X, C, B = random_dataset(rng, d=16, n=500, m=4, h=8, pq=True)
    Q = rng.standard_normal((20, 16)).astype(np.float32)
    want = np_lut_scan_pq(Q, C, B)
    d, i = linscan_pq(jnp.asarray(C), jnp.asarray(Q), jnp.asarray(B),
                      k=500, tile=128)
    d, i = np.asarray(d), np.asarray(i)
    order = np.argsort(want, axis=1, kind="stable")
    # distances of returned ids match the LUT scan's
    np.testing.assert_allclose(d, np.take_along_axis(want, i, axis=1),
                               rtol=1e-4, atol=1e-3)
    # the best-scoring id agrees
    np.testing.assert_array_equal(i[:, 0], order[:, 0])
    # sorted distance values agree across the whole scan
    np.testing.assert_allclose(np.sort(d, 1),
                               np.take_along_axis(want, order, 1),
                               rtol=1e-4, atol=1e-3)


def test_scan_lsq_matches_lut_with_norms(rng):
    X, C, B = random_dataset(rng, d=16, n=300, m=4, h=8)
    Q = rng.standard_normal((10, 16)).astype(np.float32)
    norms_cbook = np.abs(rng.standard_normal(8)).astype(np.float32)
    norms_codes = rng.integers(0, 8, size=300).astype(np.int32)
    dbnorms = norms_cbook[norms_codes]
    want = np_lut_scan_full(Q, C, B, dbnorms)
    d, i = linscan_lsq(jnp.asarray(C), jnp.asarray(Q), jnp.asarray(B),
                       jnp.asarray(norms_cbook), jnp.asarray(norms_codes),
                       k=300, tile=128)
    d, i = np.asarray(d), np.asarray(i)
    # scan_topk adds |q|^2 (constant per query) — remove before comparing
    d = d - (Q ** 2).sum(1, keepdims=True)
    np.testing.assert_allclose(d, np.take_along_axis(want, i, axis=1),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(i[:, 0], want.argmin(1))


def test_scan_cq_ranking(rng):
    X, C, B = random_dataset(rng, d=16, n=200, m=3, h=8)
    Q = rng.standard_normal((10, 16)).astype(np.float32)
    # CQ LUT: sum_i |q - C_i[B_i]|^2
    want = np.zeros((10, 200), np.float32)
    for i in range(3):
        lut = ((Q[:, None] - C[i][None]) ** 2).sum(-1)
        want += lut[:, B[:, i]]
    d, i = linscan_cq(jnp.asarray(C), jnp.asarray(Q), jnp.asarray(B),
                      k=200, tile=64)
    d, i = np.asarray(d), np.asarray(i)
    np.testing.assert_allclose(d, np.take_along_axis(want, i, axis=1),
                               rtol=1e-4, atol=1e-3)


def test_opq_scan_rotates_queries(rng):
    X, C, B = random_dataset(rng, d=16, n=200, m=4, h=8, pq=True)
    Q = rng.standard_normal((5, 16)).astype(np.float32)
    Rm = np.linalg.qr(rng.standard_normal((16, 16)))[0].astype(np.float32)
    d1, i1 = linscan_opq(jnp.asarray(C), jnp.asarray(Q), jnp.asarray(B),
                         jnp.asarray(Rm), k=50, tile=64)
    d2, i2 = linscan_pq(jnp.asarray(C), jnp.asarray(Q @ Rm),
                        jnp.asarray(B), k=50, tile=64)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_scan_handles_unpadded_n(rng):
    X, C, B = random_dataset(rng, d=8, n=333, m=2, h=8)
    Q = rng.standard_normal((4, 8)).astype(np.float32)
    d, i = scan_topk(jnp.asarray(Q), jnp.asarray(C), jnp.asarray(B),
                     k=333, tile=128)
    assert np.all(np.asarray(i) < 333)
    assert np.all(np.isfinite(np.asarray(d)))


def test_eval_recall():
    gt = np.array([3, 7, 9])
    ids = np.array([[3, 1, 2],    # hit at rank 1
                    [1, 7, 2],    # hit at rank 2
                    [1, 2, 4]])   # miss
    curve = eval_recall(ids, gt, verbose=False)
    np.testing.assert_allclose(curve, [1 / 3, 2 / 3, 2 / 3])


def test_decode_base_matches_reconstruct(rng):
    from rayuela_tpu.ops.qerror import reconstruct
    from rayuela_tpu.search.linscan import decode_base
    X, C, B = random_dataset(rng, d=16, n=700, m=3, h=8)
    Xd, x2 = decode_base(jnp.asarray(C), jnp.asarray(B), chunk=256)
    ref = np.asarray(reconstruct(jnp.asarray(C), jnp.asarray(B)))
    np.testing.assert_allclose(np.asarray(Xd), ref, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(x2), (ref ** 2).sum(1),
                               rtol=1e-5)
    nt = jnp.arange(700, dtype=jnp.float32)
    _, x2o = decode_base(jnp.asarray(C), jnp.asarray(B), norm_term=nt)
    np.testing.assert_array_equal(np.asarray(x2o), np.asarray(nt))


@pytest.mark.parametrize("shard", [100, 333, 4096])
def test_search_streamed_matches_single_shot(rng, shard):
    from rayuela_tpu.search.linscan import (build_index, search,
                                            search_streamed)
    X, C, B = random_dataset(rng, d=16, n=1000, m=4, h=16, pq=True)
    Q = jnp.asarray(rng.standard_normal((5, 16)).astype(np.float32))
    dv, di = search(build_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                d=16), Q, 25)
    dv2, di2 = search_streamed(jnp.asarray(C), np.asarray(B), Q, 25,
                               pq=True, d=16, shard_size=shard)
    np.testing.assert_allclose(np.asarray(dv2), np.asarray(dv),
                               rtol=1e-5, atol=1e-4)
    # ids may permute among duplicate codes (equal distances): each
    # returned id must score its slot's distance
    from rayuela_tpu.ops.qerror import reconstruct_pq
    Xd = np.asarray(reconstruct_pq(jnp.asarray(C), jnp.asarray(B), 16))
    D = ((np.asarray(Q)[:, None] - Xd[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.take_along_axis(D, np.asarray(di2), 1),
                               np.asarray(dv), rtol=1e-4, atol=1e-4)


def test_exact_rescan_is_f32_highest_on_bf16_base(rng):
    """The oracle upcasts a bf16 decoded base and scores in f32."""
    from rayuela_tpu.search.linscan import exact_rescan
    Xd = rng.standard_normal((300, 16)).astype(np.float32)
    Xb = jnp.asarray(Xd).astype(jnp.bfloat16)
    x2 = jnp.sum(Xb.astype(jnp.float32) ** 2, axis=1)
    Q = rng.standard_normal((4, 16)).astype(np.float32)
    s, i = exact_rescan(jnp.asarray(Q), Xb, x2, 7)
    Xr = np.asarray(Xb.astype(jnp.float32), np.float64)
    D = ((Q[:, None].astype(np.float64) - Xr[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(s), np.sort(D, 1)[:, :7],
                               rtol=1e-5, atol=1e-4)
