"""Platform-neutral code-resident search (`search.codes`): packing,
LUTs, the exact XLA LUT oracle and its tiling, the CPU route of
`search_codes`, and the host-streamed driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayuela_tpu.search import codes
from tests.conftest import random_dataset


def _lut_brute(T, B):
    """Float64 LUT accumulate — the reference algorithm verbatim
    (`deps/src/linscan_aqd.cpp:37-102`)."""
    T = np.asarray(T, np.float64)
    mprime, h, nq = T.shape
    s = np.zeros((nq, B.shape[0]))
    for j in range(mprime):
        s += T[j, B[:, j], :].T
    return s


@pytest.mark.parametrize("m", [1, 3, 4, 7, 9, 16, 17])
def test_pack_unpack_roundtrip(rng, m):
    B = rng.integers(0, 256, (37, m)).astype(np.int32)
    P = codes.pack_codes(jnp.asarray(B))
    assert P.shape == (37, -(-m // 4)) and P.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(codes.unpack_codes(P, m)), B)


def test_pack_norms_byte_is_last_column(rng):
    B = rng.integers(0, 256, (20, 4)).astype(np.int32)
    nc = rng.integers(0, 256, 20).astype(np.int32)
    U = np.asarray(codes.unpack_codes(
        codes.pack_codes(jnp.asarray(B), jnp.asarray(nc)), 5))
    np.testing.assert_array_equal(U[:, :4], B)
    np.testing.assert_array_equal(U[:, 4], nc)


@pytest.mark.parametrize("d,m", [(28, 4), (30, 8), (16, 4)])
def test_luts_pq_scores_are_true_distances(rng, d, m):
    from rayuela_tpu.ops.qerror import reconstruct_pq
    n, h, nq = 300, 16, 7
    ds = -(-d // m)
    C = rng.standard_normal((m, h, ds)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    # uneven splits: the trailing padding of a codebook is unused
    from rayuela_tpu.utils import splitarray
    for j, (_, sz) in enumerate(splitarray(d, m)):
        C[j][:, sz:] = 0.0
    T = codes.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=True, d=d)
    s = _lut_brute(T, B) + (Q ** 2).sum(-1, keepdims=True)
    Xd = np.asarray(reconstruct_pq(jnp.asarray(C), jnp.asarray(B), d))
    ref = ((Q[:, None, :] - Xd[None]) ** 2).sum(-1)
    np.testing.assert_allclose(s, ref, rtol=1e-4, atol=1e-3)


def test_luts_additive_with_norms_match_linscan_lsq_convention(rng):
    from rayuela_tpu.ops.qerror import reconstruct
    d, m, h, n, nq = 16, 3, 16, 200, 5
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h)
    ncb = rng.random(8).astype(np.float32) * 10
    nco = rng.integers(0, 8, n).astype(np.int32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    T = codes.build_luts(jnp.asarray(C), jnp.asarray(Q),
                         norms_cbook=jnp.asarray(ncb))
    assert T.shape == (m + 1, h, nq)
    s = _lut_brute(T, np.concatenate([B, nco[:, None]], 1))
    Xd = np.asarray(reconstruct(jnp.asarray(C), jnp.asarray(B)))
    ref = ncb[nco][None] - 2.0 * Q @ Xd.T
    np.testing.assert_allclose(s, ref, rtol=1e-4, atol=1e-3)


def test_luts_reject_oversized_norms_codebook(rng):
    C = rng.standard_normal((2, 8, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="must fit"):
        codes.build_luts(jnp.asarray(C), jnp.zeros((1, 4)),
                         norms_cbook=jnp.zeros(9))


@pytest.mark.parametrize("k", [1, 9, 300])
def test_xla_lut_scan_matches_brute(rng, k):
    d, m, h, n = 16, 4, 16, 300
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = rng.standard_normal((4, d)).astype(np.float32)
    T = codes.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=True, d=d)
    s, i = codes.xla_lut_scan(T, jnp.asarray(B), k)
    S = _lut_brute(T, B)
    np.testing.assert_allclose(np.asarray(s), np.sort(S, 1)[:, :k],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.take_along_axis(S, np.asarray(i), 1),
                               np.asarray(s), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("qblock,seg", [(2, 64), (3, 1000), (128, 97)])
def test_tiled_oracle_matches_monolithic(rng, qblock, seg):
    d, m, h, n, k = 16, 4, 16, 500, 11
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=d)
    Q = jnp.asarray(rng.standard_normal((7, d)).astype(np.float32))
    s1, _ = codes._xla_lut_scan_tiled(idx, Q, k, d, jnp.float32,
                                      qblock=qblock, seg=seg)
    T = codes.build_luts(idx.C, Q, pq=True, d=d)
    s2, _ = codes.xla_lut_scan(T, jnp.asarray(B), k)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-6,
                               atol=1e-5)


def test_tiled_oracle_unpacks_each_segment_once(rng, monkeypatch):
    d, m, h, n = 16, 4, 16, 1000
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=d)
    seen = []
    orig = codes.unpack_codes
    monkeypatch.setattr(codes, "unpack_codes",
                        lambda p, mp: seen.append(p.shape[0]) or orig(p, mp))
    Q = jnp.asarray(rng.standard_normal((9, d)).astype(np.float32))
    codes._xla_lut_scan_tiled(idx, Q, 5, d, jnp.float32, qblock=2, seg=256)
    assert seen == [256, 256, 256, 232]


@pytest.mark.parametrize("pq", [True, False])
def test_search_codes_cpu_route_true_distances(rng, pq):
    """On the CPU `search_codes` is the oracle: PQ scores are true
    squared distances, additive ones the norms-byte convention."""
    from rayuela_tpu.ops.qerror import reconstruct, reconstruct_pq
    d, m, h, n, k = 16, 4, 16, 400, 10
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    Q = rng.standard_normal((5, d)).astype(np.float32)
    if pq:
        idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B),
                                      pq=True, d=d)
        Xd = np.asarray(reconstruct_pq(jnp.asarray(C), jnp.asarray(B), d))
        D = ((Q[:, None] - Xd[None]) ** 2).sum(-1)
    else:
        ncb = rng.random(16).astype(np.float32) * 20
        nco = rng.integers(0, 16, n).astype(np.int32)
        idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B),
                                      d=d, norms_cbook=jnp.asarray(ncb),
                                      norms_codes=jnp.asarray(nco))
        Xd = np.asarray(reconstruct(jnp.asarray(C), jnp.asarray(B)))
        D = (Q ** 2).sum(-1)[:, None] - 2 * Q @ Xd.T + ncb[nco][None]
    s, i = codes.search_codes(idx, jnp.asarray(Q), k)
    np.testing.assert_allclose(np.asarray(s), np.sort(D, 1)[:, :k],
                               rtol=1e-4, atol=1e-3)


def test_search_codes_k_exceeding_n_clamps(rng):
    _, C, B = random_dataset(rng, d=8, n=30, m=2, h=8, pq=True)
    idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=8)
    s, i = codes.search_codes(idx, jnp.zeros((2, 8)), 100)
    assert s.shape == (2, 30) and np.isfinite(np.asarray(s)).all()


def test_additive_requires_norms(rng):
    _, C, B = random_dataset(rng, d=8, n=30, m=2, h=8)
    with pytest.raises(ValueError, match="norms byte"):
        codes.build_codes_index(jnp.asarray(C), jnp.asarray(B))


def test_norms_arguments_go_together(rng):
    _, C, B = random_dataset(rng, d=8, n=30, m=2, h=8)
    with pytest.raises(ValueError, match="go together"):
        codes.build_codes_index(jnp.asarray(C), jnp.asarray(B),
                                norms_cbook=jnp.zeros(4))


def test_decode_operands_are_cached(rng):
    _, C, B = random_dataset(rng, d=8, n=30, m=2, h=8, pq=True)
    idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=8)
    a = idx.decode_operands(8, jnp.float32)
    assert idx.decode_operands(8, jnp.float32) is a
    assert idx.decode_operands(8, jnp.bfloat16) is not a


@pytest.mark.parametrize("shard_n", [97, 250, 10_000])
def test_search_codes_streamed_matches_resident(rng, shard_n):
    d, m, h, n, k = 16, 4, 16, 600, 12
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((5, d)).astype(np.float32))
    idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=d)
    s1, i1 = codes.search_codes(idx, Q, k)
    host = np.asarray(codes.pack_codes(jnp.asarray(B)))
    s2, i2 = codes.search_codes_streamed(C, host, Q, k, pq=True, d=d,
                                         mprime=m, shard_n=shard_n)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))


def test_search_codes_streamed_from_memmap_with_norms(rng, tmp_path):
    from rayuela_tpu.search.norms import get_norms_codebook, quantize_norms
    d, m, h, n, k = 16, 3, 16, 500, 9
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h)
    Cj, Bj = jnp.asarray(C), jnp.asarray(B)
    _, ncb = get_norms_codebook(jax.random.PRNGKey(0), Cj, Bj, h=h)
    nco, _ = quantize_norms(Cj, Bj, ncb)
    idx = codes.build_codes_index(Cj, Bj, d=d, norms_cbook=ncb,
                                  norms_codes=nco)
    Q = jnp.asarray(rng.standard_normal((4, d)).astype(np.float32))
    s1, _ = codes.search_codes(idx, Q, k)
    path = tmp_path / "codes.bin"
    packed = np.asarray(idx.packed)
    mm = np.memmap(path, dtype=np.int32, mode="w+", shape=packed.shape)
    mm[:] = packed
    mm.flush()
    ro = np.memmap(path, dtype=np.int32, mode="r", shape=packed.shape)
    s2, _ = codes.search_codes_streamed(C, ro, Q, k, d=d, norms_cbook=ncb,
                                        mprime=m + 1, shard_n=128)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-5,
                               atol=1e-4)
