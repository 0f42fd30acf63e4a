"""Pallas-Triton scan kernel (`search.scan_kernel`) in interpret mode on
the CPU: every result the kernel does not flag equals the exact oracle,
and flagged queries are repaired by the search wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayuela_tpu.search import scan_kernel as sk
from tests.conftest import random_dataset


def _brute(Q, Xd, x2, k):
    """Float64 top-k of x2 - 2 q.x (no |q|^2)."""
    S = (np.asarray(x2, np.float64)[None, :]
         - 2.0 * np.asarray(Q, np.float64) @ np.asarray(Xd, np.float64).T)
    order = np.argsort(S, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(S, order, axis=1), S


def _check_exact_unless_flagged(out, S, k, atol=1e-3):
    """Unflagged queries: the returned scores are the k smallest and
    each id scores what the kernel says."""
    s, i, fl = (np.asarray(a) for a in out)
    ref = np.sort(S, axis=1)[:, :k]
    ok = ~fl
    np.testing.assert_allclose(s[ok], ref[ok], rtol=1e-5, atol=atol)
    picked = np.take_along_axis(S, np.clip(i, 0, S.shape[1] - 1), axis=1)
    np.testing.assert_allclose(picked[ok], s[ok], rtol=1e-5, atol=atol)
    return fl


def _codes_case(rng, *, n, d, m, h, pq, nq=6):
    from rayuela_tpu.ops.qerror import reconstruct, reconstruct_pq
    from rayuela_tpu.search.codes import pack_codes
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    if pq:
        ds = -(-d // m)
        C = rng.standard_normal((m, h, ds)).astype(np.float32)
        Xd = np.asarray(reconstruct_pq(jnp.asarray(C), jnp.asarray(B), d))
        x2 = (Xd.astype(np.float64) ** 2).sum(1)
        packed, ncb = pack_codes(jnp.asarray(B)), None
    else:
        Xd = np.asarray(reconstruct(jnp.asarray(C), jnp.asarray(B)))
        ncb = (rng.random(h).astype(np.float32) * 5).astype(np.float32)
        nb = rng.integers(0, h, n).astype(np.int32)
        x2 = ncb[nb]
        packed = pack_codes(jnp.asarray(B), jnp.asarray(nb))
    Cf, nrm = sk.decode_operands(jnp.asarray(C), pq=pq, d=d,
                                 norms_cbook=None if ncb is None
                                 else jnp.asarray(ncb),
                                 dtype=jnp.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    return Q, Xd, x2, packed, Cf, nrm


@pytest.mark.parametrize("seed", range(8))
def test_kernel_randomized_vs_oracle(seed):
    """One seeded draw per case over the kernel's config space: index
    type, widths, k, and every plan override."""
    rng = np.random.default_rng(100 + seed)
    kind = ["decoded", "pq", "additive"][seed % 3]
    n = int(rng.integers(50, 1500))
    d = int(rng.choice([8, 16, 20, 32]))
    m = int(rng.choice([2, 4]))
    h = int(rng.choice([8, 16]))
    k = int(rng.integers(1, min(n, 40) + 1))
    cfg = dict(bq=int(rng.choice([16, 32])), tn=int(rng.choice([16, 32])),
               r=int(rng.choice([1, 2, 4])),
               nsplit=int(rng.integers(1, 6)))
    nq = int(rng.integers(1, 20))
    if kind == "decoded":
        Xd = rng.standard_normal((n, d)).astype(np.float32)
        x2 = (Xd ** 2).sum(1)
        Q = rng.standard_normal((nq, d)).astype(np.float32)
        out = sk.scan_topk_decoded(jnp.asarray(Q), jnp.asarray(Xd),
                                   jnp.asarray(x2), k, interpret=True,
                                   **cfg)
    else:
        Q, Xd, x2, packed, Cf, nrm = _codes_case(
            rng, n=n, d=d, m=m, h=h, pq=kind == "pq", nq=nq)
        out = sk.scan_topk_codes(jnp.asarray(Q), packed, Cf, nrm, k,
                                 pq=kind == "pq", m=m, h=h,
                                 interpret=True, **cfg)
    if out is None:       # plan declined: too few candidate slots
        p = sk.plan(nq, n, k, **cfg)
        assert p is None
        return
    _, S = _brute(Q, Xd, x2, k)
    _check_exact_unless_flagged(out, S, k)


@pytest.mark.parametrize("n", [1, 17, 64, 65, 1000, 2111])
def test_decoded_ragged_n(rng, n):
    d, nq = 16, 5
    Xd = rng.standard_normal((n, d)).astype(np.float32)
    x2 = (Xd ** 2).sum(1)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    k = min(n, 10)
    out = sk.scan_topk_decoded(jnp.asarray(Q), jnp.asarray(Xd),
                               jnp.asarray(x2), k, interpret=True)
    _, S = _brute(Q, Xd, x2, k)
    fl = _check_exact_unless_flagged(out, S, k)
    assert not fl.any()


@pytest.mark.parametrize("m", [4, 8, 16])
def test_codes_pq_matches_oracle(rng, m):
    Q, Xd, x2, packed, Cf, nrm = _codes_case(rng, n=700, d=32, m=m, h=16,
                                             pq=True)
    out = sk.scan_topk_codes(jnp.asarray(Q), packed, Cf, nrm, 12, pq=True,
                             m=m, h=16, interpret=True)
    _, S = _brute(Q, Xd, x2, 12)
    assert not _check_exact_unless_flagged(out, S, 12).any()


@pytest.mark.parametrize("m", [4, 8, 16])
def test_codes_additive_norms_byte_matches_oracle(rng, m):
    Q, Xd, x2, packed, Cf, nrm = _codes_case(rng, n=700, d=16, m=m, h=16,
                                             pq=False)
    out = sk.scan_topk_codes(jnp.asarray(Q), packed, Cf, nrm, 12,
                             pq=False, m=m, h=16, interpret=True)
    _, S = _brute(Q, Xd, x2, 12)
    assert not _check_exact_unless_flagged(out, S, 12).any()


@pytest.mark.parametrize("kind", ["decoded", "pq", "additive"])
def test_wide_descriptors_chunk_the_contraction(rng, kind):
    """d beyond one 128-column chunk: the score matmul loops over
    chunks (here 200 → two chunks, the second partly masked)."""
    d, n, k = 200, 400, 9
    if kind == "decoded":
        Xd = rng.standard_normal((n, d)).astype(np.float32)
        x2 = (Xd ** 2).sum(1)
        Q = rng.standard_normal((5, d)).astype(np.float32)
        out = sk.scan_topk_decoded(jnp.asarray(Q), jnp.asarray(Xd),
                                   jnp.asarray(x2), k, interpret=True)
    else:
        Q, Xd, x2, packed, Cf, nrm = _codes_case(
            rng, n=n, d=d, m=4, h=8, pq=kind == "pq", nq=5)
        out = sk.scan_topk_codes(jnp.asarray(Q), packed, Cf, nrm, k,
                                 pq=kind == "pq", m=4, h=8,
                                 interpret=True)
    _, S = _brute(Q, Xd, x2, k)
    assert not _check_exact_unless_flagged(out, S, k).any()


@pytest.mark.parametrize("d,m", [(28, 4), (30, 8), (20, 16), (24, 5)])
def test_codes_pq_uneven_subspaces(rng, d, m):
    """d % m != 0: the in-kernel column→subspace map must follow
    `splitarray` (the first d % m subspaces one column wider)."""
    Q, Xd, x2, packed, Cf, nrm = _codes_case(rng, n=300, d=d, m=m, h=8,
                                             pq=True)
    out = sk.scan_topk_codes(jnp.asarray(Q), packed, Cf, nrm, 7, pq=True,
                             m=m, h=8, interpret=True)
    _, S = _brute(Q, Xd, x2, 7)
    assert not _check_exact_unless_flagged(out, S, 7).any()


@pytest.mark.parametrize("d,m", [(128, 8), (28, 4), (30, 8), (17, 16)])
def test_owner_follows_splitarray(d, m):
    from rayuela_tpu.utils import splitarray
    want = np.concatenate([np.full(sz, j) for j, (_, sz)
                           in enumerate(splitarray(d, m))])
    got = np.asarray(sk._owner(jnp.arange(d), d, m))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_insert_keeps_r_smallest_and_drop_bound(rng, r):
    """`_insert` over a stream of tiles leaves, per lane, the r
    smallest values seen (sorted, with their ids) and the minimum of
    everything it dropped."""
    bq, tn, nt = 3, 4, 9
    vals = (jnp.full((bq, tn), jnp.inf),) * r
    ids = (jnp.full((bq, tn), -1, jnp.int32),) * r
    drop = jnp.full((bq, tn), jnp.inf)
    stream = rng.standard_normal((nt, bq, tn)).astype(np.float32)
    for t in range(nt):
        sid = jnp.broadcast_to(jnp.arange(tn, dtype=jnp.int32) + t * tn,
                               (bq, tn))
        vals, ids, drop = sk._insert(vals, ids, drop,
                                     jnp.asarray(stream[t]), sid)
    srt = np.sort(stream, axis=0)
    for j in range(r):
        np.testing.assert_array_equal(np.asarray(vals[j]), srt[j])
        got_ids = np.asarray(ids[j])
        np.testing.assert_array_equal(
            np.take_along_axis(stream.reshape(nt, bq, tn),
                               (got_ids // tn)[None], axis=0)[0], srt[j])
    np.testing.assert_array_equal(np.asarray(drop), srt[r])


@pytest.mark.parametrize("lam,r", [(0.05, 2), (0.5, 4), (2.0, 8),
                                   (0.0, 1)])
def test_poisson_tail(lam, r):
    from scipy.stats import poisson
    assert abs(sk._poisson_sf(r, lam) - poisson.sf(r, lam)) < 1e-12


@pytest.mark.parametrize("nq,n,k", [(10_000, 1_000_000, 100),
                                    (10_000, 1_000_000, 1000),
                                    (1, 10, 10), (256, 5000, 64),
                                    (1000, 100_000_000, 100),
                                    (7, 300, 129)])
def test_plan_is_valid(nq, n, k):
    p = sk.plan(nq, n, k)
    assert p is not None
    pow2 = lambda x: x & (x - 1) == 0            # noqa: E731
    assert pow2(p["bq"]) and pow2(p["tn"]) and pow2(p["r"] * p["tn"])
    assert p["bq"] >= 16 and p["tn"] >= 16
    assert p["nsplit"] * p["nt"] * p["tn"] >= n          # covers the base
    assert (p["nsplit"] - 1) * p["nt"] * p["tn"] < n     # no empty split
    assert p["nsplit"] * p["tn"] * p["r"] >= k
    assert 4 <= p["num_warps"] <= 16
    assert sk.plan(nq, n, n + 1) is None                  # k > n


def test_plan_overflow_budget_at_protocol_shape():
    """At the SIFT1M protocol shape the expected flagged queries per
    query stays inside the budget for both k classes."""
    for k in (100, 1000):
        p = sk.plan(10_000, 1_000_000, k)
        lanes = p["nsplit"] * p["tn"]
        assert lanes * sk._poisson_sf(p["r"], k / lanes) <= sk._FLAG_BUDGET


@pytest.mark.parametrize("pq", [True, False])
def test_decode_operands_layout(rng, pq):
    m, h, d = 4, 8, 12
    C = rng.standard_normal((m, h, d // m if pq else d)).astype(np.float32)
    ncb = rng.random(5).astype(np.float32)
    Cf, nrm = sk.decode_operands(jnp.asarray(C), pq=pq, d=d,
                                 norms_cbook=None if pq
                                 else jnp.asarray(ncb))
    assert Cf.shape == (m * h, d) and Cf.dtype == jnp.bfloat16
    assert nrm.shape == ((m + 1) * h,) and nrm.dtype == jnp.float32
    Cf = np.asarray(Cf, np.float32)
    if pq:
        for j in range(m):
            blk = Cf[j * h:(j + 1) * h]
            np.testing.assert_allclose(blk[:, 3 * j:3 * j + 3], C[j],
                                       rtol=1e-2)
            assert not np.delete(blk, range(3 * j, 3 * j + 3), 1).any()
        np.testing.assert_allclose(np.asarray(nrm)[:m * h],
                                   (C ** 2).sum(-1).reshape(-1), rtol=1e-6)
    else:
        np.testing.assert_allclose(Cf, C.reshape(m * h, d), rtol=1e-2)
        np.testing.assert_array_equal(np.asarray(nrm)[:m * h], 0)
        np.testing.assert_allclose(np.asarray(nrm)[m * h:m * h + 5], ncb)


def _overflow_base(rng, n, d, tn, copies):
    """A base whose true top-k for query 0 sits in ONE lane: `copies`
    identical rows at stride tn (same column of successive tiles)."""
    Xd = rng.standard_normal((n, d)).astype(np.float32) * 3
    v = rng.standard_normal(d).astype(np.float32)
    for t in range(copies):
        Xd[t * tn] = v + 1e-3 * t
    return Xd, v


def test_lane_overflow_is_flagged(rng):
    n, d, tn, r = 1024, 16, 16, 2
    Xd, v = _overflow_base(rng, n, d, tn, 6)
    Q = np.stack([v, rng.standard_normal(d).astype(np.float32)])
    x2 = (Xd ** 2).sum(1)
    out = sk.scan_topk_decoded(jnp.asarray(Q), jnp.asarray(Xd),
                               jnp.asarray(x2), 5, interpret=True, tn=tn,
                               r=r, nsplit=1, bq=16)
    _, S = _brute(Q, Xd, x2, 5)
    fl = _check_exact_unless_flagged(out, S, 5)
    assert fl[0]


@pytest.mark.parametrize("rescue", ["deep", "shallow"])
@pytest.mark.parametrize("mode", ["decoded", "codes"])
def test_flagged_queries_are_repaired(rng, mode, rescue, monkeypatch):
    """A plan too shallow for the data flags queries; the search
    wrappers repair them — with the deep rescue pass alone, or, when
    that flags too, with the exact XLA oracle."""
    from rayuela_tpu.search import codes, linscan
    m, h, d, n, k = 4, 16, 16, 2048, 24
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((6, d)).astype(np.float32))
    cfg = dict(r=1, tn=16, nsplit=2, bq=16)     # 32 slots >= k, overflows
    if rescue == "shallow":
        monkeypatch.setattr(sk, "_RESCUE", dict(r=1, tn=16))
    runs = []
    orig_topk = sk._topk
    monkeypatch.setattr(sk, "_topk", lambda *a, **kw: runs.append(kw["r"])
                        or orig_topk(*a, **kw))
    calls = []
    if mode == "codes":
        idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B),
                                      pq=True, d=d)
        orig = codes._xla_lut_scan_tiled
        s_ref, _ = codes.search_codes(idx, Q, k)      # CPU oracle route
        monkeypatch.setattr(codes, "_xla_lut_scan_tiled",
                            lambda *a, **kw: calls.append(1)
                            or orig(*a, **kw))
        s, i = codes.search_codes(idx, Q, k, interpret=True, **cfg)
    else:
        idx = linscan.build_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=d)
        orig = linscan.exact_rescan
        s_ref, _ = orig(Q, idx.Xd, idx.x2, k)
        monkeypatch.setattr(linscan, "exact_rescan",
                            lambda *a, **kw: calls.append(1)
                            or orig(*a, **kw))
        s, i = linscan.search(idx, Q, k, interpret=True, **cfg)
    assert len(runs) == 2, "a 1-deep buffer over 2 splits must flag"
    assert bool(calls) == (rescue == "shallow")
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("mode", ["decoded", "codes"])
def test_k_greater_than_n_clamps(rng, mode):
    from rayuela_tpu.search import codes, linscan
    m, h, d, n = 2, 8, 8, 40
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((3, d)).astype(np.float32))
    if mode == "codes":
        idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B),
                                      pq=True, d=d)
        s, i = codes.search_codes(idx, Q, 100, interpret=True)
    else:
        idx = linscan.build_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=d)
        s, i = linscan.search(idx, Q, 100, interpret=True)
    assert s.shape == (3, n) and np.isfinite(np.asarray(s)).all()
    assert sorted(np.asarray(i)[0].tolist()) == list(range(n))


@pytest.mark.parametrize("mode", ["decoded", "codes"])
def test_plan_declined_falls_back_to_oracle(rng, mode):
    """k beyond every buffer the plan can build (r=1, one 16-lane
    split): the search wrappers take the XLA oracle instead."""
    from rayuela_tpu.search import codes, linscan
    m, h, d, n, k = 2, 8, 8, 500, 100
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((3, d)).astype(np.float32))
    cfg = dict(r=1, tn=16, nsplit=1)
    assert sk.plan(3, n, k, **cfg) is None
    if mode == "codes":
        idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B),
                                      pq=True, d=d)
        s, _ = codes.search_codes(idx, Q, k, interpret=True, **cfg)
        s_ref, _ = codes.search_codes(idx, Q, k)
    else:
        idx = linscan.build_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                  d=d)
        s, _ = linscan.search(idx, Q, k, interpret=True, **cfg)
        s_ref, _ = linscan.exact_rescan(Q, idx.Xd, idx.x2, k)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_decoded_search_interpret_matches_cpu_route(rng, k):
    from rayuela_tpu.search import linscan
    _, C, B = random_dataset(rng, d=16, n=1500, m=4, h=16, pq=True)
    idx = linscan.build_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                              d=16)
    Q = jnp.asarray(rng.standard_normal((9, 16)).astype(np.float32))
    s1, i1 = linscan.search(idx, Q, k, interpret=True)
    s2, i2 = linscan.search(idx, Q, k)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("pq", [True, False])
def test_codes_search_interpret_matches_cpu_route(rng, pq):
    from rayuela_tpu.search import codes
    from rayuela_tpu.search.norms import get_norms_codebook, quantize_norms
    d, m, h, n = 16, 4, 16, 1200
    _, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    kw = {}
    if not pq:
        _, ncb = get_norms_codebook(jax.random.PRNGKey(0),
                                    jnp.asarray(C), jnp.asarray(B), h=h)
        ncodes, _ = quantize_norms(jnp.asarray(C), jnp.asarray(B), ncb)
        kw = dict(norms_cbook=ncb, norms_codes=ncodes)
    idx = codes.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=pq,
                                  d=d, **kw)
    Q = jnp.asarray(rng.standard_normal((7, d)).astype(np.float32))
    s1, _ = codes.search_codes(idx, Q, 20, interpret=True)
    s2, _ = codes.search_codes(idx, Q, 20)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5,
                               atol=1e-3)
