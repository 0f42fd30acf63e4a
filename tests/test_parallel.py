"""Multi-device sharding tests on the virtual 8-device CPU mesh —
sharded execution must match single-device results (the multi-host
coverage the reference never had; SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.conftest import random_dataset


@pytest.fixture(scope="module")
def mesh(request):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    from rayuela_tpu.parallel.mesh import make_mesh
    return make_mesh(4, 2)


def test_sharded_scan_matches_local(rng, mesh):
    from rayuela_tpu.parallel.mesh import sharded_scan_topk
    from rayuela_tpu.search.linscan import scan_topk
    X, C, B = random_dataset(rng, d=16, n=3001, m=4, h=16)  # ragged n
    Q = rng.standard_normal((9, 16)).astype(np.float32)
    d_ref, i_ref = scan_topk(jnp.asarray(Q), jnp.asarray(C),
                             jnp.asarray(B), k=20, tile=512)
    d_sh, i_sh = sharded_scan_topk(mesh, jnp.asarray(Q), jnp.asarray(C),
                                   jnp.asarray(B), k=20, tile=512)
    np.testing.assert_array_equal(np.asarray(i_sh), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                               rtol=1e-4, atol=1e-4)


def test_sharded_stats_match_single_device(rng, mesh):
    from jax import shard_map
    from rayuela_tpu.ops.codebook_update import codebook_stats
    X, _, B = random_dataset(rng, d=12, n=800, m=3, h=8)

    def local(X, B):
        G, F = codebook_stats(X, B, 8, chunk=128)
        return jax.lax.psum(G, "data"), jax.lax.psum(F, "data")

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data", None), P("data", None)),
                   out_specs=(P(), P()), check_vma=False)
    G_sh, F_sh = jax.jit(fn)(jnp.asarray(X), jnp.asarray(B))
    G, F = codebook_stats(jnp.asarray(X), jnp.asarray(B), 8, chunk=128)
    np.testing.assert_allclose(np.asarray(G_sh), np.asarray(G),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(F_sh), np.asarray(F),
                               rtol=1e-4, atol=1e-3)


def test_sharded_sr_step_improves_and_matches_codebooks(rng, mesh):
    """The sharded step's codebook solve must equal the single-device
    solve (stats are exact sums), and the step must reduce the
    objective."""
    from rayuela_tpu.parallel.lsq_sharded import (
        make_sr_train_step, replicated_solve_matches)
    from rayuela_tpu.parallel.mesh import shard_data
    from rayuela_tpu.ops.qerror import qerror
    d, m, h, n = 16, 3, 8, 640
    X = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)

    step = make_sr_train_step(mesh, h=h, niter=4, ilsiter=2, icmiter=2,
                              npert=1, method="LSQ", chunk=64,
                              stats_chunk=128)
    Xs = shard_data(mesh, jnp.asarray(X))
    Bs = shard_data(mesh, jnp.asarray(B))
    C0 = jnp.zeros((m, h, d), jnp.float32)
    C1, B1, obj1 = step(Xs, Bs, C0, jnp.int32(0), jax.random.PRNGKey(0))
    # LSQ step (no noise): solved codebooks == single-device solve
    C_ref = replicated_solve_matches(jnp.asarray(X), jnp.asarray(B), h,
                                     chunk=128)
    # G is near-singular (+ tiny ridge), so per-entry drift from f32
    # summation order is amplified; compare entries loosely and the
    # functional quality tightly.
    np.testing.assert_allclose(np.asarray(C1), np.asarray(C_ref),
                               atol=5e-2)
    e_sh = float(qerror(X, C1, B))
    e_ref = float(qerror(X, C_ref, B))
    assert abs(e_sh - e_ref) / e_ref < 1e-3
    # encode happened and improved the objective vs solved C + old B
    before = float(qerror(X, C1, B))
    assert float(obj1) <= before + 1e-4


def test_pq_lloyd_sharded_matches_unsharded(rng, mesh):
    from rayuela_tpu.parallel.mesh import pq_lloyd_step_sharded
    from rayuela_tpu.ops.kmeans import assign, update_centers
    m, h, n, ds = 2, 8, 512, 8
    Xs = rng.standard_normal((m, n, ds)).astype(np.float32)
    cent = rng.standard_normal((m, h, ds)).astype(np.float32)

    Xs_d = jax.device_put(jnp.asarray(Xs),
                          NamedSharding(mesh, P("model", "data", None)))
    cent_d = jax.device_put(jnp.asarray(cent),
                            NamedSharding(mesh, P("model", None, None)))
    new_c, obj = pq_lloyd_step_sharded(Xs_d, cent_d, h)

    ref_c = []
    for i in range(m):
        a, mind2 = assign(jnp.asarray(Xs[i]), jnp.asarray(cent[i]))
        ref_c.append(update_centers(jnp.asarray(Xs[i]), a, h,
                                    jnp.asarray(cent[i]), costs=mind2))
    np.testing.assert_allclose(np.asarray(new_c),
                               np.asarray(jnp.stack(ref_c)),
                               rtol=1e-4, atol=1e-4)


def test_sharded_codes_search_matches_local(rng, mesh):
    """Code-resident sharded search (codes sharded over data, queries
    and codebooks replicated; the CPU route is the XLA LUT scan per
    shard) == single-device XLA LUT scan — and the jitted executable is
    cached across calls."""
    from rayuela_tpu.parallel.mesh import (_sharded_search_codes_fn,
                                           sharded_search_codes)
    from rayuela_tpu.search.codes import (build_luts, pack_codes,
                                          xla_lut_scan)
    from tests.test_codes import _lut_brute
    d, m, h, n, nq, k = 16, 4, 16, 2111, 6, 15   # ragged vs 4-way shard
    X, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    T = build_luts(jnp.asarray(C), Q, pq=True, d=d)
    packed = pack_codes(jnp.asarray(B))
    s_ref, i_ref = xla_lut_scan(T, jnp.asarray(B), k)
    before = _sharded_search_codes_fn.cache_info().misses
    s_sh, i_sh, fl = sharded_search_codes(mesh, Q, jnp.asarray(C), packed,
                                          k=k, pq=True, d=d)
    s_sh2, _, _ = sharded_search_codes(mesh, Q, jnp.asarray(C), packed,
                                       k=k, pq=True, d=d)
    assert (_sharded_search_codes_fn.cache_info().misses - before) == 1
    assert not np.asarray(fl).any()
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(s_sh2), np.asarray(s_sh))
    # returned ids score identically to the reference ranking
    picked = np.take_along_axis(_lut_brute(T, B), np.asarray(i_sh), axis=1)
    np.testing.assert_allclose(picked, np.asarray(s_sh),
                               rtol=1e-4, atol=1e-3)


def test_sharded_codes_decode_search_matches_local(rng, mesh):
    """The scan kernel's in-kernel decode per shard (interpret mode,
    under shard_map) == single-device XLA LUT scan, for PQ codes and
    for additive codes with a norms byte."""
    from rayuela_tpu.parallel.mesh import sharded_search_codes
    from rayuela_tpu.search.codes import (build_luts, pack_codes,
                                          xla_lut_scan)
    d, m, h, n, nq, k = 16, 4, 16, 2111, 6, 15   # ragged vs 4-way shard
    X, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    T = build_luts(jnp.asarray(C), Q, pq=True, d=d)
    s_ref, _ = xla_lut_scan(T, jnp.asarray(B), k)
    s_sh, _, fl = sharded_search_codes(
        mesh, Q, jnp.asarray(C), pack_codes(jnp.asarray(B)), k=k, pq=True,
        d=d, interpret=True)
    assert not np.asarray(fl).any()
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_ref),
                               rtol=1e-4, atol=1e-3)
    _, Ca, _ = random_dataset(rng, d=d, n=n, m=m, h=h)
    ncb = jnp.asarray(rng.random(h).astype(np.float32) * 10)
    nco = jnp.asarray(rng.integers(0, h, n).astype(np.int32))
    Ta = build_luts(jnp.asarray(Ca), Q, norms_cbook=ncb)
    Ba = jnp.concatenate([jnp.asarray(B), nco[:, None]], axis=1)
    s_ref, _ = xla_lut_scan(Ta, Ba, k)
    s_sh, _, fl = sharded_search_codes(
        mesh, Q, jnp.asarray(Ca), pack_codes(jnp.asarray(B), nco), k=k,
        pq=False, d=d, norms_cbook=ncb, interpret=True)
    assert not np.asarray(fl).any()
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_ref),
                               rtol=1e-4, atol=1e-3)


def test_sharded_pallas_search_matches_local(rng, mesh):
    """Decoded-index sharded search (the scan kernel per shard,
    interpret mode) == single-device exact scan."""
    from rayuela_tpu.parallel.mesh import sharded_search
    from rayuela_tpu.search.linscan import exact_rescan
    n, d, nq, k = 2111, 16, 6, 15   # ragged vs 4-way shard
    Xd = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    x2 = jnp.sum(Xd * Xd, axis=-1)
    Q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    d_ref, i_ref = exact_rescan(Q, Xd, x2, k)
    d_sh, i_sh, fl = sharded_search(mesh, Xd, x2, Q, k=k, interpret=True)
    assert not np.asarray(fl).any()
    np.testing.assert_array_equal(np.asarray(i_sh), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                               rtol=1e-4, atol=1e-3)


def test_launch_single_process_fallbacks(rng, mesh):
    """Multi-host bootstrap degrades cleanly to single-process: no-op
    initialize, global mesh over local devices, host_local_to_global
    places a device array with the right sharding."""
    from rayuela_tpu.parallel.launch import (global_mesh,
                                             host_local_to_global,
                                             initialize)
    assert initialize() is False          # no coordinator configured
    gm = global_mesh(n_model=2)
    assert dict(gm.shape)["model"] == 2
    x = rng.standard_normal((16, 4)).astype(np.float32)
    xg = host_local_to_global(gm, x)
    np.testing.assert_array_equal(np.asarray(xg), x)
    assert xg.sharding.spec == P("data", None)


def test_api_search_with_mesh_matches_single(rng, mesh):
    """Facade `api.search(..., mesh=...)`: sharded results == the
    exact brute-force top-k (decoded mode, interpret-mode kernel)."""
    from rayuela_tpu import api
    d, m, h = 16, 4, 16
    Xt = rng.standard_normal((600, d)).astype(np.float32)
    Xb = rng.standard_normal((2000, d)).astype(np.float32)
    Q = rng.standard_normal((7, d)).astype(np.float32)
    model = api.train(Xt, method="pq", m=m, h=h, niter=3)
    idx = api.index_base(model, Xb)
    d1, i1 = api.search(idx, Q, k=15)
    d2, i2 = api.search(idx, Q, k=15, mesh=mesh, interpret=True)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                               rtol=1e-4, atol=1e-3)
    # ids may permute only among equal decoded rows; check scores of
    # picked ids match
    Xd = np.asarray(idx.scan_index.Xd)
    x2 = np.asarray(idx.scan_index.x2)
    D = (-2.0 * np.asarray(Q) @ Xd.T + x2[None]
         + (np.asarray(Q) ** 2).sum(-1, keepdims=True))
    picked = np.take_along_axis(D, np.asarray(i2), axis=1)
    np.testing.assert_allclose(picked, np.asarray(d2), rtol=1e-4,
                               atol=1e-3)


def test_api_search_codes_with_mesh_matches_single(rng, mesh):
    from rayuela_tpu import api
    d, m, h = 16, 4, 16
    Xt = rng.standard_normal((600, d)).astype(np.float32)
    Xb = rng.standard_normal((1500, d)).astype(np.float32)
    Q = rng.standard_normal((5, d)).astype(np.float32)
    model = api.train(Xt, method="pq", m=m, h=h, niter=3)
    idx = api.index_base(model, Xb, mode="codes")
    d1, i1 = api.search(idx, Q, k=10)
    d2, i2 = api.search(idx, Q, k=10, mesh=mesh, interpret=True,
                        lut_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                               rtol=1e-4, atol=1e-3)


def test_api_search_codes_mesh_flagged_rescue_is_tiled(rng, mesh,
                                                       monkeypatch):
    """Certificate-flagged queries on the api.search(mesh=,
    mode='codes') path must repair through the TILED LUT oracle —
    never a whole-base unpack_codes + xla_lut_scan (~4m bytes/vector
    unpack + an (nflagged, n) score matrix would not fit at n >= 1e8).
    Force flags with a one-deep kernel buffer and assert (a) the tiled
    oracle ran with bounded segment unpacks, (b) results stay exact."""
    from rayuela_tpu import api
    from rayuela_tpu.search import codes as scp
    d, m, h, n = 16, 4, 16, 4096
    Xt = rng.standard_normal((600, d)).astype(np.float32)
    Xb = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((4, d)).astype(np.float32)
    model = api.train(Xt, method="pq", m=m, h=h, niter=3)
    idx = api.index_base(model, Xb, mode="codes")
    seen = []
    orig_unpack = scp.unpack_codes

    def spy_unpack(packed, mp):
        seen.append(int(packed.shape[0]))
        return orig_unpack(packed, mp)

    monkeypatch.setattr(scp, "unpack_codes", spy_unpack)
    orig_tiled = scp._xla_lut_scan_tiled
    called = {}

    def tiled(ix, Qj, k, dd, lut_dtype, **kwa):
        called["yes"] = True
        return orig_tiled(ix, Qj, k, dd, lut_dtype, qblock=2, seg=512)

    monkeypatch.setattr(scp, "_xla_lut_scan_tiled", tiled)
    # 16 lanes x depth 1 per shard: 16 slots for k=16 overflow at once
    s2, i2 = api.search(idx, Q, k=16, mesh=mesh, interpret=True,
                        lut_dtype=jnp.float32, r=1, tn=16, nsplit=1)
    assert called.get("yes"), "a one-deep buffer did not flag"
    assert seen and max(seen) <= 512      # no whole-base unpack
    from rayuela_tpu.ops.qerror import reconstruct_pq
    Xd = np.asarray(reconstruct_pq(jnp.asarray(model.codebooks),
                                   jnp.asarray(idx.codes), d))
    D = ((Q[:, None, :] - Xd[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(s2), np.sort(D, 1)[:, :16],
                               rtol=1e-4, atol=1e-3)


def test_sharded_viterbi_matches_single(rng, mesh):
    """Data-parallel Viterbi (the reference's ChainQ worker farm,
    `src/ChainQ.jl:334-344`) must be code-exact vs the single-device
    encode — Viterbi is deterministic; only argmin ties could differ,
    and random real-valued costs have none."""
    from rayuela_tpu.ops.viterbi import viterbi_encode
    from rayuela_tpu.parallel.chainq_sharded import sharded_viterbi_encode
    d, m, h, n = 12, 3, 8, 1013            # ragged n (pad path)
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((m, h, d)).astype(np.float32) * 0.3
    B_ref = viterbi_encode(jnp.asarray(X), jnp.asarray(C))
    B_sh = sharded_viterbi_encode(mesh, jnp.asarray(X), jnp.asarray(C))
    np.testing.assert_array_equal(np.asarray(B_sh), np.asarray(B_ref))


def test_train_chainq_sharded_matches_single(rng, mesh):
    """Full sharded ChainQ training == single-device training up to
    psum fp-reduction order (the whole pipeline is deterministic)."""
    from rayuela_tpu.models.chainq import train_chainq
    from rayuela_tpu.parallel.chainq_sharded import train_chainq_sharded
    d, m, h, n, niter = 12, 3, 8, 1000, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    B0 = rng.integers(0, h, (n, m)).astype(np.int32)
    R0 = jnp.eye(d)
    mref, Bref, oref = train_chainq(jnp.asarray(X), jnp.asarray(B0), R0,
                                    h=h, niter=niter)
    msh, Bsh, osh = train_chainq_sharded(mesh, X, B0, R0, h=h,
                                         niter=niter)
    np.testing.assert_allclose(np.asarray(osh), np.asarray(oref),
                               rtol=1e-3)
    # codes agree except at (rare) near-tie boundaries
    agree = (np.asarray(Bsh) == np.asarray(Bref)).mean()
    assert agree > 0.95, agree
    np.testing.assert_allclose(np.asarray(msh.R), np.asarray(mref.R),
                               atol=1e-3)


def test_train_chainq_sharded_ragged_n(rng, mesh):
    """Ragged n: pad rows carry code -1 (zero one-hot), so the stats,
    objective and rotation are EXACT — compare against single-device
    training on the unpadded data."""
    from rayuela_tpu.models.chainq import train_chainq
    from rayuela_tpu.parallel.chainq_sharded import train_chainq_sharded
    d, m, h, n, niter = 12, 3, 8, 997, 2   # prime n: every shard ragged
    X = rng.standard_normal((n, d)).astype(np.float32)
    B0 = rng.integers(0, h, (n, m)).astype(np.int32)
    R0 = jnp.eye(d)
    mref, Bref, oref = train_chainq(jnp.asarray(X), jnp.asarray(B0), R0,
                                    h=h, niter=niter)
    msh, Bsh, osh = train_chainq_sharded(mesh, X, B0, R0, h=h,
                                         niter=niter)
    assert Bsh.shape == (n, m)
    np.testing.assert_allclose(np.asarray(osh), np.asarray(oref),
                               rtol=1e-3)
    assert (np.asarray(Bsh) == np.asarray(Bref)).mean() > 0.95


def test_train_lsq_family_sharded_improves(rng, mesh):
    """Sharded LSQ/SR trainers: objective decreases and lands within a
    band of the single-device trainer (trajectories differ — ICM keys
    fold the shard index)."""
    from rayuela_tpu.models.lsq import train_lsq
    from rayuela_tpu.parallel.lsq_sharded import train_lsq_family_sharded
    d, m, h, n, niter = 12, 3, 8, 1000, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    B0 = rng.integers(0, h, (n, m)).astype(np.int32)
    R0 = jnp.eye(d)
    key = jax.random.PRNGKey(0)
    mref, _, oref = train_lsq(key, jnp.asarray(X), jnp.asarray(B0), R0,
                              h=h, niter=niter, ilsiter=2, icmiter=2,
                              npert=1, chunk=256)
    msh, Bsh, osh = train_lsq_family_sharded(
        mesh, key, X, B0, R0, h=h, niter=niter, ilsiter=2, icmiter=2,
        npert=1, method="LSQ", chunk=256)
    osh, oref = np.asarray(osh), np.asarray(oref)
    assert Bsh.shape == (n, m) and osh.shape == oref.shape
    assert osh[-1] <= osh[0] + 1e-5          # optimizing
    assert abs(osh[-1] - oref[-1]) / oref[-1] < 0.2
    # SR-D smoke: runs, right shapes, finite objective
    msr, Bsr, osr = train_lsq_family_sharded(
        mesh, key, X, B0, R0, h=h, niter=2, ilsiter=1, icmiter=1,
        npert=1, method="SR_D", chunk=256)
    assert np.isfinite(np.asarray(osr)).all()
    msc, _, osc = train_lsq_family_sharded(
        mesh, key, X, B0, R0, h=h, niter=2, ilsiter=1, icmiter=1,
        npert=1, method="SR_C", chunk=256)
    assert np.isfinite(np.asarray(osc)).all()


def test_api_train_with_mesh_matches_without(rng, mesh):
    """Facade `api.train(..., mesh=...)` (chainq): same recipe as the
    meshless path — staged OPQ init then ChainQ — so the deterministic
    outputs must agree up to fp reduction order."""
    import rayuela_tpu.api as api
    d, m, h, n = 12, 3, 8, 1000
    X = rng.standard_normal((n, d)).astype(np.float32)
    m_ref = api.train(X, method="chainq", m=m, h=h, niter=2)
    m_sh = api.train(X, method="chainq", m=m, h=h, niter=2, mesh=mesh)
    assert m_sh.codebooks.shape == m_ref.codebooks.shape
    agree = (np.asarray(m_sh.train_codes)
             == np.asarray(m_ref.train_codes)).mean()
    assert agree > 0.9, agree
    # and an LSQ-family method end-to-end through the facade
    m_lsq = api.train(X, method="lsq", m=m, h=h, niter=2, mesh=mesh,
                      ilsiter=1, icmiter=1, npert=1, chunk=256)
    assert m_lsq.codebooks.shape == (m, h, d)
    assert m_lsq.train_codes.shape == (n, m)


def test_sharded_encoding_icm_matches_budget(rng, mesh):
    """`sharded_encoding_icm`: right shapes on ragged n, and the
    encoding cost is <= the init cost (ICM only improves)."""
    from rayuela_tpu.ops.qerror import qerror
    from rayuela_tpu.parallel.lsq_sharded import sharded_encoding_icm
    d, m, h, n = 12, 3, 8, 517
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((m, h, d)).astype(np.float32) * 0.3
    B0 = rng.integers(0, h, (n, m)).astype(np.int32)
    B = sharded_encoding_icm(mesh, jax.random.PRNGKey(0), X, C, B0,
                             ilsiter=2, icmiter=2, npert=1, chunk=128)
    assert B.shape == (n, m)
    assert float(qerror(X, C, B)) <= float(qerror(X, C, B0)) + 1e-5


def test_sharded_codes_search_segments_big_shards(rng, mesh):
    """Shards far larger than one kernel split: each program walks many
    tiles (row ids are int32, no segmentation) — both sharded code
    routes against the XLA LUT oracle."""
    from rayuela_tpu.parallel import mesh as pmesh
    from rayuela_tpu.search import codes as scp
    d, m, h, n, nq, k = 16, 4, 16, 5000, 6, 15
    X, C, B = random_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    T = scp.build_luts(jnp.asarray(C), Q, pq=True, d=d)
    packed = scp.pack_codes(jnp.asarray(B))
    s_ref, _ = scp.xla_lut_scan(T, jnp.asarray(B), k)
    for interpret in (False, True):
        s_sh, _, fl = pmesh.sharded_search_codes(
            mesh, Q, jnp.asarray(C), packed, k=k, pq=True, d=d,
            interpret=interpret, tn=16, nsplit=2, r=4)
        assert not np.asarray(fl).any()
        np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_ref),
                                   rtol=1e-4, atol=1e-3)


def test_sharded_decoded_search_segments_big_shards(rng, mesh):
    """Decoded sharded search with shards far larger than one kernel
    split, and a plan shallow enough to flag: `sharded_search_exact`
    repairs flagged queries, so results stay exact."""
    from rayuela_tpu.parallel import mesh as pmesh
    n, d, nq, k = 5000, 32, 6, 15
    Xd = rng.standard_normal((n, d)).astype(np.float32)
    Xj, x2 = jnp.asarray(Xd), jnp.sum(jnp.asarray(Xd) ** 2, -1)
    Q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    d1, i1 = pmesh.sharded_search_exact(mesh, Xj, x2, Q, k=k)
    d2, i2 = pmesh.sharded_search_exact(mesh, Xj, x2, Q, k=k,
                                        interpret=True, tn=16, nsplit=1,
                                        r=1)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                               rtol=1e-4, atol=1e-3)
    D = ((np.asarray(Q)[:, None, :] - Xd[None]) ** 2).sum(-1)
    ref = np.sort(D, 1)[:, :k]
    np.testing.assert_allclose(np.asarray(d2), ref, rtol=1e-4,
                               atol=1e-3)
    picked = np.take_along_axis(D, np.asarray(i2), axis=1)
    np.testing.assert_allclose(picked, np.asarray(d2), rtol=1e-4,
                               atol=1e-3)


