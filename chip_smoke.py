"""End-to-end smoke run of the main path on one GPU: train → encode →
index → search at the SIFT1M protocol width, plus each translated
kernel against its plain reference.

    python chip_smoke.py [--seed 0]
    python chip_smoke.py --cards 4      # the multi-card path only

Phases (each prints one line: wall time, cold-compile time, card):

1. ``main`` — `make_synthetic` at d=128, ntrain=1e5, nbase=1e6,
   nquery=1e4 with exact ground truth; ``api.train(method="sr_d", m=8,
   h=256)``; ``api.index_base`` in codes and decoded mode;
   ``api.search`` at k=100 and k=1000; ``api.search_streamed`` over the
   packed codes in host memory, in two shards. Checks: the training
   objective falls; recall@1/10/100 printed; on 256 queries, distances
   and ids agree with the f32 HIGHEST-precision XLA oracle on the same
   card (tolerance below).
2. ``kernels`` — the scan kernel against its oracle at m in {8, 16},
   k in {100, 1000}, decoded and code-resident; the ICM running-sum
   form against the table form; Viterbi on the GPU against the same
   function on the CPU; the HIGHEST-precision sums against float64.
3. ``--cards 4`` — only SR-D training through ``api.train(mesh=)`` and
   ``api.search(mesh=)`` in both index modes, each against the
   single-card result.

Tolerance of a scan against the oracle: the kernel multiplies bf16
operands (the query and the decoded row each rounded to 8 significant
bits, unit roundoff 2**-8) with f32 accumulation, so each product is
within 2**-7 relative and each score ``x2 - 2 q.x`` within
``2**-6 * |q| * |x|`` of the f32 score; ids may differ only where the
oracle scores of the two ids are within twice that (ties at bf16
resolution).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``. Exits
nonzero, with no such line, unless JAX's backend is the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

D, NTRAIN, NBASE, NQUERY, M, H = 128, 100_000, 1_000_000, 10_000, 8, 256
NITER = 3
NCHECK = 256


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Phase:
    """Times one phase: wall clock and the backend-compile seconds JAX
    reports while it runs."""
    compile_s = 0.0

    def __init__(self, name: str, card_name: str):
        self.name, self.card = name, card_name

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), Phase.compile_s
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.name}: wall {time.perf_counter() - self.t0:.1f} s,"
                  f" cold compile {Phase.compile_s - self.c0:.1f} s,"
                  f" card {self.card}", flush=True)


def _on_event(event: str, secs: float, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        Phase.compile_s += secs


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def oracle_scores(Q, Xd32, x2, ids):
    """f32 HIGHEST oracle score of the given ids: |q|^2 - 2 q.x + x2."""
    import jax.numpy as jnp
    from jax import lax
    X = jnp.take(Xd32, ids, axis=0)                       # (nq, k, d)
    qx = jnp.einsum("qd,qkd->qk", Q, X, precision=lax.Precision.HIGHEST)
    return (jnp.sum(Q * Q, axis=1, keepdims=True) - 2.0 * qx
            + jnp.take(x2, ids))


def compare(label, Q, s, i, Xd32, x2, k):
    """Kernel result (s, i) against the exact f32 oracle over
    (Xd32, x2) for the queries Q (module docstring tolerance)."""
    import jax.numpy as jnp

    from rayuela_tpu.search.linscan import exact_rescan

    s_o, i_o = exact_rescan(Q, Xd32, x2, k)
    xmax = float(jnp.sqrt(jnp.max(jnp.sum(Xd32 * Xd32, axis=1))))
    tol = 2.0 ** -6 * np.linalg.norm(np.asarray(Q), axis=1)[:, None] * xmax
    s, i, s_o = np.asarray(s), np.asarray(i), np.asarray(s_o)
    check(s.shape == (Q.shape[0], k) and np.isfinite(s).all(),
          f"{label}: shape/finite")
    err = np.abs(s - s_o)
    check((err <= tol).all(), f"{label}: distance error {err.max():.4g} "
          f"above tolerance {tol.min():.4g}")
    s_mine = np.asarray(oracle_scores(Q, Xd32, x2, jnp.asarray(i)))
    differ = i != np.asarray(i_o)
    check((np.abs(s_mine - s_o)[differ] <= 2 * np.broadcast_to(
        tol, s.shape)[differ]).all(), f"{label}: an id differs beyond a tie")
    print(f"  {label}: max |d - oracle| {err.max():.4g} (tol >= "
          f"{tol.min():.4g}), ids equal {1 - differ.mean():.4f}, "
          "rest ties", flush=True)


def main_path(seed: int, cardname: str):
    import jax
    import jax.numpy as jnp

    from rayuela_tpu import api
    from rayuela_tpu.experiments.datasets import make_synthetic
    from rayuela_tpu.ops.qerror import reconstruct
    from rayuela_tpu.search.codes import pack_codes
    from rayuela_tpu.search.linscan import eval_recall

    with Phase("data", cardname):
        ds = make_synthetic(d=D, ntrain=NTRAIN, nbase=NBASE,
                            nquery=NQUERY, seed=seed)
        Q = jnp.asarray(ds.Xq)
    with Phase("train", cardname):
        model = api.train(ds.Xt, method="sr_d", m=M, h=H, niter=NITER,
                          key=jax.random.PRNGKey(seed))
        err = np.asarray(model.extras["train_error"])
        print(f"  train qerror {err.tolist()}", flush=True)
        check(np.isfinite(err).all() and err[-1] < err[0],
              "training qerror did not fall")
    for mode in ("codes", "decoded"):
        with Phase(f"index_{mode}", cardname):
            idx = api.index_base(model, ds.Xb, mode=mode,
                                 key=jax.random.PRNGKey(seed + 1))
            jax.block_until_ready(idx.codes)
        Xd32 = reconstruct(model.codebooks, idx.codes)
        x2 = jnp.take(idx.norms_codebook, idx.norm_codes)
        for k in (100, 1000):
            with Phase(f"search_{mode}_k{k}", cardname):
                s, i = api.search(idx, Q, k=k)
                jax.block_until_ready((s, i))
            i_np = np.asarray(i)
            check(((i_np >= 0) & (i_np < NBASE)).all(), "ids in range")
            check(bool(jnp.all(jnp.diff(s, axis=1) >= 0)), "sorted")
            rec = eval_recall(i, ds.gt, ks=(1, 10, 100), verbose=False)
            print(f"  {mode} k={k}: recall@1/10/100 = "
                  f"{rec[0]:.4f} {rec[9]:.4f} {rec[99]:.4f}", flush=True)
            compare(f"{mode} k={k}", Q[:NCHECK], s[:NCHECK], i[:NCHECK],
                    Xd32, x2, k)
        if mode == "codes":
            host = np.asarray(pack_codes(idx.codes, idx.norm_codes))
            with Phase("search_streamed_k100", cardname):
                s2, i2 = api.search_streamed(
                    model, host, Q, k=100,
                    norms_cbook=idx.norms_codebook, mprime=M + 1,
                    shard_n=NBASE // 2)
                jax.block_until_ready((s2, i2))
            compare("streamed k=100", Q[:NCHECK], s2[:NCHECK],
                    i2[:NCHECK], Xd32, x2, 100)
        del idx, Xd32
    return ds, model


def kernels(seed: int, ds, model, cardname: str):
    import jax
    import jax.numpy as jnp

    from rayuela_tpu.ops.icm import encoding_icm
    from rayuela_tpu.ops.kmeans import update_centers
    from rayuela_tpu.ops.qerror import reconstruct_pq, veccost
    from rayuela_tpu.ops.viterbi import chain_binaries, chain_unaries, \
        viterbi_encode
    from rayuela_tpu.search import codes, linscan

    rng = np.random.default_rng(seed)
    Q = jnp.asarray(ds.Xq[:NCHECK])
    with Phase("kernel_scan", cardname):
        for m in (8, 16):
            C = jnp.asarray(rng.standard_normal((m, H, D // m))
                            .astype(np.float32))
            B = jnp.asarray(rng.integers(0, H, (NBASE, m)), jnp.int32)
            Xd32 = reconstruct_pq(C, B, D)
            x2 = jnp.sum(Xd32 * Xd32, axis=1)
            cidx = codes.build_codes_index(C, B, pq=True, d=D)
            didx = linscan.build_index(C, B, pq=True, d=D)
            for k in (100, 1000):
                s, i = codes.search_codes(cidx, Q, k)
                compare(f"codes m={m} k={k}", Q, s, i, Xd32, x2, k)
                s, i = linscan.search(didx, Q, k)
                compare(f"decoded m={m} k={k}", Q, s, i, Xd32, x2, k)
            del cidx, didx, Xd32
    with Phase("kernel_icm", cardname):
        X = jnp.asarray(ds.Xb[:100_000])
        C = model.codebooks
        from rayuela_tpu.models.rvq import quantize_rvq
        B0, _ = quantize_rvq(C, X)
        key = jax.random.PRNGKey(seed)
        e = {f: float(jnp.mean(veccost(X, C, encoding_icm(
            key, X, C, B0, ilsiter=8, icmiter=4, form=f))))
            for f in ("running", "table")}
        e0 = float(jnp.mean(veccost(X, C, B0)))
        rel = abs(e["running"] - e["table"]) / e["table"]
        print(f"  icm mean energy: init {e0:.4f}, running "
              f"{e['running']:.4f}, table {e['table']:.4f} "
              f"(rel diff {rel:.2e}, tol 1e-2)", flush=True)
        # both forms descend the same energy with the same schedule;
        # bf16 conditioning can pick different moves, so 1% apart
        check(rel <= 1e-2 and e["running"] < e0, "ICM forms disagree")
    with Phase("kernel_viterbi", cardname):
        X = np.asarray(ds.Xb[:4096])
        C = np.asarray(model.codebooks)
        Bg = np.asarray(viterbi_encode(jnp.asarray(X), jnp.asarray(C)))
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            Bc = np.asarray(viterbi_encode(jax.device_put(X, cpu),
                                           jax.device_put(C, cpu)))
        u = np.asarray(chain_unaries(jnp.asarray(X), jnp.asarray(C)),
                       np.float64)
        bn = np.asarray(chain_binaries(jnp.asarray(C)), np.float64)

        def energy(B):
            e = sum(u[j, np.arange(len(B)), B[:, j]] for j in range(M))
            return e + sum(bn[j, B[:, j], B[:, j + 1]]
                           for j in range(M - 1))

        diff = (Bg != Bc).any(axis=1)
        eg, ec = energy(Bg), energy(Bc)
        check(np.allclose(eg[diff], ec[diff], rtol=1e-5, atol=1e-3),
              "Viterbi codes differ beyond ties")
        print(f"  viterbi gpu vs cpu: {diff.mean():.4f} of vectors "
              "differ, all at equal chain energy", flush=True)
    with Phase("precision", cardname):
        X = ds.Xt[:50_000].astype(np.float64)
        a = rng.integers(0, H, X.shape[0])
        got = np.asarray(update_centers(jnp.asarray(ds.Xt[:50_000]),
                                        jnp.asarray(a), H,
                                        jnp.zeros((H, D)), repick=False))
        want = np.zeros((H, D))
        np.add.at(want, a, X)
        cnt = np.bincount(a, minlength=H)[:, None]
        want = want / np.maximum(cnt, 1)
        rel = np.abs(got - want).max() / np.abs(want).max()
        print(f"  kmeans center sums vs float64: rel err {rel:.2e} "
              "(HIGHEST; a TF32 pass gives ~1e-3)", flush=True)
        check(rel < 1e-5, "center sums not at f32 precision")


def multicard(seed: int, cardname: str):
    import jax
    import jax.numpy as jnp

    from rayuela_tpu import api
    from rayuela_tpu.experiments.datasets import make_synthetic
    from rayuela_tpu.ops.qerror import reconstruct
    from rayuela_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4, 1)
    with Phase("data", cardname):
        ds = make_synthetic(d=D, ntrain=NTRAIN, nbase=NBASE,
                            nquery=NQUERY, seed=seed)
        Q = jnp.asarray(ds.Xq)
    with Phase("train_single", cardname):
        m1 = api.train(ds.Xt, method="sr_d", m=M, h=H, niter=NITER,
                       key=jax.random.PRNGKey(seed))
    with Phase("train_mesh4", cardname):
        m4 = api.train(ds.Xt, method="sr_d", m=M, h=H, niter=NITER,
                       key=jax.random.PRNGKey(seed), mesh=mesh)
    e1 = float(np.asarray(m1.extras["train_error"])[-1])
    e4 = float(np.asarray(m4.extras["train_error"])[-1])
    print(f"  final train qerror: single {e1:.4f}, mesh4 {e4:.4f}",
          flush=True)
    # ICM keys fold the shard index, so trajectories differ; the
    # objective reached must not
    check(abs(e4 - e1) / e1 < 0.05, "sharded training diverges")
    for mode in ("codes", "decoded"):
        idx = api.index_base(m1, ds.Xb, mode=mode,
                             key=jax.random.PRNGKey(seed + 1))
        Xd32 = reconstruct(m1.codebooks, idx.codes)
        x2 = jnp.take(idx.norms_codebook, idx.norm_codes)
        for k in (100, 1000):
            with Phase(f"search_{mode}_k{k}_mesh4", cardname):
                s4, i4 = api.search(idx, Q, k=k, mesh=mesh)
                jax.block_until_ready((s4, i4))
            s1, i1 = api.search(idx, Q, k=k)
            compare(f"mesh4 {mode} k={k}", Q[:NCHECK], s4[:NCHECK],
                    i4[:NCHECK], Xd32, x2, k)
            same = float(np.mean(np.asarray(i4) == np.asarray(i1)))
            dmax = float(jnp.max(jnp.abs(s4 - s1)))
            print(f"  mesh4 vs single {mode} k={k}: ids equal {same:.4f},"
                  f" max |d4 - d1| {dmax:.4g}", flush=True)
        del idx, Xd32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    a = ap.parse_args(argv)

    import jax

    from rayuela_tpu import platform
    from rayuela_tpu.utils import enable_compile_cache

    if platform.backend() != "gpu":
        print("chip_smoke.py needs a GPU; JAX's backend is "
              f"{platform.backend()!r}", file=sys.stderr)
        return 2
    if len(jax.devices()) < a.cards:
        print(f"--cards {a.cards}: only {len(jax.devices())} visible",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    cardname = card()
    print(f"card: {cardname}", flush=True)
    if a.cards == 4:
        multicard(a.seed, cardname)
    else:
        ds, model = main_path(a.seed, cardname)
        kernels(a.seed, ds, model, cardname)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
