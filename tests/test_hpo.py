"""HPO module tests (search space + optimizer protocol; the expensive
default_objective is exercised by the experiments suite's methods)."""

import numpy as np
import pytest

from rayuela_tpu.experiments.hpo import (INCUMBENTS, LSQConfig, incumbent,
                                         optimize, sample_config)


def test_sample_config_in_space():
    rng = np.random.default_rng(0)
    for _ in range(100):
        c = sample_config(rng, m=7)
        assert 1 <= c.ilsiter <= 16
        assert 0 <= c.npert <= 6
        assert c.method in ("LSQ", "SR_C", "SR_D")
        assert c.schedule in (1, 2, 3)
        assert 0.1 <= c.p <= 1.0
        assert c.icmiter == max(1, 32 // c.ilsiter)


def test_optimize_finds_planted_optimum():
    """Objective minimized at ilsiter=12, p≈0.3 — optimizer must get
    close within budget."""
    def objective(c: LSQConfig) -> float:
        return abs(c.ilsiter - 12) / 16 + abs(c.p - 0.3)

    best, loss, hist = optimize(objective, m=7, budget=40, seed=1,
                                verbose=False)
    assert len(hist) == 40
    assert loss < 0.25
    assert abs(best.ilsiter - 12) <= 3


def test_optimize_smac_beats_random_on_smooth_objective():
    """The GP-surrogate strategy must exploit structure: on a smooth
    planted objective it should match or beat random search at equal
    budget (averaged over seeds to dodge luck)."""
    def objective(c: LSQConfig) -> float:
        return (abs(c.ilsiter - 12) / 16 + abs(c.p - 0.3)
                + 0.2 * (c.method != "SR_D"))

    smac_losses, rand_losses = [], []
    for seed in range(3):
        _, l_s, h = optimize(objective, m=7, budget=25, seed=seed,
                             verbose=False, strategy="smac")
        assert len(h) == 25
        _, l_r, _ = optimize(objective, m=7, budget=25, seed=seed,
                             verbose=False, strategy="random")
        smac_losses.append(l_s)
        rand_losses.append(l_r)
    assert np.mean(smac_losses) <= np.mean(rand_losses) + 0.02
    assert np.mean(smac_losses) < 0.15


def test_gp_surrogate_interpolates():
    from rayuela_tpu.experiments.hpo import GPSurrogate
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(30, 4))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    gp = GPSurrogate(noise=1e-6).fit(X, y)
    mean, std = gp.predict(X)
    assert np.allclose(mean, y, atol=1e-2)
    assert (std < 0.05).all()
    # far-away points revert toward the prior with high uncertainty
    _, std_far = gp.predict(np.full((1, 4), 10.0))
    assert std_far[0] > 0.9


def test_incumbents_quote_reference_verbatim():
    """Pin INCUMBENTS to the call rows at `smac/test_lsq.jl:208-226`,
    read against the positional signature (dataset, m, h, niter,
    sr_method, ilsiter, icmiter, randord, npert, schedule, p)
    (`smac/test_lsq.jl:90-101,149-160`)."""
    rows = {
        # dataset, m: (method, ilsiter, icmiter, randord, npert, sched, p)
        ("labelme", 8): ("SR_D", 9, 3, True, 1, 1, 0.43098784299895454),
        ("labelme", 16): ("SR_D", 8, 4, True, 4, 1, 0.5),
        ("mnist", 8): ("SR_D", 9, 3, False, 5, 1, 0.18979255389609623),
        ("mnist", 16): ("SR_D", 8, 4, False, 4, 1, 0.8282107865533627),
        ("sift1m", 8): ("SR_D", 8, 4, True, 4, 1, 0.6458745069743886),
        ("sift1m", 16): ("SR_D", 7, 4, True, 2, 1, 0.18722222602931293),
        ("deep1m", 8): ("SR_D", 8, 4, True, 4, 1, 0.5),
        ("deep1m", 16): ("SR_C", 15, 2, True, 2, 1, 0.9534092523209057),
        ("convnet1m", 8): ("SR_C", 8, 4, True, 4, 1, 0.7134116312190524),
        ("convnet1m", 16): ("SR_C", 10, 3, False, 5, 1, 0.937363908221641),
    }
    assert set(INCUMBENTS) == set(rows)
    for key, (meth, ils, icm, ro, npert, sched, p) in rows.items():
        c = INCUMBENTS[key]
        assert (c.method, c.ilsiter, c.icmiter, c.randord, c.npert,
                c.schedule) == (meth, ils, icm, ro, npert, sched), key
        assert c.p == p, key


def test_incumbent_lookup_aliases():
    assert incumbent("LabelMe22K", 8) is INCUMBENTS[("labelme", 8)]
    assert incumbent("SIFT1M", 16) is INCUMBENTS[("sift1m", 16)]
    assert incumbent("unknown-dataset") == LSQConfig()
    # explicit icmiter overrides the 32//ilsiter coupling
    assert INCUMBENTS[("deep1m", 16)].icmiter == 2
    assert LSQConfig(ilsiter=8).icmiter == 4


@pytest.mark.parametrize("outcome", ["ok", "crash"])
def test_objective_scores_run_or_crash(monkeypatch, outcome):
    """The objective is 1 - recall@1 of the run; a crashed config
    scores the worst loss, 1.0, and is called exactly once (no
    retries)."""
    import numpy as np

    from rayuela_tpu.experiments import drivers
    from rayuela_tpu.experiments.hpo import LSQConfig, default_objective

    calls = {"n": 0}

    def run(*a, **k):
        calls["n"] += 1
        if outcome == "crash":
            raise RuntimeError("INTERNAL: compile failed")
        return {"recall": np.array([0.7])}

    monkeypatch.setattr(drivers, "experiment_sr", run)
    obj = default_objective(object(), 4, 16, 2)
    want = 0.3 if outcome == "ok" else 1.0
    assert abs(obj(LSQConfig()) - want) < 1e-6
    assert calls["n"] == 1
