"""The port's learning-rate schedulers (``paddle_tpu_torch.optimizer.lr``)
held against the JAX package's (``paddle_tpu.optimizer.lr``) on the CPU.

Each of the fifteen schedulers, built with the same arguments on both
sides, gives the same ``lr`` (``scheduler()`` and ``last_lr``) and
``last_epoch`` at construction and after each of 30 ``step()`` calls:
exactly, since both compute the same host float arithmetic.
``ReduceOnPlateau`` is stepped with the same metric sequence (plateaus
and improvements from a seeded numpy draw).  A ``state_dict`` taken from
either side restores the other."""
import numpy as np
import pytest

import paddle_tpu as pt

from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30


def _polynomial(mod):
    return mod.PolynomialDecay(0.1, 10, end_lr=0.001, power=2.0)


# name -> how to build it from either module
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 8, learning_rate=2.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 0.9),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 0.5),
    "PolynomialDecay": _polynomial,
    "PolynomialDecay cycle": lambda m: m.PolynomialDecay(
        0.1, 7, end_lr=0.0, power=1.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-4, 20, end_lr=0.0, power=1.0), 5, 0.0, 1e-4),
    "LinearWarmup float": lambda m: m.LinearWarmup(0.05, 4, 0.01, 0.05),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 0.2),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, 12,
                                                             eta_min=0.001),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [3, 9, 17], gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, 4, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=0.001),
    "ReduceOnPlateau max abs": lambda m: m.ReduceOnPlateau(
        0.1, mode="max", factor=0.3, patience=1, threshold=0.01,
        threshold_mode="abs"),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 25),
    "OneCycleLR linear": lambda m: m.OneCycleLR(0.1, 25,
                                               anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.001, 0.1, 4),
    "CyclicLR triangular2": lambda m: m.CyclicLR(0.001, 0.1, 3, 5,
                                                 mode="triangular2"),
    "CyclicLR exp_range": lambda m: m.CyclicLR(0.001, 0.1, 4,
                                               mode="exp_range",
                                               exp_gamma=0.9),
}


def _metrics():
    """A loss that improves, plateaus and improves again."""
    rng = np.random.RandomState(0)
    base = np.repeat([1.0, 0.8, 0.8, 0.5, 0.5, 0.5], 5)
    return base + 1e-6 * rng.rand(STEPS)


def _trace(sched, plateau):
    out = [(sched(), sched.last_lr, sched.last_epoch)]
    for i in range(STEPS):
        if plateau:
            sched.step(float(_metrics()[i]))
        else:
            sched.step()
        out.append((sched(), sched.last_lr, sched.last_epoch))
    return out


def test_every_reference_scheduler_is_ported():
    names = {n for n in pt.optimizer.lr.__all__ if n != "LRScheduler"}
    assert names == set(tlr.__all__) - {"LRScheduler"}
    assert len(names) == 14
    assert names == {n.split()[0] for n in SCHEDULERS}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_over_30_steps(name):
    plateau = name.startswith("ReduceOnPlateau")
    want = _trace(SCHEDULERS[name](pt.optimizer.lr), plateau)
    got = _trace(SCHEDULERS[name](tlr), plateau)
    assert got == want
    assert isinstance(got[-1][0], float)


def test_explicit_epoch_and_base_scheduler():
    for mod in (pt.optimizer.lr, tlr):
        with pytest.raises(NotImplementedError):
            mod.LRScheduler(0.1)
    j, t = _polynomial(pt.optimizer.lr), _polynomial(tlr)
    for epoch in (7, 3, 15):
        j.step(epoch)
        t.step(epoch)
        assert (t(), t.last_epoch) == (j(), j.last_epoch) and t.last_epoch == epoch


@pytest.mark.parametrize("source", ["port", "jax"])
def test_state_dict_round_trip(source):
    """Five steps on one side; its ``state_dict`` loaded into a fresh
    scheduler of the other (and of the same) package continues with the
    same rates."""
    build = SCHEDULERS["LinearWarmup"]
    mods = {"port": tlr, "jax": pt.optimizer.lr}
    a = build(mods[source])
    for _ in range(5):
        a.step()
    sd = a.state_dict()
    assert sd == {"last_epoch": 5, "last_lr": a()}
    for mod in (tlr, pt.optimizer.lr):
        b = build(mod)
        b.set_state_dict(sd)
        assert (b(), b.last_epoch) == (a(), 5)
        b.step()
        ref = build(mod)
        for _ in range(6):
            ref.step()
        assert b() == ref()
