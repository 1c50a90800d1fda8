"""The yardstick of the fp32 train-step checks against JAX.

Each check compares the port's one-step (or few-step) update of every
parameter, new minus old, with JAX's on the same inputs:
``gap[name] = |update_port - update_jax| / |update_jax|``.  How large that
gap may be depends on how ill-conditioned the step is at init, and so on
each CPU's rounding: a fixed limit that holds on one host fails on the
next.  So each test measures its own yardstick on the same host, in the
same run:

``ulp[name]`` is the gap between the port's update and the port's update
from weights each multiplied by ``1 + 1.2e-7 N(0, 1)`` (about one fp32
ulp), the largest over three seeded draws: how far one ulp of noise in
the inputs moves this step on this CPU.  One draw alone is not enough:
now and then a draw flips something discrete in the step and moves the
update about 100 times further than another draw does (SPM geometric:
one of four seeds read a median 100 times below the others').  The JAX gap
must stay within a factor of the yardstick:

    median(gap) <= K_MEDIAN * median(ulp)   and   max(gap) <= K_MAX * max(ulp)

Measured on one x86 CPU host (8 cores), against flax's ``nn.BatchNorm`` as
it is except for the classifier, which runs flax's two-pass variance
(flax's default one-pass variance E[x^2] - E[x]^2, summed by XLA:CPU in a
running fp32 sum, is nearly all of the classifier's gap:
``test_one_pass_variance_is_the_classifier_gap`` in
tests/test_torch_port_classifier.py):

    test                                  gap median, max   ratio median, max
    classifier (two-pass BN)              1.77e-3  3.46e-3      29.6   4.04
    classifier (flax's default BN)        2.19e-2  2.51e-2       366   29.3
    SBP                                   9.52e-3  1.13e-2      2.98   2.29
    PIS (K=11)                            1.04e-2  1.54e-2      0.93   1.07
    SBP, 2 ranks vs JAX's 2-device mesh   8.0e-3   1.05e-2      2.41   2.46
    SPM, photometric                      4.32e-2  5.22e-2      0.78   0.81
    SPM, geometric                        1.20e-2  1.35e-2      1.89   1.79

``K_MEDIAN = 60`` and ``K_MAX = 10`` leave 2 and 2.5 times the largest
ratio that passes.  The classifier's median ratio stands out: most of its parameters
are well conditioned (yardstick about 6e-5) while XLA's sums put JAX about
2e-3 from the port.  A wrong step moves further: of the mutation cases of
``test_torch_port_classifier.py::test_update_check_flags_a_wrong_step``,
nesterov off reads 7.9e3 / 553, one channel of the dropout mask flipped
896 / 73.7, weight decay 5e-4 -> 5.5e-4 31.9 / 14.1 (the old fixed 2e-2
did not flag it), and one BN's momentum changed trips the running
statistics' bound.  Run with ``pytest -s`` to print each reading.

The BN running statistics keep their fixed limit, 1e-4 of the largest
value per buffer (they do not go through the ill-conditioned backward).
"""

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

NOISE = 1.2e-7
NOISE_SEEDS = (5, 6, 7)
K_MEDIAN = 60.0
K_MAX = 10.0
STATS_BOUND = 1e-4


def update_gaps(got: dict, want: dict, names: Iterable[str],
                start: dict, want_start: Optional[dict] = None) -> np.ndarray:
    """Per name, |(got - start) - (want - want_start)| / |want -
    want_start|; a name missing from a start dict (a momentum trace) starts
    at 0."""
    want_start = start if want_start is None else want_start
    out = []
    for n in names:
        a = got[n].double() - _get(start, n)
        b = want[n].double() - _get(want_start, n)
        out.append(float((a - b).norm() / b.norm()))
    return np.asarray(out)


def _get(sd: dict, name: str):
    return sd[name].double() if name in sd else 0.0


def perturbed(state: dict, names: Iterable[str], seed: int) -> dict:
    """A copy of ``state`` with each of ``names`` that it holds multiplied
    by ``1 + NOISE N(0, 1)`` from a generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    out = {k: v.clone() for k, v in state.items()}
    for n in (n for n in names if n in out):
        noise = torch.randn(out[n].shape, generator=gen, dtype=torch.float64)
        out[n] = (out[n].double() * (1 + NOISE * noise)).to(out[n].dtype)
    return out


def ulp_gaps(step_from: Callable[[dict], dict], start: dict, new: dict,
             names: List[str]) -> np.ndarray:
    """The yardstick: ``step_from(state) -> the state after the port's
    step`` run from ``start`` perturbed by one ulp, against ``new``, the
    same step's result from ``start``; per name the largest over the
    ``NOISE_SEEDS`` draws."""
    out = []
    for seed in NOISE_SEEDS:
        noisy = perturbed(start, names, seed)
        out.append(update_gaps(step_from(noisy), new, names, noisy, start))
    return np.max(out, axis=0)


def stats_gaps(got: dict, want: dict) -> Dict[str, float]:
    """Per BN running statistic, the largest difference over the largest
    value."""
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
            for k in want if k.endswith(("running_mean", "running_var"))}


def update_failures(got: dict, want: dict, start: dict, ulp: np.ndarray,
                    names: List[str], bound: Optional[float] = None,
                    label: str = "") -> List[str]:
    """What the check flags (empty if it passes): the JAX gap's median or
    largest past ``K_MEDIAN`` / ``K_MAX`` times the yardstick's, a
    parameter past the fixed ``bound`` where one is given, a BN running
    statistic past ``STATS_BOUND``.  Prints the readings (``pytest -s``)."""
    gaps = update_gaps(got, want, names, start)
    med, top = float(np.median(gaps)), float(gaps.max())
    ulp_med, ulp_top = float(np.median(ulp)), float(ulp.max())
    print(f"{label}: update gap to JAX median {med:.3g}, max {top:.3g} "
          f"({names[int(gaps.argmax())]}); one-ulp yardstick median "
          f"{ulp_med:.3g}, max {ulp_top:.3g}; ratios {med / ulp_med:.3g}, "
          f"{top / ulp_top:.3g}")
    failures = []
    if med > K_MEDIAN * ulp_med:
        failures.append(f"median gap {med:.3g} > {K_MEDIAN} x {ulp_med:.3g}")
    if top > K_MAX * ulp_top:
        failures.append(f"max gap {top:.3g} > {K_MAX} x {ulp_top:.3g}")
    if bound is not None:
        failures += [f"{n} gap {g:.3g} > {bound}"
                     for n, g in zip(names, gaps) if g > bound]
    failures += [f"{k} gap {g:.3g} > {STATS_BOUND}"
                 for k, g in stats_gaps(got, want).items() if g > STATS_BOUND]
    return failures


def assert_update_close(got: dict, want: dict, start: dict, ulp: np.ndarray,
                        names: List[str], bound: Optional[float] = None,
                        label: str = "") -> None:
    failures = update_failures(got, want, start, ulp, names, bound, label)
    assert not failures, failures
