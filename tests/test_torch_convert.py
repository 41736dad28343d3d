"""``convert.domain`` keeps the closed forms of the JAX package's ``test_*``
fields, so the analytic solver runs on a converted domain.

The image of ``run(solver="analytic")`` on a converted lens is held to
JAX's as tests/test_torch_analytic.py holds the port's own lens: the same
ray total, relative L1 <= 0.002 (rays that a last-place difference of the
march moves across a bin edge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.tracer import init_beam
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.fields import ScalarDomain

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
FORMS = {
    "test_null": {},
    "test_slab": {"s": 0.5, "ne_0": 2e23},
    "test_linear_cos": {"Ly": 2e-3, "s1": 0.2},
    "test_exponential_cos": {"s": 4e-3, "Ly": 2e-3},
    "test_lens": {"ne_0": 5e24, "LR": 1.5e-3},
    "test_liner": {"ne_0": 5e24, "LR": 2e-3},
}


@pytest.mark.parametrize("with_B", [False, True], ids=["ne", "ne_B"])
@pytest.mark.parametrize("field", sorted(FORMS))
def test_converted_closed_forms_equal_the_ports_own(field, with_B):
    """The forms read from the JAX closures are the ones the port's own
    test_* constructor makes (same kind, same float32 constants)."""
    jd = getattr(JDomain(2 * EXT, 9), field)(**FORMS[field])
    td = getattr(ScalarDomain(2 * EXT, 9, device="cpu"), field)(
        **FORMS[field])
    if with_B:
        jd.test_B(Bmax=3.0)
        td.test_B(Bmax=3.0)
    got = convert.domain(jd, "cpu").analytic
    assert set(got) == set(td.analytic)
    for name, form in td.analytic.items():
        assert got[name].kind == form.kind
        assert got[name].params == form.params


def test_run_analytic_on_a_converted_lens_matches_jax():
    jd = JDomain(2 * EXT, 65).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = init_beam(jax.random.PRNGKey(0), 20000, 2e-3, 0.0, EXT, "circular")
    ts0 = convert.tensor(s0, "cpu")
    td = convert.domain(jd, "cpu")
    # the fault this repairs: without the closed forms the analytic solver
    # has nothing to march (a converted domain had analytic=None)
    bare = convert.domain(jd, "cpu")
    bare.analytic = None
    with pytest.raises(ValueError, match="analytic"):
        tpipe.run(bare, ts0, solver="analytic", bins=(61, 41))
    Ht = tpipe.run(td, ts0, solver="analytic", bins=(61, 41)).numpy()
    Hj = np.asarray(jpipe.run(jd, s0, solver="analytic", bins=(61, 41)))
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= 0.002 * Hj.sum()


def test_unrecognised_closures_are_not_guessed():
    jd = JDomain(2 * EXT, 9).test_lens()
    jd.analytic = {"ne": lambda x, y, z: 1e24 * jnp.exp(-x**2 / 1e-6)}
    assert convert.domain(jd, "cpu").analytic is None
    jd = JDomain(2 * EXT, 9).test_lens()
    jd.analytic = dict(jd.analytic, Te=lambda x, y, z: 0 * x + 50.0)
    assert convert.domain(jd, "cpu").analytic is None
    assert convert.closed_form(np.sin) is None
    jd = JDomain(2 * EXT, 9)
    jd.external_ne(np.zeros((9, 9, 9), np.float32))
    assert convert.domain(jd, "cpu").analytic is None
