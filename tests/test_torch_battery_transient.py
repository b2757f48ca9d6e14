"""BatteryModel against fvm_tpu (float64, CPU): the transient cases.

The transient cases of ``tests/test_battery.py:36-250``, run by both
packages from the same inputs with ``test_torch_battery.py``'s helpers and
tolerances (its docstring gives them and why the later outer residuals
are not compared), with the JAX test's own checks on the port's results:

* the 1D sandwich cell (quad_2d(30, 2), dt 5): the species transport over
  3 x 6 outers, both packages' potentials and concentrations to 1e-8;
* the double-shell cell (quad_2d(16, 4), I = 5, dt 20): one coupled BDF1
  step, the electrode's and the electrolyte's Li balances against dt I / F
  and dt (1 - t+) I / F (1e-8);
* the tangent and the adjoint of the mean electrode potential after that
  step: the adjoint to fvm_tpu's and the port's duality to 1e-8.
"""

import numpy as np
import pytest

from fvm_tpu_torch.models import FARADAY
from test_torch_battery import (check_tangent_adjoint, same_run, sandwich,
                                shell)
from test_torch_newton import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def transient_shell():
    """Both packages' transient double-shell cell and its initial
    concentration, one BDF1 step advanced together."""
    (jb, _), (tb, xc2) = shell(transient=True)
    c0 = tb.getConcentration()
    return jb, tb, xc2, c0, same_run(jb, tb, 25)


def test_sandwich_transient_species_transport():
    jm, tm = sandwich(transient=True)
    c0 = tm.getConcentration().copy()
    for _ in range(3):
        same_run(jm, tm, 6)
        jm.updateTime()
        tm.updateTime()
    c1 = tm.getConcentration()
    assert np.abs(c1 - c0).max() > 1e-6
    assert abs(c1[0] - c0[0]) < np.abs(c1 - c0).max()


def test_double_shell_coupled_mass(transient_shell):
    I, dt = 5.0, 20.0
    jb, tb, xc2, c0, hist = transient_shell
    assert hist[-1][1] / hist[0][1] < 1e-10
    c1 = tb.getConcentration()
    left, vol = xc2 < 1.0, 2.0 / 64.0
    dcs = (c1[~left] - c0[~left]).sum() * vol
    dce = (c1[left] - c0[left]).sum() * vol
    assert dcs == pytest.approx(-dt * I / FARADAY, rel=1e-8)
    assert dce == pytest.approx(dt * (1.0 - 0.363) * I / FARADAY, rel=1e-8)


def test_tangent_adjoint_and_duality(transient_shell):
    check_tangent_adjoint(*transient_shell[:3], transient=True)
