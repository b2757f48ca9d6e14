"""``jfnk_adjoint`` and the ``differentiable`` thermal step against
fvm_tpu (float64, CPU).

The thermal slab of ``tests/test_sensitivity.py:382-411`` (24 x 8, graded
conductivity, left 400 K, right heat flux 10), converged in both packages
from the same numpy inputs:

* ``jfnk_adjoint`` through a thermal residual binding (the residual of
  ``_linearize`` as a function of T, its matrix the surrogate), with a
  Jacobi(3)-preconditioned BiCGStab (the operator is matrix-free), for the
  conductivity field and the right wall's heat flux, and through a
  property closure (``chain``): to 1e-8 of the largest entry, and against
  the implicit-solve adjoint to 1e-7;
* the ``differentiable`` option: the advance, and ``torch.func.jvp`` of one
  step with respect to the conductivity against ``jax.jvp`` of fvm_tpu's
  jitted step, to 1e-8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from fvm_tpu.linear import BiCGStab as JBiCGStab, JacobiSolver as JJacobi
from fvm_tpu.models import ThermalModel as JThermal
from fvm_tpu.models.sensitivity import jfnk_adjoint as jjfnk
from fvm_tpu_torch.linear import BiCGStab as TBiCGStab
from fvm_tpu_torch.linear import JacobiSolver as TJacobi
from fvm_tpu_torch.models import ThermalModel as TThermal, jfnk_adjoint
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close, meshes, thermal


def _thermal_system(model):
    def system(mesh, params, state, bcvals, w):
        return model._linearize(mesh, params, dict(state, T=w), bcvals)
    return system


def test_jfnk_adjoint_thermal_binding_matches():
    """``jfnk_adjoint`` through a thermal residual binding, with a
    Jacobi(3)-preconditioned BiCGStab (its operator is matrix-free), and
    the BC gradient of the heat flux."""
    jdm, tdm = meshes(24, 8)
    n = tdm.n_interior_cells
    jt, tt = thermal(JThermal, jdm, n), thermal(TThermal, tdm, n)
    jt.options["linearSolver"] = JBiCGStab(
        preconditioner=JJacobi(sweeps=3), relative_tolerance=1e-12,
        max_iterations=400)
    tt.options["linearSolver"] = TBiCGStab(
        preconditioner=TJacobi(sweeps=3), relative_tolerance=1e-12,
        max_iterations=400)
    keys, bkeys = ["k_cell"], ["right:specifiedHeatFlux"]
    gj = jjfnk(jt, "T", _thermal_system(jt), lambda T: jnp.mean(T * T),
               keys, bkeys)
    gt = jfnk_adjoint(tt, "T", _thermal_system(tt), lambda T: (T * T).mean(),
                      keys, bkeys)
    for k in keys + bkeys:
        close(gt[k], gj[k])
    # the same gradient as the implicit-solve adjoint
    close(gt["k_cell"], tt.solve_adjoint(lambda T: (T * T).mean(),
                                         keys)["k_cell"], rtol=1e-7)


def test_jfnk_adjoint_chain_rules_a_property_closure():
    """``chain``: k_cell = exp(s) from a design variable s, chain-ruled."""
    jdm, tdm = meshes(24, 8)
    n = tdm.n_interior_cells
    jt, tt = thermal(JThermal, jdm, n), thermal(TThermal, tdm, n)
    for m, bic, jac in ((jt, JBiCGStab, JJacobi), (tt, TBiCGStab, TJacobi)):
        m.options["linearSolver"] = bic(preconditioner=jac(sweeps=3),
                                        relative_tolerance=1e-12,
                                        max_iterations=400)
    with np.errstate(divide="ignore"):  # the padding cell's k is 0
        s0 = np.log(np.asarray(jt.params["k_cell"]))
    gj = jjfnk(jt, "T", _thermal_system(jt), lambda T: jnp.mean(T), ["s"],
               [], chain=({"s": jnp.asarray(s0)},
                          lambda ins: {"k_cell": jnp.exp(ins["s"])}))
    gt = jfnk_adjoint(tt, "T", _thermal_system(tt), lambda T: T.mean(), ["s"],
                      [], chain=({"s": torch.as_tensor(s0)},
                                 lambda ins: {"k_cell": torch.exp(ins["s"])}))
    close(gt["s"], gj["s"])


def test_differentiable_thermal_step_matches_jax_jvp():
    """With ``differentiable`` the step solves implicitly: its jvp with
    respect to the conductivity, and the advance itself, equal fvm_tpu's
    (``jax.jvp`` of its jitted step)."""
    jdm, tdm = meshes(24, 8)
    n = tdm.n_interior_cells

    def build(cls, dm):
        t = cls(dm)
        t.options["differentiable"] = True
        return t

    jt = thermal(lambda dm: build(JThermal, dm), jdm, n)
    tt = thermal(lambda dm: build(TThermal, dm), tdm, n)
    close(tt.getTemperature(), jt.getTemperature())
    dk = np.random.default_rng(4).standard_normal(jt.params["k_cell"].shape)
    jb, tb = jt._resolve_bcvals(), tt._resolve_bcvals()

    def jstep(k):
        return jt._step_raw(jt.mesh, dict(jt.params, k_cell=k), jt.state,
                            jb)[0]["T"]

    def tstep(k):
        return tt._step(tt.mesh, dict(tt.params, k_cell=k), tt.state,
                        tb)[0]["T"]

    _, dj = jax.jvp(jstep, (jt.params["k_cell"],), (jnp.asarray(dk),))
    _, dt = torch.func.jvp(tstep, (tt.params["k_cell"],),
                           (torch.as_tensor(dk),))
    close(dt.numpy(), np.asarray(dj))
