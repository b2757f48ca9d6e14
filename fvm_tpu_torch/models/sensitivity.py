"""Sensitivities and uncertainty for the diffusion-family models
(counterpart of ``fvm_tpu/models/sensitivity.py``).

The reference gets parameter sensitivities by recompiling every model with
the Tangent atype (models.cpp:10-74, atypes/tangent_double/atype.h:10) and
uncertainty statistics with the intrusive polynomial-chaos atype
(fvmbase/PC.h:61).  Here one mixin covers every model whose outer
iteration is "linearize (A, r), solve, correct":

* ``solve_tangent``: forward mode, ``torch.func.jvp`` through an
  implicitly differentiated solve at the converged state (x* solves
  R(x*, p) = 0, so dx* = A^-1 dR/dp . dp with A = -dR/dx: the tangent of
  x + A^-1 r at r = 0);
* ``solve_adjoint``: reverse mode, ``torch.autograd.grad`` through the
  same solve made transposable, one transposed solve for the gradient
  with respect to whole parameter fields (the reference has no reverse
  mode);
* ``solve_mc``: Monte-Carlo parameter sweeps, a loop of whole solves over
  the samples on the device (the matrix changes with every sample, so no
  batch shares one);
* ``solve_pc``: non-intrusive polynomial chaos (Gauss-Hermite projection
  of ``solve_mc`` samples onto the orthonormal Hermite basis).

``jfnk_adjoint`` is the reverse mode of a model given by a residual
function (structure, plate), with the exact transposed Jacobian from
reverse-mode AD of the residual.

Models mix this in by providing ``var`` (the state key of the unknown) and
``_linearize(mesh, params, state, bcvals) -> (A, r)``; models with several
unknowns or solvers (species per species, electric's potential) call the
``*_impl`` entry points with explicit bindings.  The distributed branches
of the JAX package (``shard_map``) wait for ROADMAP queue 1 item 8: a
model with a ``partition`` raises.
"""

from __future__ import annotations

import inspect
import itertools
from math import factorial

import numpy as np
import torch

from ..core import bcs as bck
from ..exceptions import ConfigError
from ..linear.base import MatrixFreeOperator
from .base import as_tensor_like


def single_device(model, what: str) -> None:
    """Raise ``ConfigError`` for a model on a partitioned mesh: the
    distributed sensitivities are not ported yet."""
    if getattr(model, "partition", None) is not None:
        raise ConfigError(
            f"{model.name}.{what}: distributed sensitivities (a partitioned "
            "mesh) are not ported yet (ROADMAP queue 1 item 8)")


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _he(k: int, x) -> np.ndarray:
    """The orthonormal probabilists' Hermite polynomial he_k(x) / sqrt(k!)."""
    c = np.zeros(k + 1)
    c[k] = 1.0
    return np.polynomial.hermite_e.hermeval(x, c) / np.sqrt(factorial(k))


class PCExpansion:
    """Polynomial-chaos expansion (fvmbase/PC.h:61: the intrusive
    PC<ORDER,DIM> atype's coefficients, here by non-intrusive spectral
    projection).

    ``coefficients`` maps multi-index tuples alpha -> (n_interior,)
    coefficient fields in the orthonormal probabilists' Hermite basis, so
    mean = c_0 and variance = sum_{alpha != 0} c_alpha^2."""

    def __init__(self, coefficients: dict, ndim: int):
        self.coefficients = coefficients
        self.ndim = ndim

    def mean(self) -> np.ndarray:
        return self.coefficients[(0,) * self.ndim]

    def variance(self) -> np.ndarray:
        z = (0,) * self.ndim
        return sum(c**2 for a, c in self.coefficients.items() if a != z)

    def std(self) -> np.ndarray:
        return np.sqrt(self.variance())

    def eval(self, xi) -> np.ndarray:
        """The surrogate at a sample point xi (ndim,)."""
        xi = np.atleast_1d(np.asarray(xi, np.float64))
        out = 0.0
        for a, c in self.coefficients.items():
            psi = 1.0
            for i, k in enumerate(a):
                psi *= _he(k, xi[i])
            out = out + psi * c
        return out


def jfnk_adjoint(model, var, system, functional, param_keys, bc_keys,
                 chain=None):
    """Reverse-mode adjoint of a model given by a residual function
    (``fvm_tpu/models/sensitivity.py:82-212``).

    At convergence R(w*, p) = 0 the adjoint lambda solves A^T lambda =
    dJ/dw with the exact transposed Jacobian A^T u = -(dR/dw)^T u, one
    reverse-mode product of R per application (its graph built once at
    w*); the gradients are dJ/dp = (dR/dp)^T lambda.  ``system(mesh,
    params, state, bcvals, w) -> (A_surrogate, R)`` is the model's
    residual binding (the surrogate gives the diagonal, the reductions
    and the preconditioner); ``chain`` = (inputs, props_fn) maps design
    variables through a property closure (props_fn(inputs) -> a params
    sub-dict); requested keys found in ``inputs`` are chain-ruled.
    Returns {key: (n_interior, ...) gradient} as numpy, BC keys per face.
    """
    if not model._initialized:
        raise ConfigError("call init() + advance() before solve_adjoint")
    single_device(model, "solve_adjoint")
    mesh = model.mesh
    bcvals = model._resolve_bcvals()
    solver = model.options["linearSolver"]
    n_int = mesh.n_interior_cells
    params, state = model.params, model.state

    chain_inputs, props_fn = chain or ({}, None)
    chain_keys = [k for k in param_keys if k in chain_inputs]
    direct = [k for k in param_keys if k not in chain_inputs]
    prop_out = (sorted(props_fn(chain_inputs)) if (props_fn and chain_keys)
                else [])
    need = sorted(set(direct) | set(prop_out))
    for k in need:
        if k not in params:
            raise ConfigError(
                f"{model.name}.solve_adjoint: unknown parameter {k!r}")
    for k in bc_keys:
        if k not in bcvals:
            raise ConfigError(
                f"{model.name}.solve_adjoint: unknown BC entry {k!r}")

    w = state[var].detach()
    with torch.enable_grad():
        wv = w.clone().requires_grad_(True)
        A, R = system(mesh, params, state, bcvals, wv)

    def mvT(u):
        return -torch.autograd.grad(R, wv, u, retain_graph=True)[0]

    with torch.enable_grad():
        wj = w.clone().requires_grad_(True)
        (gJ,) = torch.autograd.grad(functional(wj[:n_int]), wj)
    # cells with no face (padding) are frozen: their cotangent is 0
    alive = mesh.cf_mask.any(dim=0)
    gJ = torch.where(alive[:, None] if gJ.ndim == 2 else alive, gJ, 0.0)
    lam, _ = solver.solve_fn(MatrixFreeOperator(mvT, A), gJ,
                             torch.zeros_like(gJ))

    with torch.enable_grad():
        base_p = {k: params[k].detach().clone().requires_grad_(True)
                  for k in need}
        base_b = {k: bcvals[k].detach().clone().requires_grad_(True)
                  for k in bc_keys}
        r = system(mesh, dict(params, **base_p), state,
                   dict(bcvals, **base_b), w)[1]
        leaves = list(base_p.values()) + list(base_b.values())
        grads = torch.autograd.grad(r, leaves, lam, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    gp = dict(zip(base_p, grads[: len(base_p)]))
    gb = dict(zip(base_b, grads[len(base_p):]))

    out = {k: _numpy(bck.fold_ghosts(mesh, gp[k])) for k in direct}
    if chain_keys:
        with torch.enable_grad():
            ins = {k: as_tensor_like(v, w).requires_grad_(True)
                   for k, v in chain_inputs.items()}
            props = props_fn(ins)
            gins = torch.autograd.grad(
                [props[k] for k in prop_out], [ins[k] for k in chain_keys],
                [gp[k] for k in prop_out], allow_unused=True)
        for k, g in zip(chain_keys, gins):
            g = torch.zeros_like(ins[k]) if g is None else g
            out[k] = _numpy(bck.fold_ghosts(mesh, g))
    for k in bc_keys:
        out[k] = _numpy(gb[k])
    return out


class TangentMixin:
    """Adds solve_tangent / solve_adjoint / solve_mc / solve_pc to a Model.

    Default bindings: the unknown ``self.var`` in ``self.state``, the
    linearization ``self._linearize``, the solver
    ``self.options["linearSolver"]``."""

    # --- default public surface ---------------------------------------

    def solve_tangent(self, param_tangents: dict) -> np.ndarray:
        """Forward-mode sensitivity d(x*)/d(params) . dparams at the
        current (converged) state, on the interior cells.

        ``param_tangents`` maps keys of ``self.params`` (e.g. "D",
        "k_cell") to tangent arrays of the entry's shape, or (n_interior,)
        arrays (zero-padded and ghost-extended like the primal).  Exact for
        the linearizations in A; upwind convection is Picard-linearized, as
        in the reference."""
        return self._tangent_impl(
            self.var, self._linearize, self.options["linearSolver"],
            param_tangents)

    def solve_adjoint(self, functional, param_keys) -> dict:
        """Reverse-mode gradient of a scalar functional of the converged
        solution with respect to whole parameter fields, from one
        transposed solve.

        ``functional``: ``fn(x_interior) -> scalar tensor`` or
        ``fn(x_interior, params) -> scalar tensor`` (the two-argument form
        also takes the explicit parameter dependence of the objective,
        e.g. a flux integral that contains the conductivity).  Returns
        ``{key: (n_interior,) gradient}`` (ghost copies' gradients folded
        onto their interior owners, as ``solve_tangent`` extends interior
        directions to ghosts)."""
        return self._adjoint_impl(
            self.var, self._linearize, self.options["linearSolver"],
            functional, param_keys)

    def solve_mc(self, param_key: str, samples, niter: int = 20) -> np.ndarray:
        """Parameter sweep: ``samples`` is (S,) scalars or (S, n) fields
        for ``self.params[param_key]``; returns (S, n_interior) solutions,
        each ``niter`` outer iterations from the current state."""
        return self._mc_impl(
            self.var, self._linearize, self.options["linearSolver"],
            param_key, samples, niter)

    def solve_pc(self, param_key: str, mean, directions, order: int = 2,
                 niter: int = 20, quad_points: int | None = None
                 ) -> PCExpansion:
        """Non-intrusive polynomial chaos (the role of the reference's
        PC<ORDER,DIM> atype, fvmbase/PC.h:61).

        The uncertain parameter is p(xi) = mean + sum_i xi_i dir_i with
        independent standard normal xi_i.  Solutions at tensor
        Gauss-Hermite nodes (``solve_mc``) are projected onto the
        orthonormal probabilists' Hermite basis up to total degree
        ``order``."""
        dirs = [np.asarray(d, dtype=np.float64) for d in directions]
        ndim = len(dirs)
        q = int(quad_points or (order + 1))
        nodes, weights = np.polynomial.hermite_e.hermegauss(q)
        weights = weights / weights.sum()  # normalized N(0, 1) quadrature

        n_int = self.mesh.n_interior_cells
        mean_f = np.broadcast_to(np.asarray(mean, np.float64), (n_int,))
        dir_f = [np.broadcast_to(d, (n_int,)) for d in dirs]

        grids = list(itertools.product(range(q), repeat=ndim))
        xi = np.array([[nodes[i] for i in g] for g in grids])  # (Q, ndim)
        W = np.array([np.prod([weights[i] for i in g]) for g in grids])
        samples = mean_f[None, :] + xi @ np.stack(dir_f)  # (Q, n_int)
        sols = self.solve_mc(param_key, samples, niter=niter)

        alphas = [a for a in itertools.product(range(order + 1), repeat=ndim)
                  if sum(a) <= order]
        coeffs = {}
        for a in alphas:
            psi = np.prod([_he(k, xi[:, i]) for i, k in enumerate(a)],
                          axis=0)  # (Q,)
            coeffs[a] = (W * psi) @ sols
        return PCExpansion(coeffs, ndim)

    # --- implementation entry points (explicit bindings) ---------------

    def _tangent_impl(self, var, linearize, solver, param_tangents):
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_tangent")
        single_device(self, "solve_tangent")
        mesh, state = self.mesh, self.state
        bcvals = self._resolve_bcvals()
        base = {k: self.params[k] for k in param_tangents}
        tans = {k: self._pad_cell_tangent(self.params[k], v)
                for k, v in param_tangents.items()}

        def step_from_converged(p):
            A, r = linearize(mesh, dict(self.params, **p), state, bcvals)
            dx, _ = solver.solve_fn_implicit(A, r, torch.zeros_like(r))
            return state[var] + dx

        _, dphi = torch.func.jvp(step_from_converged, (base,), (tans,))
        return _numpy(dphi[: mesh.n_interior_cells])

    def _adjoint_impl(self, var, linearize, solver, functional, param_keys):
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_adjoint")
        single_device(self, "solve_adjoint")
        mesh, state = self.mesh, self.state
        bcvals = self._resolve_bcvals()
        n_int = mesh.n_interior_cells
        with_params = len(inspect.signature(functional).parameters) >= 2
        # differentiate over the INTERIOR values, through the same
        # interior -> ghost extension solve_tangent gives its directions:
        # autograd then folds ghost-copy cotangents onto their owners
        base = {k: self.params[k][:n_int].detach().clone().requires_grad_(True)
                for k in param_keys}
        with torch.enable_grad():
            params = dict(self.params, **{
                k: self._pad_cell_tangent(self.params[k], v)
                for k, v in base.items()})
            A, r = linearize(mesh, params, state, bcvals)
            dx, _ = solver.solve_fn_implicit(A, r, torch.zeros_like(r),
                                             transposable=True)
            x = state[var] + dx
            J = (functional(x[:n_int], params) if with_params
                 else functional(x[:n_int]))
            grads = torch.autograd.grad(J, list(base.values()),
                                        allow_unused=True)
        return {k: _numpy(torch.zeros_like(v) if g is None else g)
                for (k, v), g in zip(base.items(), grads)}

    def _mc_impl(self, var, linearize, solver, param_key, samples, niter):
        if not self._initialized:
            raise ConfigError("call init() before solve_mc")
        single_device(self, "solve_mc")
        mesh = self.mesh
        bcvals = self._resolve_bcvals()
        ref = self.params[param_key]
        samples = as_tensor_like(samples, ref)
        if samples.ndim == 1:
            samples = samples[:, None].expand(
                (samples.shape[0],) + tuple(ref.shape))
        state0 = self.state
        sols = []
        for val in samples:
            if val.shape != ref.shape:
                val = self._pad_cell_tangent(ref, val)
            params = dict(self.params, **{param_key: val})
            st = state0
            for _ in range(niter):
                A, r = linearize(mesh, params, st, bcvals)
                dx, _ = solver.solve_fn(A, r, torch.zeros_like(r))
                st = dict(st, **{var: st[var] + dx})
            sols.append(st[var][: mesh.n_interior_cells])
        return _numpy(torch.stack(sols))
