#!/usr/bin/env python3
"""The kinetic adjoint's transposed solve: its trips, residual and duality
with and without the BiCGStab shadow restart, on the card and under small
changes to the transposed products on the CPU.

Run from the repository root:

    python3 -m scripts.kinetic_duality            # needs an NVIDIA GPU
    python3 -m scripts.kinetic_duality --cpu-samples K

The case is ``chip_smoke.kinetic_duality``'s (tests/test_kinetic.py:
749-795: the Couette layout on quad_2d(3, 10), Quadrature(8, 8, 4), BGK,
tau 0.2, walls at +-0.3, 12 COMET outers; the tangents in tau and the top
wall's velocity, the adjoint of J = sum((f w c_x)^2)).

With no argument it runs the case on the CPU and then twice on the card:
"restart", ``solve_adjoint`` as it is (BiCGStab with ``stall_restart``),
and "plain", its transposed solve without the restart (the JAX package's
setting), printing for each the adjoint's trips (cap 400) and final
relative residual, the duality and the adjoint's difference from the
CPU's.

With ``--cpu-samples K`` it stays on the CPU and multiplies every
transposed product by 1 + eps e_k (eps 1e-16 and 1e-15, e_k a fixed
seeded normal field, k < K): the kind of change another machine's rounding
makes.  For the port with and without the restart it prints the trips,
the residual and the duality; for the JAX reference (``fvm_tpu``, no
restart; it reports no trips) the duality; for both the tau gradient's
largest change from its unchanged solve, relative to its largest entry.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

EPS = (1e-16, 1e-15)


@contextlib.contextmanager
def no_restart():
    """``solve_adjoint``'s BiCGStab without ``stall_restart`` while open."""
    from fvm_tpu_torch.kinetic import esbgk

    base = esbgk.BiCGStab

    class Plain(base):
        def __init__(self, *a, **kw):
            kw["stall_restart"] = False
            super().__init__(*a, **kw)

    orig = esbgk.KineticModel.solve_adjoint

    def solve_adjoint(self, *a, **kw):
        esbgk.BiCGStab = Plain
        try:
            return orig(self, *a, **kw)
        finally:
            esbgk.BiCGStab = base

    esbgk.KineticModel.solve_adjoint = solve_adjoint
    try:
        yield
    finally:
        esbgk.KineticModel.solve_adjoint = orig


def card() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kinetic_duality: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.smi_line(), flush=True)
    cpu = cs.kinetic_duality("cpu")
    for variant in ("cpu", "restart", "plain"):
        if variant == "cpu":
            out = cpu
        else:
            ctx = no_restart() if variant == "plain" else \
                contextlib.nullcontext()
            with ctx:
                out = cs.kinetic_duality(torch.device("cuda", 0))
        cs.log("duality", f"{variant}: adjoint {out['adj_its']} trips, "
               f"relative residual {out['adj_rel']:.3e}, {out['adj_s']:.2f} "
               f"s; tangent {out['tan_its']} trips; duality "
               f"{out['duality']:.3e}; adjoint against the cpu's "
               f"{cs.gate_diff(out['adjoint'], cpu['adjoint']):.3e}; "
               f"tangent against the cpu's "
               f"{cs.gate_diff(out['tangent'], cpu['tangent']):.3e}")
    return 0


def port_model():
    from fvm_tpu_torch import cases

    m = cases.esbgk_couette(*cs.KIN_SENS, device="cpu", collision="BGK",
                            tau=0.2)
    m.advance(cs.KIN_SENS_OUTERS)
    return m


def jax_model():
    import fvm_tpu as fvm
    from fvm_tpu.kinetic import KineticModel, Quadrature

    m = KineticModel(fvm.mesh.build_device_mesh(
        fvm.mesh.generate.quad_2d(*cs.KIN_SENS)), Quadrature(8, 8, 4))
    m.options["verbose"] = False
    m.vc["relaxationTime"] = 0.2
    for s, uw in (("top", 0.3), ("bottom", -0.3)):
        m.bc[s].bc_type = "DiffuseWall"
        m.bc[s]["specifiedXVelocity"] = uw
    m.bc["left"].bc_type = "Symmetry"
    m.bc["right"].bc_type = "Symmetry"
    m.init()
    m.advance(cs.KIN_SENS_OUTERS)
    return m


def samples(k_max: int) -> int:
    import jax
    import jax.numpy as jnp
    import torch
    from fvm_tpu.linear import base as jbase
    from fvm_tpu_torch.kinetic import esbgk

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)

    for package in ("port", "jax"):
        m = port_model() if package == "port" else jax_model()
        ni = m.mesh.n_interior_cells
        dtau = np.random.default_rng(3).standard_normal(ni)
        tan = m.solve_tangent(param_tangents={"tau": dtau})
        q = m.quadrature
        wcx_np = np.asarray(q.w) * np.asarray(q.c)[:, 0]
        f0 = np.asarray(m.state["f"])[:ni]
        # J = sum((f w c_x)^2): dJ . df = 2 sum((f w c_x)(df w c_x))
        dJ = float(2.0 * np.sum((f0 @ wcx_np) * (np.asarray(tan) @ wcx_np)))
        if package == "port":
            wcx = torch.as_tensor(wcx_np)

            def J(ff):
                return torch.sum((ff @ wcx) ** 2)

            owner, attr = esbgk._VJPOperator, "mv"
        else:
            wcx = jnp.asarray(wcx_np)

            def J(ff):
                return jnp.sum((ff @ wcx) ** 2)

            owner, attr = jbase.TransposedOperator, "mv"
        orig = getattr(owner, attr)
        shape = tuple(np.asarray(m.state["f"]).shape)
        variants = ((("restart", contextlib.nullcontext),
                     ("plain", no_restart)) if package == "port"
                    else (("plain", contextlib.nullcontext),))
        for name, ctx in variants:
            ref = None
            for k in range(-1, k_max):
                for eps in ((0.0,) if k < 0 else EPS):
                    e = np.random.default_rng(100 + max(k, 0)) \
                        .standard_normal(shape)
                    e = torch.as_tensor(e) if package == "port" \
                        else jnp.asarray(e)

                    def mv(self, u, eps=eps, e=e):
                        return orig(self, u) * (1.0 + eps * e)

                    setattr(owner, attr, mv)
                    try:
                        with ctx():
                            g = m.solve_adjoint(J, param_keys=("tau",))
                    finally:
                        setattr(owner, attr, orig)
                    g = {key: np.asarray(v) for key, v in g.items()}
                    if ref is None:
                        ref = g["tau"]
                    trips = ""
                    if package == "port":
                        st = m.adjoint_stats
                        trips = (f"{int(st.iterations)} trips, relative "
                                 f"residual "
                                 f"{float(st.residual / st.residual0):.3e}, ")
                    dual = abs(float(g["tau"] @ dtau) - dJ) / abs(dJ)
                    cs.log("duality", f"{package} {name}, k {k}, eps {eps:g}: "
                           f"{trips}duality {dual:.3e}, tau gradient moved "
                           f"{cs.gate_diff(g['tau'], ref):.3e}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-samples", type=int, default=0)
    args = ap.parse_args()
    if args.cpu_samples:
        return samples(args.cpu_samples)
    return card()


if __name__ == "__main__":
    raise SystemExit(main())
