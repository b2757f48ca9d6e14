"""Extruded prism meshes and electrostatics against fvm_tpu (float64, CPU).

* ``extrude``: coordinates, face->node and face->cell tables and groups
  bit-identical to the JAX package's on ``quad_2d(4, 3)`` and
  ``tri_2d(6, 5)``; with them ``Mesh.cell_faces`` and ``cell_nodes``, the
  ``CRConnectivity`` algebra (``row``, ``from_rows``, ``transpose``,
  ``multiply``) and ``DeviceMesh.group_by_name``; the volume check of
  ``tests/test_ibm.py:88``.
* ``ElectricModel``: the capacitor and space-charge cases of
  ``tests/test_electric_species.py:16, 38`` (analytic), with the
  potentials against fvm_tpu; ``_linearize_potential``'s ``(A, r)`` to
  1e-12 on an extruded tri mesh with per-cell permittivity, space charge
  and a surface charge; the ``outerChunk`` advance against the eager one,
  and five outers against fvm_tpu to 1e-8 (its own history moves by
  3.4e-15 under a 1e-15 change of the zmax potential:
  ``scripts/roundoff_sensitivity.py --cases electric``, CPU); state and
  params loaded from fvm_tpu.
* bench's electrostatics solve (``bench.py:815-862``: f64 BiCGStab with
  ``JacobiSolver(sweeps=2)``, rtol 1e-10, ``stall_restart``) on the
  reference-size prism stand-in (``cases.electrostatics_standin``, 7,680
  prisms): it converges, and the solution equals fvm_tpu's to 1e-8.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.linear import BiCGStab as JBiCGStab, JacobiSolver as JJacobi
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.mesh.metrics import compute_geometry as jgeometry
from fvm_tpu.models.electric import ElectricModel as JElectric
from fvm_tpu.models.fmg import snapshot_state
from fvm_tpu_torch import cases
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh, compute_geometry
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.mesh.connectivity import CRConnectivity
from fvm_tpu_torch.models import EPS0, ElectricModel as TElectric
from test_torch_newton import one_thread  # noqa: F401

LATERAL = ("left", "right", "bottom", "top")


def _same_cr(a, b):
    assert a.count_to == b.count_to
    assert np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col, b.col)


def _groups(m):
    return [(g.ident, g.name, g.group_type, g.offset, g.count)
            for g in m.face_groups]


@pytest.mark.parametrize("kind,args,nz", [("quad_2d", (4, 3), 5),
                                          ("tri_2d", (6, 5), 4)])
def test_extrude_tables_equal_fvm_tpu_bit_for_bit(kind, args, nz):
    j2, t2 = getattr(jgen, kind)(*args), getattr(tgen, kind)(*args)
    _same_cr(t2.cell_faces, j2.cell_faces)
    _same_cr(t2.cell_nodes, j2.cell_nodes)
    jm = jgen.extrude(j2, nz, lz=0.7, z0=0.1)
    tm = tgen.extrude(t2, nz, lz=0.7, z0=0.1)
    assert np.array_equal(tm.coords, jm.coords)
    _same_cr(tm.face_nodes, jm.face_nodes)
    assert np.array_equal(tm.face_cells, jm.face_cells)
    assert _groups(tm) == _groups(jm)
    _same_cr(tm.cell_nodes, jm.cell_nodes)
    # the connectivity algebra
    _same_cr(tm.face_nodes.transpose(), jm.face_nodes.transpose())
    for drop in (True, False):
        _same_cr(tm.cell_faces.multiply(tm.face_nodes, drop_self=drop),
                 jm.cell_faces.multiply(jm.face_nodes, drop_self=drop))
    rows = [jm.face_nodes.row(f) for f in range(jm.n_faces)]
    _same_cr(CRConnectivity.from_rows(rows, jm.n_nodes), jm.face_nodes)
    assert all(np.array_equal(tm.face_nodes.row(f), r)
               for f, r in enumerate(rows))


def test_extrude_volume_and_groups():
    """``tests/test_ibm.py:88``: 4 x 3 quads of 2 x 1.5 extruded 5 deep
    over 0.5."""
    m3 = tgen.extrude(tgen.quad_2d(4, 3, lx=2.0, ly=1.5), nz=5, lz=0.5)
    assert m3.dim == 3 and m3.n_interior_cells == 4 * 3 * 5
    g = compute_geometry(m3)
    assert g.cell_volume[: m3.n_interior_cells].sum() == pytest.approx(
        2.0 * 1.5 * 0.5, rel=1e-10)
    assert {"left", "right", "bottom", "top", "zmin", "zmax"} <= {
        fg.name for fg in m3.boundary_groups}
    dm = build_device_mesh(m3, dtype="float64", device="cpu")
    g = dm.group_by_name("zmax")
    assert g[1] == "zmax" and g[4] == 12
    with pytest.raises(KeyError):
        dm.group_by_name("nowhere")


def _capacitor(cls, dm):
    m = cls(dm)
    m.options["verbose"] = False
    m.bc["left"].bc_type = "SpecifiedPotential"
    m.bc["left"]["specifiedPotential"] = 100.0
    m.bc["right"].bc_type = "SpecifiedPotential"
    m.bc["right"]["specifiedPotential"] = 0.0
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


def _space_charge(cls, dm):
    m = cls(dm)
    m.options["verbose"] = False
    m.vc["dielectric_constant"] = 1.0 / EPS0
    m.vc["initialCharge"] = 1.0
    for s in ("left", "right"):
        m.bc[s].bc_type = "SpecifiedPotential"
        m.bc[s]["specifiedPotential"] = 0.0
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


@pytest.mark.parametrize("case,shape", [("capacitor", (20, 4)),
                                        ("space_charge", (32, 2))])
def test_analytic_cases_and_fvm_tpu(case, shape):
    make = _capacitor if case == "capacitor" else _space_charge
    jm = make(JElectric, jfvm.mesh.build_device_mesh(jgen.quad_2d(*shape),
                                                     dtype=jnp.float64))
    dm = build_device_mesh(tgen.quad_2d(*shape), dtype="float64",
                           device="cpu")
    tm = make(TElectric, dm)
    hj, ht = jm.advance(5), tm.advance(5)
    x = dm.cell_centroid[: dm.n_interior_cells, 0].numpy()
    phi = tm.getPotential()
    if case == "capacitor":
        assert ht[-1][1] / ht[0][1] < 1e-8
        np.testing.assert_allclose(phi, 100.0 * (1.0 - x), rtol=1e-8)
        E = tm.getElectricField()
        np.testing.assert_allclose(E[:, 0], 100.0, rtol=1e-6)
        np.testing.assert_allclose(E[:, 1], 0.0, atol=1e-6)
    else:
        np.testing.assert_allclose(phi, x * (1 - x) / 2, atol=3e-4)
    np.testing.assert_allclose(phi, jm.getPotential(), rtol=1e-8,
                               atol=1e-10 * np.abs(phi).max())
    np.testing.assert_allclose(tm.getElectricField(), jm.getElectricField(),
                               rtol=1e-6, atol=1e-8 * np.abs(phi).max())
    np.testing.assert_allclose(ht[0][1], hj[0][1], rtol=1e-12)


def _prism_models(seed=0):
    """Both packages' ElectricModel on an extruded tri mesh with per-cell
    permittivity and space charge, a surface charge on zmin and a random
    potential state."""
    rng = np.random.default_rng(seed)
    jmesh = jgen.extrude(jgen.tri_2d(6, 5), 4, lz=0.5)
    jdm = jfvm.mesh.build_device_mesh(jmesh, dtype=jnp.float64)
    tdm = build_device_mesh(tgen.extrude(tgen.tri_2d(6, 5), 4, lz=0.5),
                            dtype="float64", device="cpu")
    nc = jmesh.n_interior_cells
    eps_r, q = rng.uniform(1.0, 10.0, nc), 1e-9 * rng.normal(size=nc)
    phi0 = rng.normal(size=jdm.n_cells)
    out = []
    for cls, dm in ((JElectric, jdm), (TElectric, tdm)):
        m = cls(dm)
        m.options["verbose"] = False
        m.vc["dielectric_constant"] = eps_r
        m.vc["initialCharge"] = q
        m.bc["zmax"].bc_type = "SpecifiedPotential"
        m.bc["zmax"]["specifiedPotential"] = 1.0
        m.bc["zmin"].bc_type = "SpecifiedCharge"
        m.bc["zmin"]["specifiedCharge"] = 1e-10
        for g in LATERAL:
            m.bc[g].bc_type = "Symmetry"
        m.init()
        m.state["potential"] = (jnp.asarray(phi0) if cls is JElectric
                                else torch.from_numpy(phi0.copy()))
        out.append(m)
    return out


def test_linearize_potential_equals_fvm_tpu():
    jm, tm = _prism_models()
    A1, r1 = jm._linearize_potential(jm.mesh, jm.params, jm.state,
                                     jm._resolve_bcvals())
    A2, r2 = tm._linearize_potential(tm.mesh, tm.params, tm.state,
                                     tm._resolve_bcvals())
    for a, b in ((A1.diag, A2.diag), (A1.off, A2.off), (r1, r2)):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())
    assert np.array_equal(np.asarray(A1.cols), A2.cols.numpy())


def test_chunked_advance_and_loaded_state():
    jm, tm = _prism_models(1)
    chunked = _prism_models(1)[1]
    chunked.options["outerChunk"] = 3
    he, hc = tm.advance(5), chunked.advance(5)
    np.testing.assert_allclose([h[1] for h in hc], [h[1] for h in he],
                               rtol=1e-12)
    np.testing.assert_allclose(chunked.getElectricField(),
                               tm.getElectricField(), rtol=1e-12, atol=0)
    hj = jm.advance(5)
    np.testing.assert_allclose([h[1] for h in he], [h[1] for h in hj],
                               rtol=1e-8)
    # fvm_tpu's state and params loaded into a fresh port model
    fresh = _prism_models(2)[1]
    load_model_state(fresh, snapshot_state(jm),
                     {k: np.asarray(v) for k, v in jm.params.items()})
    np.testing.assert_array_equal(fresh.getPotential(), jm.getPotential())
    np.testing.assert_array_equal(fresh.params["eps"].numpy(),
                                  np.asarray(jm.params["eps"]))


def test_charge_transport_raises():
    """Charge transport is ported (``tests/test_torch_charge_transport.
    py``), and so is its distributed branch (``tests/test_torch_dist.py``);
    what raises is a partition given with a mesh that is no rank's local
    mesh (``Partition.local_mesh``)."""
    dm = build_device_mesh(tgen.quad_2d(4, 4), dtype="float64", device="cpu")
    m = TElectric(dm)
    for g in LATERAL:
        m.bc[g].bc_type = "Symmetry"
    m.options["chargetransport_enable"] = True
    m.init()
    with pytest.raises(ConfigError, match="local mesh"):
        TElectric(dm, partition=object())


def test_bench_solve_on_the_reference_size_standin():
    em = cases.electrostatics_standin("reference", device="cpu")
    assert em.mesh.n_interior_cells == 7680
    r = cases.electrostatics_run(em, reps=1)
    assert r["converged"] and r["residual_rel"] <= 1e-10
    assert 0 < r["iterations_to_tol"] < 2000
    # fvm_tpu on the same mesh with bench's solver
    n, nz, lz = cases.PRISM_STANDINS["reference"]
    jdm = jfvm.mesh.build_device_mesh(jgen.extrude(jgen.tri_2d(n, n), nz,
                                                   lz=lz), dtype=jnp.float64)
    jm = JElectric(jdm)
    jm.options["verbose"] = False
    solver = JBiCGStab(preconditioner=JJacobi(sweeps=2),
                       relative_tolerance=1e-10, max_iterations=2000,
                       stall_restart=True)
    jm.options["electrostaticsLinearSolver"] = solver
    jm.bc["zmax"].bc_type = "SpecifiedPotential"
    jm.bc["zmax"]["specifiedPotential"] = 1.0
    jm.bc["zmin"].bc_type = "SpecifiedPotential"
    jm.bc["zmin"]["specifiedPotential"] = 0.0
    for g in LATERAL:
        jm.bc[g].bc_type = "Symmetry"
    jm.init()
    A, b = jm._linearize_potential(jdm, jm.params, jm.state,
                                   jm._resolve_bcvals())
    x, st = solver.solve_fn(A, b, jnp.zeros_like(b))
    assert bool(st.converged)
    xj, xt = np.asarray(x), r["x"].numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    # the stand-in's potential: linear in z between the plates
    z = jgeometry(jgen.extrude(jgen.tri_2d(n, n), nz, lz=lz)).cell_centroid[
        : em.mesh.n_interior_cells, 2]
    np.testing.assert_allclose(xt[: em.mesh.n_interior_cells], z / lz,
                               atol=1e-8)
