"""The MEMS switch composition and its pieces against fvm_tpu (float64,
CPU).

* ``cases.MemsSwitch`` against the demo's ``MemsSwitch``
  (``demos/simulator_mems.py``, run by fvm_tpu) at nx 24, ny_gap 12 (the
  size of ``tests/test_mems.py``): the lumped stiffness and w_max at 0.3
  and 0.6 V_PI (the latter from the former's equilibrium) to 1e-10
  relative (``scripts/roundoff_sensitivity.py
  --cases structures``: a 1e-15 change of E moves fvm_tpu's own k and
  w_max by up to 1.1e-15), and 1.4 V_PI pulls in on both: the same
  pull-in bracket (0.6, 1.4] V_PI;
* the column-top field (segment reductions) against the demo's loop over
  columns, exactly;
* ``ContactModel``: the gap law and the boundary-group forces to 1e-14;
* ``SqueezeFilmModel``: the strip of ``tests/test_small_models.py:151``
  (pressure profile and damping force to 1e-10, after ``set_gap``).
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import ContactModel as JContact
from fvm_tpu.models import SqueezeFilmModel as JFilm
from fvm_tpu_torch.cases import MEMS_EPS0, mems_switch
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import ContactModel as TContact
from fvm_tpu_torch.models import SqueezeFilmModel as TFilm
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

DEMO = Path(__file__).resolve().parent.parent / "demos" / "simulator_mems.py"
MEMS_RTOL = 1e-10


@pytest.fixture(scope="module")
def switches():
    """(the demo's switch, the port's) at nx 24, ny_gap 12, with their
    lumped stiffness and static deflections."""
    mod = runpy.run_path(str(DEMO))
    assert mod["EPS0"] == MEMS_EPS0
    out = {}
    for name, sw in (("jax", mod["MemsSwitch"](nx=24, ny_gap=12)),
                     ("port", mems_switch(24, 12, device="cpu"))):
        k = sw.lumped_stiffness()
        V = np.sqrt(8.0 * k * sw.g0**3 / (27.0 * MEMS_EPS0 * sw.L * sw.W))
        # the bias steps up from rest, each from the last one's
        # equilibrium (as the demo's sweep): fewer coupling iterations
        w3 = sw.static_deflection(0.3 * V)
        w6 = sw.static_deflection(0.6 * V, w0=w3)
        out[name] = {"sw": sw, "k": k, "V": V, "w3": w3, "w6": w6,
                     "w14": sw.static_deflection(1.4 * V, w0=w6)}
    return out


def test_lumped_stiffness(switches):
    j, t = switches["jax"], switches["port"]
    assert abs(t["k"] - j["k"]) <= MEMS_RTOL * j["k"]
    assert t["sw"].pullin_formula(t["k"]) == pytest.approx(j["V"],
                                                           rel=MEMS_RTOL)


@pytest.mark.parametrize("key", ["w3", "w6"])
def test_static_deflection(switches, key):
    j, t = switches["jax"][key], switches["port"][key]
    assert j is not None and t is not None
    close(t, j, MEMS_RTOL)
    assert 0.0 < t.max() < 0.2 * 2.0


def test_pullin_bracket(switches):
    """1.4 V_PI has no stable equilibrium in either package (0.6 V_PI has
    one): the bracket (0.6, 1.4] V_PI; w_max scales ~V^2 below it."""
    for side in ("jax", "port"):
        s = switches[side]
        assert s["w14"] is None and s["w6"] is not None
        assert s["w6"].max() / s["w3"].max() == pytest.approx(4.0, rel=0.35)


def test_column_top_field_matches_the_demo_loop(switches):
    """The segment-reduction form against the demo's loop over columns
    on one field and mask (the port's switch's last electric solve)."""
    sw = switches["port"]["sw"]
    w = 0.5 * sw.g0 * np.sin(np.pi * sw.xp / sw.L) ** 2
    sw.electrostatic_pressure(w, 3.0)
    E = sw.elec.getElectricField()
    gap_x = np.interp(sw.xe, sw.xp, sw.g0 - w)
    mask = sw.ye > np.maximum(gap_x, 2.5 * sw.g0 / sw.ny_gap)
    got = sw.column_top_field(torch.as_tensor(E), mask)
    Em = np.linalg.norm(E, axis=1)
    ncol = sw.nx
    want = np.zeros(ncol)
    col = np.round((sw.xe - sw.xe.min()) / (sw.xe.max() - sw.xe.min())
                   * (ncol - 1)).astype(int)
    for c in range(ncol):
        sel = (col == c) & ~mask
        if sel.any():
            ytop = sw.ye[sel].max()
            want[c] = MEMS_EPS0 * float(Em[sel][sw.ye[sel] == ytop][0]) ** 2 / 2
    np.testing.assert_array_equal(got, want)
    assert (want > 0).all()


def test_contact_law_and_surface_force():
    """``tests/test_motion_contact.py:57``'s counter-surface, with the
    attractive term on too."""
    xs = np.linspace(0, 1, 50)
    surface = np.stack([xs, np.full(50, -0.05)], axis=1)
    jdm = jfvm.mesh.build_device_mesh(jgen.quad_2d(8, 2, ly=0.25),
                                      dtype=jnp.float64)
    tdm = build_device_mesh(tgen.quad_2d(8, 2, ly=0.25), dtype="float64",
                            device="cpu")
    jc, tc = JContact(jdm, surface), TContact(tdm, surface)
    for c in (jc, tc):
        c.vc["contactStiffness"] = 1000.0
        c.vc["contactGap"] = 0.1
        c.vc["hamakerConstant"] = 1e-6
    gaps = np.array([0.5, 0.09, 0.05, 1e-12, 0.1])
    close(tc.gap_force(gaps), jc.gap_force(gaps), 1e-14)
    for g in ("bottom", "top", "left"):
        close(tc.computeSolidSurfaceForce(g), jc.computeSolidSurfaceForce(g),
              1e-14)
    disp = np.full((8, 2), 0.02)
    close(tc.computeSolidSurfaceForce("bottom", disp),
          jc.computeSolidSurfaceForce("bottom", disp), 1e-14)
    assert (tc.computeSolidSurfaceForce("bottom")[:, 1] > 0).all()


def film(cls, build, gen):
    L, h0, mu = 2.0, 0.05, 0.3
    m = cls(build(gen.quad_2d(24, 3, lx=L, ly=1.0)))
    m.options["verbose"] = False
    m.vc["viscosity"] = mu
    m.vc["initialGap"] = h0
    m.bc["left"].bc_type = "Dirichlet"
    m.bc["right"].bc_type = "Dirichlet"
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


def test_squeeze_film_strip_matches():
    jm = film(JFilm, lambda m: jfvm.mesh.build_device_mesh(
        m, dtype=jnp.float64), jgen)
    tm = film(TFilm, lambda m: build_device_mesh(
        m, dtype="float64", device="cpu"), tgen)
    x = np.asarray(jm.mesh.cell_centroid)[: jm.mesh.n_interior_cells, 0]
    for h, dhdt in ((0.05, -1.0), (0.025, -1.0),
                    (0.05 + 0.01 * x, -1.0 - x)):
        jm.set_gap(h, dhdt)
        tm.set_gap(h, dhdt)
        jm.advance(3)
        tm.advance(3)
        close(tm.getPressure(), jm.getPressure(), MEMS_RTOL)
        assert tm.getDampingForce() == pytest.approx(jm.getDampingForce(),
                                                     rel=MEMS_RTOL)
