"""The port's distributed runtime on gloo CPU ranks against the JAX package.

Each rank count runs ONE world (``parallel.run_ranks``: fresh
``python -m fvm_tpu_torch.parallel.launch`` processes, one torch thread
each, a 120 s limit) through ``cases.dist_suite_rank``, which runs the
rank functions of ``fvm_tpu_torch.cases`` in turn; the ranks import
neither this module nor jax.  The JAX side runs in this process on the
conftest's virtual CPU devices.

* The halo exchange: the ranks' results against a numpy model of the
  partitioner's tables (``recv_idx[d, p]`` takes peer p's
  ``send_idx[p, d]`` rows), a scattered field's zeroed halo band restored
  bit for bit, and the dot-product test of the transpose, sum over ranks
  of <E x, y> = <x, E^T y> to 1e-15 relative; reverse mode of <E x, y>
  equals E^T y (bit for bit: the same exchange).
* ``tests/test_parallel.py:48-76``'s thermal case on 2 and 4 ranks
  against ``fvm_tpu``'s sharded run: the temperature at 1e-10 relative,
  the histories at 1e-10 above ``HIST_FLOOR`` of the first residual (below
  it a converged solve's round-off remainder), the walls' heat flux
  integrals at 1e-10.
* Species and electrostatics (``tests/test_parallel.py:107-156``) on 2
  ranks against ``fvm_tpu``'s sharded runs at 1e-10.
* One coupled flow+thermal step of bench's cavity (32^2, 2 ranks, the
  shard-local AMG) from ``fvm_tpu``'s stacked state after 3 steps
  (``interop.shard_state``): every state entry of every rank at 1e-10 of
  its largest magnitude, on every cell but the dummy (meaningless in both
  packages: the JAX package's dummy velocity is NaN; the port's dummy row
  has no slots, ``parallel/partition.py``).
* The tri_2d general shard-local AMG of ``tests/test_parallel.py:786``
  (8 shards there) on 2 ranks against ``fvm_tpu``'s single-device run, at
  that test's own tolerances (temperature 2e-6, histories 1e-4 of
  max(r, 1)).
* The sharded cavity goldens (``tests/goldens/histories.json``,
  ``cavity/<family>/np4``: the cav32 SIMPLE cavity, viscosity 0.1, lid
  u = 1, ``Partition(mesh, 4)``, ``tests/test_golden_histories.py:43-112``).
  ``python3 -m scripts.roundoff_sensitivity --cases goldens_dist``
  measured how far ``fvm_tpu``'s own histories move under a 1e-15 change
  of the viscosity: JACOBI 5.0e-15 and CG 2.9e-13, held here at 1e-8 (the
  ``RTOL`` of ``tests/test_golden_histories.py:37``) over their first 15
  and 10 pinned outers (``chip_smoke.py`` phase 32 holds JACOBI's 30);
  AMG 7.5e-8 (BCGStab, ILU0, SPIKE 6.3e-2 to 8.0e-2), chaotic at its loose
  inner solves.  So the shard-local AMG cavity is held with tight inner
  solves instead (pressure ``AMG(coarse_size=16)`` to 1e-10, momentum
  ``BiCGStab(Jacobi(2))`` to 1e-12, 10 outers) against ``fvm_tpu``'s
  sharded run of the same configuration: histories at 1e-8, velocities at
  1e-10 of the largest, the walls' momentum and mass flux integrals at
  1e-10 of the largest force.  (``fvm_tpu``'s sharded and single-device runs
  differ by 4.3e-4 there: ``__graft_entry__.dryrun_multichip`` allows
  1e-3.)
* The rank processes import no jax, flax or fvm_tpu module.
* No quiet fallback: NCCL with more ranks than GPUs, a failed rank and a
  world past its time limit raise.

Each rank process costs ~6 s of CPU to start (torch and the port), so the
file keeps to two worlds and the goldens to prefixes: its CPU time counts
against the Tier-1 run's.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.linear import JacobiSolver as JJacobi
from fvm_tpu.models import (ElectricModel as JElectric, FlowModel as JFlow,
                            SpeciesModel as JSpecies,
                            ThermalModel as JThermal)
from fvm_tpu.parallel import Partition as JPartition
from fvm_tpu_torch.interop import stack_states
from fvm_tpu_torch.parallel import Partition as TPartition, run_ranks

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="the JAX side needs 4 devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens", "histories.json")
RANK_TIMEOUT = 120.0  # seconds, each world: a hang fails fast
HIST_RTOL = 1e-8  # tests/test_golden_histories.py RTOL
FIELD_RTOL = 1e-10
HIST_FLOOR = 1e-10
DOT_RTOL = 1e-15
COUPLED_N = 32
THERMAL_MESH = ("quad_2d", (16, 12))
HALO_MESH = ("quad_2d", (12, 8))
TRI_SPEC = {"kind": "BiCGStab", "pre": {"kind": "AMG", "coarse_size": 16},
            "relative_tolerance": 1e-11, "max_iterations": 80}
GOLDEN_OUTERS = {"JACOBI": 15, "CG": 10}
TIGHT_OUTERS = 10
WALLS = ("top", "bottom", "left", "right")  # cases.dist_cavity_rank's order
TIGHT_PRESSURE = {"kind": "AMG", "coarse_size": 16,
                  "relative_tolerance": 1e-10, "max_iterations": 100}
TIGHT_MOMENTUM = {"kind": "BiCGStab", "pre": {"kind": "JacobiSolver",
                                              "sweeps": 2},
                  "relative_tolerance": 1e-12, "max_iterations": 400}



def _quad(pkg, dims):
    return pkg.mesh.generate.quad_2d(*dims)


def _jax_thermal(shards):
    part = JPartition(_quad(jfvm, THERMAL_MESH[1]), shards)
    t = JThermal(part.sharded_mesh, partition=part)
    t.options["verbose"] = False
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "Convective"
    t.bc["right"]["heatTransferCoefficient"] = 5.0
    t.bc["right"]["farFieldTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "SpecifiedHeatFlux"
    t.bc["top"]["specifiedHeatFlux"] = 2.0
    t.init()
    hist = [h[1] for h in t.advance(10)]
    fluxes = [t.getHeatFluxIntegral(g) for g in
              ("left", "right", "top", "bottom")]
    return hist, t.getTemperature(), fluxes


def _jax_coupled(shards):
    """fvm_tpu's sharded bench cavity: the stacked states after 3 coupled
    steps, and the states and residuals after a 4th."""
    part = JPartition(_quad(jfvm, (COUPLED_N, COUPLED_N)), shards)
    sm = part.sharded_mesh

    def amg():
        return JAMG(coarse_size=256, relative_tolerance=1e-3,
                    max_iterations=6)

    f = JFlow(sm, partition=part)
    f.options["verbose"] = False
    f.vc["viscosity"] = 0.01
    for s in ("left", "right", "bottom", "top"):
        f.bc[s].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    f.options["pressureLinearSolver"] = amg()
    f.options["momentumLinearSolver"] = JBiCGStab(relative_tolerance=1e-2,
                                                  max_iterations=10)
    f.init()
    t = JThermal(sm, partition=part)
    t.options["verbose"] = False
    t.options["convective"] = True
    t.options["linearSolver"] = amg()
    for s in ("bottom", "top"):
        t.bc[s].bc_type = "Symmetry"
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.init()

    def step():
        hf = f.advance(1)
        t.state["massFlux"] = f.state["massFlux"]
        ht = t.advance(1)
        return [hf[-1][1], hf[-1][2], ht[-1][1]]

    for _ in range(3):
        step()
    start = ({k: np.asarray(v) for k, v in f.state.items()},
             {k: np.asarray(v) for k, v in t.state.items()})
    res = step()
    after = ({k: np.asarray(v) for k, v in f.state.items()},
             {k: np.asarray(v) for k, v in t.state.items()})
    return start, after, res


def _jax_species(shards):
    part = JPartition(_quad(jfvm, (12, 12)), shards)
    m = JSpecies(part.sharded_mesh, partition=part)
    m.options["verbose"] = False
    m.bc["left"].bc_type = "SpecifiedMassFraction"
    m.bc["left"]["specifiedMassFraction"] = 1.0
    m.bc["right"].bc_type = "SpecifiedMassFraction"
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    hist = [h[1] for h in m.advance(8)]
    return hist, m.getMassFraction(0), [m.getMassFluxIntegral(g)
                                        for g in ("left", "right")]


def _jax_electric(shards):
    part = JPartition(_quad(jfvm, (10, 10)), shards)
    m = JElectric(part.sharded_mesh, partition=part)
    m.options["verbose"] = False
    m.bc["left"].bc_type = "SpecifiedPotential"
    m.bc["left"]["specifiedPotential"] = 100.0
    m.bc["right"].bc_type = "SpecifiedPotential"
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return [h[1] for h in m.advance(6)], m.getPotential()


def _jax_tri():
    """fvm_tpu's single-device tri_2d thermal run of
    ``tests/test_parallel.py:786``."""
    t = JThermal(jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.tri_2d(20, 20)))
    t.options["verbose"] = False
    t.options["linearSolver"] = JBiCGStab(
        preconditioner=JAMG(coarse_size=16), relative_tolerance=1e-11,
        max_iterations=80)
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    hist = [h[1] for h in t.advance(12)]
    return hist, np.asarray(t.state["T"])[: t.mesh.n_interior_cells]


def _jax_tight():
    """fvm_tpu's sharded cav32 with tight inner solves."""
    part = JPartition(_quad(jfvm, (32, 32)), 4)
    sm = part.sharded_mesh
    f = JFlow(sm, partition=part)
    f.options["verbose"] = False
    f.vc["density"] = 1.0
    f.vc["viscosity"] = 0.1
    for s in ("left", "right", "bottom", "top"):
        f.bc[s].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    amg = JAMG(coarse_size=16, relative_tolerance=1e-10, max_iterations=100)
    assert amg.setup_structure_dist(
        np.asarray(sm.cf_nbr).transpose(0, 2, 1),
        np.asarray(sm.cf_mask).transpose(0, 2, 1), sm.n_owned_cells)
    f.options["pressureLinearSolver"] = amg
    f.options["momentumLinearSolver"] = JBiCGStab(
        preconditioner=JJacobi(sweeps=2), relative_tolerance=1e-12,
        max_iterations=400)
    f.init()
    hist = np.array([[h[1], h[2]] for h in f.advance(TIGHT_OUTERS)])
    mass = np.array([f.getMassFluxIntegral(g) for g in WALLS])
    force = np.stack([np.asarray(f.getMomentumFluxIntegral(g))
                      for g in WALLS])
    return hist, f.getVelocity(), mass, force


def _suite(world, cases):
    return run_ranks("dist_suite_rank", world, {"cases": cases},
                     device="cpu", backend="gloo", timeout=RANK_TIMEOUT)


CASES4 = [
    ("imports", "dist_imports_rank", {}),
    ("halo", "dist_halo_rank", {"mesh": HALO_MESH, "seed": 2}),
    ("thermal", "dist_thermal_rank", {
        "mesh": THERMAL_MESH, "bcs": "parallel", "niter": 10,
        "fluxes": True}),
] + [(fam, "dist_cavity_rank", {"solver": fam, "niter": outers})
     for fam, outers in GOLDEN_OUTERS.items()] + [
    ("tight", "dist_cavity_rank", {
        "solver": TIGHT_PRESSURE, "momentum": TIGHT_MOMENTUM,
        "niter": TIGHT_OUTERS, "integrals": True}),
]


def _cases2(start):
    return [
        ("halo", "dist_halo_rank", {"mesh": HALO_MESH}),
        ("halo2", "dist_halo_rank", {"mesh": HALO_MESH, "halo_depth": 2,
                                     "seed": 5}),
        ("thermal", "dist_thermal_rank", {
            "mesh": THERMAL_MESH, "bcs": "parallel", "niter": 10,
            "fluxes": True}),
        ("species", "dist_species_rank", {}),
        ("electric", "dist_electric_rank", {}),
        ("coupled", "dist_coupled_step_rank", {
            "n": COUPLED_N, "flow_state": start[0],
            "thermal_state": start[1]}),
        ("tri", "dist_thermal_rank", {
            "mesh": ("tri_2d", (20, 20)), "bcs": "golden", "niter": 12,
            "solver": TRI_SPEC}),
    ]


@pytest.fixture(scope="module")
def runs():
    """Both worlds, each in a thread that waits on its ranks, while this
    process runs the JAX side."""
    with ThreadPoolExecutor(2) as ex:
        w4 = ex.submit(_suite, 4, CASES4)
        coupled = _jax_coupled(2)
        w2 = ex.submit(_suite, 2, _cases2(coupled[0]))
        out = {"coupled": coupled, "thermal2": _jax_thermal(2),
               "thermal4": _jax_thermal(4), "species": _jax_species(2),
               "electric": _jax_electric(2), "tri": _jax_tri(),
               "tight": _jax_tight()}
        out["world2"], out["world4"] = w2.result(), w4.result()
    return out


def _close(a, b, rtol=FIELD_RTOL):
    a, b = np.asarray(a, float), np.asarray(b, float)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * np.nanmax(np.abs(b)),
                               equal_nan=True)


def _same_history(a, b, rtol=FIELD_RTOL):
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=HIST_FLOOR * abs(b[0]))


def _check_halo(res, key, shards, depth, seed):
    part = TPartition(_quad(tfvm, HALO_MESH[1]), shards, halo_depth=depth)
    xs = [r[f"{key}/x"] for r in res]
    for d, r in enumerate(res):
        # numpy model: slot recv_idx[d, p, j] takes peer p's cell
        # send_idx[p, d, j]; padded receives (index n_cells) are dropped
        want = xs[d].copy()
        for p in range(shards):
            rv = part.recv_idx[d, p]
            ok = rv < part.n_cells_local
            want[rv[ok]] = xs[p][part.send_idx[p, d][ok]]
        np.testing.assert_array_equal(r[f"{key}/Ex"], want)
        np.testing.assert_array_equal(r[f"{key}/grad"], r[f"{key}/ETy"])
    lhs = sum(float((r[f"{key}/Ex"] * r[f"{key}/y"]).sum()) for r in res)
    rhs = sum(float((r[f"{key}/x"] * r[f"{key}/ETy"]).sum()) for r in res)
    assert abs(lhs - rhs) <= DOT_RTOL * abs(lhs) * 4
    g = np.random.default_rng(seed).standard_normal(part.mesh.n_cells)
    for d, r in enumerate(res):
        gc = np.nonzero(part.g2l[d] >= 0)[0]
        np.testing.assert_array_equal(
            r[f"{key}/restored"][part.g2l[d, gc]], g[gc])


def test_halo_exchange_two_ranks(runs):
    _check_halo(runs["world2"], "halo", 2, 1, 0)


def test_halo_exchange_two_rings(runs):
    _check_halo(runs["world2"], "halo2", 2, 2, 5)


def test_halo_exchange_four_ranks(runs):
    _check_halo(runs["world4"], "halo", 4, 1, 2)


@pytest.mark.parametrize("shards", [2, 4])
def test_thermal_matches_sharded_fvm_tpu(shards, runs):
    r = runs[f"world{shards}"][0]
    hist, T, fluxes = runs[f"thermal{shards}"]
    _close(r["thermal/T"], T)
    _same_history(r["thermal/hist"], hist)
    np.testing.assert_allclose(r["thermal/fluxes"], fluxes, rtol=FIELD_RTOL,
                               atol=FIELD_RTOL * max(map(abs, fluxes)))


def test_species_matches_sharded_fvm_tpu(runs):
    hist, mf, fluxes = runs["species"]
    r = runs["world2"][0]
    _close(r["species/mf"], mf)
    _same_history(r["species/hist"], hist)
    np.testing.assert_allclose(r["species/fluxes"], fluxes, rtol=FIELD_RTOL,
                               atol=FIELD_RTOL * max(map(abs, fluxes)))


def test_electric_matches_sharded_fvm_tpu(runs):
    hist, phi = runs["electric"]
    r = runs["world2"][0]
    _close(r["electric/phi"], phi)
    _same_history(r["electric/hist"], hist)


def test_coupled_step_from_fvm_tpu_state(runs):
    _, (flow, thermal), res = runs["coupled"]
    world2 = runs["world2"]
    np.testing.assert_allclose(world2[0]["coupled/res"], res,
                               rtol=FIELD_RTOL)
    for prefix, ref in (("flow", flow), ("thermal", thermal)):
        tag = f"coupled/{prefix}:"
        got = stack_states([{k[len(tag):]: v for k, v in r.items()
                             if k.startswith(tag)} for r in world2])
        assert set(got) == set(ref)
        for k, v in ref.items():
            g = got[k]
            if k != "massFlux":  # cell arrays: drop the dummy cell
                g, v = g[:, :-1], v[:, :-1]
            _close(g, v)


def test_tri_general_amg_matches_single(runs):
    r = runs["world2"][0]
    assert str(r["tri/amg"]) == "general"
    hist, T1 = runs["tri"]
    np.testing.assert_allclose(r["tri/T"], T1, atol=2e-6)
    assert len(r["tri/hist"]) == len(hist)
    for a, b in zip(r["tri/hist"], hist):
        assert abs(a - b) <= 1e-4 * max(b, 1.0)


@pytest.mark.parametrize("family", list(GOLDEN_OUTERS))
def test_cavity_np4_golden(family, runs):
    with open(GOLDEN_PATH) as f:
        ref = np.array(json.load(f)[f"cavity/{family}/np4"])
    got = runs["world4"][0][f"{family}/hist"]
    assert got.shape == (GOLDEN_OUTERS[family], 2)
    np.testing.assert_allclose(got, ref[: GOLDEN_OUTERS[family]],
                               rtol=HIST_RTOL)


def test_cavity_amg_np4_tight_matches_sharded_fvm_tpu(runs):
    r = runs["world4"][0]
    hist, V, mass, force = runs["tight"]
    assert str(r["tight/amg"]) == "structured"
    np.testing.assert_allclose(r["tight/hist"], hist, rtol=HIST_RTOL)
    np.testing.assert_allclose(r["tight/velocity"], V, rtol=0,
                               atol=FIELD_RTOL * np.abs(V).max())
    # the walls' flux integrals (flow.py's distributed group sums): forces
    # at 1e-10 of the largest; the walls' net mass flux is round-off of 0
    # in both, held at 1e-10 of the largest force
    np.testing.assert_allclose(r["tight/momentum"], force, rtol=0,
                               atol=FIELD_RTOL * np.abs(force).max())
    np.testing.assert_allclose(r["tight/mass"], mass, rtol=0,
                               atol=FIELD_RTOL * np.abs(force).max())


def test_ranks_import_no_jax(runs):
    for r in runs["world4"]:
        assert r["imports/bad"].size == 0, r["imports/bad"]


def test_no_quiet_fallback():
    """NCCL with more ranks than GPUs raises (no switch to gloo); a failed
    rank, and a world past its time limit, raise ``RankError`` after every
    rank is killed."""
    from fvm_tpu_torch.exceptions import ConfigError, RankError
    from fvm_tpu_torch.parallel.launch import check_backend

    with pytest.raises(ConfigError, match="nccl"):
        check_backend("nccl", "cpu", 2)
    with pytest.raises(ConfigError):
        run_ranks("dist_probe_rank", 2, device="cpu", backend="nccl")
    with pytest.raises(RankError, match="KeyError"):
        run_ranks("dist_cavity_rank", 1, {"n": 8, "solver": "NONE"},
                  device="cpu", backend="gloo", timeout=RANK_TIMEOUT)
    with pytest.raises(RankError, match="timed out"):
        run_ranks("dist_probe_rank", 1, device="cpu", backend="gloo",
                  timeout=0.5)
