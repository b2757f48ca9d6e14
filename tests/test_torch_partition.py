"""The port's partitioner against the JAX package's, in process (no ranks).

``fvm_tpu_torch.parallel.Partition`` builds every shard's padded local
tables on the host; they must equal ``fvm_tpu.parallel.Partition``'s bit
for bit: the global-to-local map ``g2l``, every array of the stacked
``sharded_mesh`` (``Partition.tables``), the face groups and the halo
exchange tables ``send_idx`` / ``recv_idx``, on quad_2d, tri_2d and
hex_3d meshes, with RCB and greedy parts, halo depth 1 and 2, and a
two-material mesh whose interface owners are co-located.  ``local_mesh(r)``
is row r of the JAX package's ``sharded_mesh`` (its tensors equal the
row's arrays, cast to the mesh dtype), and ``scatter_cells`` /
``gather_cells`` round-trip (``tests/test_parallel.py:24-45``).

The cell->face tables (``cf_face``, ``cf_is_owner``, ``cf_mask``,
``cf_nbr``, slot-leading (K, n)) differ from the JAX package's by design
in the padding faces' slots only: there the dummy cell's row has one valid
slot per padding face, so its K is the padding count; the port gives them
none.  They are compared bit for bit on every row but the dummy's, in the
port's K slots; the JAX package's slots past those must be empty (invalid,
pointing at their own row) and its dummy row's valid slots must all hold
padding faces.
"""

import numpy as np
import pytest
import jax

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.parallel import Partition as JPartition
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.parallel import Partition as TPartition, greedy_partition

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="the JAX partitioner needs 4 devices")


def _split(pkg, nx=12, ny=6):
    """A two-material plate: a double-shell interface at x = 1."""
    m = pkg.mesh.generate.quad_2d(nx, ny, lx=2.0, ly=1.0)
    xc = jfvm.mesh.compute_geometry(m).cell_centroid[: m.n_interior_cells, 0]
    left = xc < 1.0
    return m.make_interface("mid", m.interface_faces_between(left, ~left),
                            left_cells=left)


MESHES = {
    "quad": lambda pkg: pkg.mesh.generate.quad_2d(16, 12),
    "tri": lambda pkg: pkg.mesh.generate.tri_2d(10, 8),
    "hex": lambda pkg: pkg.mesh.generate.hex_3d(4, 4, 6),
    "interface": _split,
}

CONFIGS = [
    ("quad", 4, {}),
    ("quad", 2, {"method": "greedy"}),
    ("quad", 4, {"halo_depth": 2}),
    ("tri", 4, {}),
    ("tri", 4, {"method": "greedy", "halo_depth": 2}),
    ("hex", 2, {}),
    ("hex", 4, {"method": "greedy"}),
    ("interface", 4, {}),
]


CF_TABLES = ("cf_face", "cf_is_owner", "cf_mask", "cf_nbr")


def _check_cf_padding(k, ref, v, sm):
    """The JAX package's (S, K_jax, n) cf table cut to the port's slots,
    after checking what is cut: past the port's K the slots are empty,
    and the dummy row's valid slots hold padding faces.  The dummy row
    compares as the port's (no slot)."""
    K = v.shape[1]
    mask = np.asarray(sm.cf_mask)
    n = mask.shape[2]
    dummy = n - 1
    extra = mask[:, K:, :dummy]
    assert not extra.any(), k
    if k == "cf_nbr":
        np.testing.assert_array_equal(
            ref[:, K:, :dummy],
            np.broadcast_to(np.arange(dummy), ref[:, K:, :dummy].shape))
    fc0, fc1 = np.asarray(sm.face_cell0), np.asarray(sm.face_cell1)
    for d in range(mask.shape[0]):
        faces = np.asarray(sm.cf_face)[d, :, dummy][mask[d, :, dummy]]
        assert (fc0[d, faces] == dummy).all(), k
        assert (fc1[d, faces] == dummy).all(), k
    out = ref[:, :K].copy()
    out[:, :, dummy] = v[:, :, dummy]
    return out


def _pair(name, shards, kw):
    return (JPartition(MESHES[name](jfvm), shards, **kw),
            TPartition(MESHES[name](tfvm), shards, **kw))


@pytest.mark.parametrize("name,shards,kw", CONFIGS,
                         ids=[f"{c[0]}-{c[1]}-{'-'.join(c[2]) or 'rcb'}"
                              for c in CONFIGS])
def test_tables_bit_for_bit(name, shards, kw):
    jp, tp = _pair(name, shards, kw)
    np.testing.assert_array_equal(tp.parts, jp.parts)
    np.testing.assert_array_equal(tp.g2l, jp.g2l)
    assert (tp.n_cells_local, tp.n_owned_local) == (jp.n_cells_local,
                                                    jp.n_owned_local)
    sm = jp.sharded_mesh
    assert tp.groups == sm.groups
    assert set(tp.tables) >= {"cf_nbr", "face_area", "cell_volume"}
    for k, v in tp.tables.items():
        ref = np.asarray(getattr(sm, k))
        if k in CF_TABLES:
            ref = _check_cf_padding(k, ref, v, sm)
        assert ref.shape == v.shape, k
        # the JAX package holds int32 indices and config-dtype floats
        # (float64 here): equal values, bit for bit
        np.testing.assert_array_equal(v, ref.astype(v.dtype), err_msg=k)
    np.testing.assert_array_equal(tp.send_idx, np.asarray(sm.halo.send_idx))
    np.testing.assert_array_equal(tp.recv_idx, np.asarray(sm.halo.recv_idx))
    for d in range(shards):
        for g in tp._bgroups:
            np.testing.assert_array_equal(
                tp.scatter_bc(g.name, np.arange(g.count) + 0.5, d),
                np.asarray(jp.scatter_bc(g.name, np.arange(g.count) + 0.5))[d])
            np.testing.assert_array_equal(
                tp.group_valid_mask(g.name, d),
                np.asarray(jp.group_valid_mask(g.name))[d])


@pytest.mark.parametrize("rank", [0, 3])
def test_local_mesh_is_a_row_of_the_sharded_mesh(rank):
    jp, tp = _pair("quad", 4, {})
    lm = tp.local_mesh(rank, "cpu")
    sm = jp.sharded_mesh
    assert (lm.n_cells, lm.n_faces, lm.n_interior_cells,
            lm.n_interior_faces, lm.groups) == (
        sm.n_cells, sm.n_faces, sm.n_interior_cells, sm.n_interior_faces,
        sm.groups)
    assert lm.max_faces_per_cell == 4  # the JAX package's: the padding count
    assert lm.dia is None and not lm.distributed  # no group: tables only
    for k in tp.tables:
        ref = np.asarray(getattr(sm, k))
        if k in CF_TABLES:
            ref = _check_cf_padding(k, ref, tp.tables[k], sm)
        np.testing.assert_array_equal(
            getattr(lm, k).numpy(),
            ref[rank].astype(getattr(lm, k).numpy().dtype), err_msg=k)
    cf_nbr, cf_mask = lm.host_cf()
    np.testing.assert_array_equal(cf_nbr, tp.tables["cf_nbr"][rank].T)
    np.testing.assert_array_equal(cf_mask, tp.tables["cf_mask"][rank].T)


def test_scatter_gather_round_trip():
    mesh = tfvm.mesh.generate.quad_2d(16, 16)
    part = TPartition(mesh, 4)
    vals = np.arange(mesh.n_cells, dtype=float)
    stacked = part.scatter_cells(vals)
    np.testing.assert_array_equal(part.gather_cells(stacked),
                                  vals[: mesh.n_interior_cells])
    for d in range(4):
        np.testing.assert_array_equal(part.scatter_cells(vals, d), stacked[d])
    # owned interior volume over the shards = the global volume
    geom = tfvm.mesh.compute_geometry(mesh)
    vol = part.tables["cell_volume"]
    total = sum(vol[d][part.g2l[d, part._own_int[d]]].sum() for d in range(4))
    assert total == pytest.approx(
        geom.cell_volume[: mesh.n_interior_cells].sum(), rel=1e-12)
    # per-group BC arrays: scattered as the JAX partitioner scatters them,
    # gathered back, and the valid-slot mask
    jpart = JPartition(jfvm.mesh.generate.quad_2d(16, 16), 4)
    for g in ("left", "top"):
        n = part.global_group_count(g)
        assert n == jpart.global_group_count(g)
        bc = np.arange(n, dtype=np.int64) + 7
        np.testing.assert_array_equal(part.scatter_bc(g, bc),
                                      np.asarray(jpart.scatter_bc(g, bc)))
        np.testing.assert_array_equal(part.gather_bc(g, part.scatter_bc(g, bc)),
                                      bc)
        np.testing.assert_array_equal(part.scatter_bc(g, bc, 2),
                                      part.scatter_bc(g, bc)[2])
        np.testing.assert_array_equal(part.group_valid_mask(g),
                                      np.asarray(jpart.group_valid_mask(g)))


def test_greedy_parts_balanced():
    mesh = tfvm.mesh.generate.quad_2d(16, 12)
    parts = greedy_partition(mesh, 4)
    counts = np.bincount(parts, minlength=4)
    assert counts.min() >= mesh.n_interior_cells // 4
    assert counts.max() <= -(-mesh.n_interior_cells // 4)


def test_later_paths_raise():
    mesh = tfvm.mesh.generate.quad_2d(8, 8)
    with pytest.raises(ConfigError, match="8b"):
        TPartition(mesh, 2, ordinate_shards=2)
    with pytest.raises(ConfigError, match="8b"):
        TPartition(mesh, 2).periodic_group_src("left")
