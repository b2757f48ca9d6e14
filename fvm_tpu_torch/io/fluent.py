"""Fluent case / mesh (.cas / .msh) reader, ASCII and binary sections
(counterpart of ``fvm_tpu/io/fluent.py``; the reference's FluentReader,
FluentReader.h:74, on SchemeReader.h:13).  Parses the sectioned format
into a host ``Mesh``:

  (2 ND)                           dimension
  (10 (zone first last type ND)(   node coordinates (zone 0: declaration)
  (12 (zone first last type et))   cell declaration
  (13 (zone first last bctype et)( face->nodes + c0 c1, hex, 1-based
  (39/45 (zone type name ...))     zone names
  (2010/3010, 2012/3012, 2013/3013) binary variants (f32/f64 reals,
                                   i32 ints), terminated by
                                   "End of Binary Section"

The tables equal the JAX package's bit for bit, face order and cell zones
included; sections of one face type are read as one numpy block.  The
file's face orientation is ignored: the metrics orient every face area
owner -> neighbour.
"""

from __future__ import annotations

import numpy as np

from ..exceptions import MeshError
from ..mesh.connectivity import CRConnectivity
from ..mesh.mesh import Mesh

# Fluent boundary-condition zone type codes
BC_TYPE_NAMES = {
    2: "interior",
    3: "wall",
    4: "pressure-inlet",
    5: "pressure-outlet",
    7: "symmetry",
    8: "periodic-shadow",
    9: "pressure-far-field",
    10: "velocity-inlet",
    12: "periodic",
    14: "fan",
    20: "port",
    24: "outflow",
    31: "interface",
    36: "outflow",
}

_WS = b" \t\r\n"


def _match_group(data: bytes, start: int) -> int:
    """data[start] == '('; return the index just past the matching ')'
    (quoted strings skipped)."""
    depth = 0
    i = start
    n = len(data)
    while i < n:
        c = data[i: i + 1]
        if c == b'"':
            i += 1
            while i < n and data[i: i + 1] != b'"':
                i += 1
        elif c == b"(":
            depth += 1
        elif c == b")":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    raise MeshError("unbalanced parentheses in Fluent file")


class _Scanner:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def sections(self):
        """Yield (index, header, body, inline) per section: a binary body
        as ("binary", offset), consumed by the handler through
        ``take_binary`` / ``binary_ints`` + ``finish_binary``."""
        data, n = self.data, len(self.data)
        while True:
            nxt = data.find(b"(", self.pos)
            if nxt < 0:
                return
            self.pos = nxt
            sec_start = self.pos
            j = self.pos + 1
            while j < n and data[j: j + 1] not in b" (\t\r\n)":
                j += 1
            try:
                idx = int(data[self.pos + 1: j])
            except ValueError:
                self.pos += 1
                continue
            k = j
            while k < n and data[k: k + 1] in _WS:
                k += 1
            if data[k: k + 1] != b"(":
                # inline payload up to the section's close: (2 3) etc.
                end = _match_group(data, sec_start)
                inline = data[j: end - 1].decode("ascii", "replace")
                self.pos = end
                yield idx, None, None, inline
                continue
            hend = _match_group(data, k)
            header = data[k + 1: hend - 1].decode("ascii", "replace")
            k = hend
            while k < n and data[k: k + 1] in _WS:
                k += 1
            if data[k: k + 1] != b"(":
                # header-only section
                self.pos = _match_group(data, sec_start)
                yield idx, header, None, None
                continue
            if idx >= 2000:
                self.pos = k + 1
                yield idx, header, ("binary", k + 1), None
            else:
                bend = _match_group(data, k)
                body = data[k + 1: bend - 1].decode("ascii", "replace")
                self.pos = _match_group(data, sec_start)
                yield idx, header, body, None

    def take_binary(self, offset: int, count: int, dtype) -> np.ndarray:
        arr = np.frombuffer(self.data, dtype=dtype, count=count, offset=offset)
        self.pos = offset + count * arr.dtype.itemsize
        self.skip_terminator()
        return arr

    def binary_ints(self, offset: int) -> np.ndarray:
        return np.frombuffer(self.data, dtype="<i4",
                             count=(len(self.data) - offset) // 4,
                             offset=offset)

    def finish_binary(self, offset: int, n_ints_consumed: int):
        self.pos = offset + 4 * n_ints_consumed
        self.skip_terminator()

    def skip_terminator(self):
        marker = b"End of Binary Section"
        i = self.data.find(marker, self.pos)
        if i >= 0:
            j = self.data.find(b")", i)
            self.pos = (j + 1) if j >= 0 else i + len(marker)


def _mixed_faces(vals, nfaces, pos=0):
    """Faces of the mixed element type (a leading node count per face):
    (node rows, (c0, c1) pairs, ints consumed), 0-based."""
    rows, cells = [], []
    for _ in range(nfaces):
        nn = int(vals[pos])
        pos += 1
        rows.append([int(x) - 1 for x in vals[pos: pos + nn]])
        pos += nn
        cells.append((int(vals[pos]) - 1, int(vals[pos + 1]) - 1))
        pos += 2
    return rows, cells, pos


def read_fluent_mesh(path: str) -> Mesh:
    """Read a Fluent .cas / .msh (ASCII or binary sections) into a host
    Mesh, with its cell zones in ``mesh.cell_zones``."""
    with open(path, "rb") as f:
        data = f.read()

    dim = None
    coords_parts: dict[int, np.ndarray] = {}
    # per face section: (node rows as an (n, nn) array or a list of lists,
    # (n, 2) owner/neighbour, zone)
    blocks: list = []
    zone_names: dict[int, tuple[str, str]] = {}
    zone_bctype: dict[int, int] = {}
    cell_zone_decl: dict[int, tuple[int, int]] = {}  # 1-based extents
    n_nodes_decl = 0

    sc = _Scanner(data)
    for idx, header, body, inline in sc.sections():
        base = idx % 1000 if idx >= 2000 else idx
        is_binary = idx >= 2000
        real_dtype = "<f8" if idx >= 3000 else "<f4"

        if idx == 2 and (inline or header):
            toks = (inline if inline is not None else header).split()
            if toks:
                dim = int(toks[0])
        elif base == 10 and header is not None:
            toks = header.split()
            zone = int(toks[0], 16)
            first, last = int(toks[1], 16), int(toks[2], 16)
            if zone == 0:
                n_nodes_decl = max(n_nodes_decl, last)
                if is_binary and body:
                    sc.skip_terminator()
                continue
            nd = int(toks[4], 16) if len(toks) > 4 else (dim or 3)
            count = (last - first + 1) * nd
            if is_binary:
                vals = sc.take_binary(body[1], count, real_dtype) \
                    .astype(np.float64)
            else:
                vals = np.fromiter((float(t) for t in body.split()),
                                   dtype=np.float64)
            coords_parts[first] = vals.reshape(last - first + 1, nd)
        elif base == 12 and header is not None:
            toks = header.split()
            zone = int(toks[0], 16)
            if zone != 0:
                # a cell zone (reference: FluentReader.cpp:182 FluentCellZone)
                first, last = int(toks[1], 16), int(toks[2], 16)
                cell_zone_decl[zone] = (first, last)
                if is_binary and body:
                    et = int(toks[4], 16) if len(toks) > 4 else 1
                    if et == 0:
                        sc.take_binary(body[1], last - first + 1, "<i4")
                    else:
                        sc.skip_terminator()
        elif base == 13 and header is not None:
            toks = header.split()
            zone = int(toks[0], 16)
            if zone == 0:
                if is_binary and body:
                    sc.skip_terminator()
                continue
            first, last = int(toks[1], 16), int(toks[2], 16)
            zone_bctype[zone] = int(toks[3], 16)
            etype = int(toks[4], 16) if len(toks) > 4 else 0
            nfaces = last - first + 1
            if is_binary:
                ints = sc.binary_ints(body[1])
            else:
                ints = np.array([int(t, 16) for t in body.split()],
                                dtype=np.int64)
            if etype in (2, 3, 4):
                nn = etype
                pos = nfaces * (nn + 2)
                rec = np.asarray(ints[:pos], dtype=np.int64).reshape(
                    nfaces, nn + 2) - 1
                blocks.append((rec[:, :nn], rec[:, nn:], zone))
            else:
                rows, cells, pos = _mixed_faces(ints, nfaces)
                blocks.append((rows, np.asarray(cells, dtype=np.int64)
                               .reshape(-1, 2), zone))
            if is_binary:
                sc.finish_binary(body[1], pos)
        elif base in (39, 45) and header is not None:
            toks = header.split()
            try:
                zone = int(toks[0])
            except ValueError:
                continue
            ztype = toks[1] if len(toks) > 1 else ""
            name = toks[2] if len(toks) > 2 else f"zone{zone}"
            zone_names[zone] = (ztype, name)
        elif is_binary and body is not None:
            sc.skip_terminator()

    if dim is None:
        raise MeshError(f"{path}: no dimension section found")
    if not blocks:
        raise MeshError(f"{path}: no face sections found")
    if not coords_parts:
        raise MeshError(f"{path}: no node coordinates found")

    coords = np.zeros((n_nodes_decl, dim))
    for first, block in coords_parts.items():
        coords[first - 1: first - 1 + len(block)] = block[:, :dim]

    counts = np.concatenate([
        np.full(len(r), r.shape[1], np.int64) if isinstance(r, np.ndarray)
        else np.fromiter((len(x) for x in r), np.int64, count=len(r))
        for r, _, _ in blocks])
    row_ptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    col = np.concatenate([
        r.ravel() if isinstance(r, np.ndarray)
        else np.asarray([x for row in r for x in row], dtype=np.int64)
        for r, _, _ in blocks])
    face_nodes = CRConnectivity(row_ptr, col, n_nodes_decl)
    fc = np.concatenate([c for _, c, _ in blocks])
    face_zone = np.concatenate([np.full(len(c), z, np.int64)
                                for _, c, z in blocks])

    groups = []
    for zone in np.unique(face_zone).tolist():
        bctype = zone_bctype.get(zone, 3)
        ztype, name = zone_names.get(
            zone, (BC_TYPE_NAMES.get(bctype, "wall"), f"zone{zone}"))
        gtype = ztype if ztype == "interior" else BC_TYPE_NAMES.get(bctype,
                                                                    "wall")
        groups.append((zone, name, gtype, np.nonzero(face_zone == zone)[0]))

    mesh = Mesh(dim, coords, face_nodes, fc, groups)
    # Fluent numbers cells 1..N in declaration order and the Mesh never
    # renumbers them, so zone extents map onto interior-cell ids
    for zone in sorted(cell_zone_decl):
        first, last = cell_zone_decl[zone]
        ztype, name = zone_names.get(zone, ("fluid", f"zone{zone}"))
        mesh.cell_zones.append(
            (zone, name, ztype, np.arange(first - 1, last, dtype=np.int64)))
    return mesh


def read_fluent_meshes(path: str) -> list[Mesh]:
    """A Fluent case as ONE Mesh per cell zone (reference:
    FluentReader::getMeshList, FluentReader.h:89 / FluentReader.cpp:705):
    the faces between two zones become an ``interface:<partner>`` boundary
    group on each side.  A single-zone case gives ``[read_fluent_mesh]``.

    Multi-material cases can also stay on the fused mesh: masks from
    ``Mesh.cell_zone_mask``, ``Mesh.interface_faces_between`` into
    ``make_interface`` (one state tensor, as ``cases.phonon_two_zone``)."""
    from ..mesh.assemble import extract_region

    fused = read_fluent_mesh(path)
    if len(fused.cell_zones) <= 1:
        return [fused]

    meshes = []
    for ident, name, ztype, cells in fused.cell_zones:
        mask = np.zeros(fused.n_interior_cells, dtype=bool)
        mask[cells] = True
        # named after the first partner zone across the cut faces
        cut = fused.interface_faces_between(mask, ~mask)
        partner = "other"
        if len(cut):
            o, n = fused.face_cells[cut, 0], fused.face_cells[cut, 1]
            outside = np.where(mask[o], n, o)
            for pid, pname, _, pcells in fused.cell_zones:
                if pid != ident and np.isin(outside, pcells).any():
                    partner = pname
                    break
        m = extract_region(fused, mask, cut_name=f"interface:{partner}")
        m.mesh_id = int(ident)
        m.zone_name = name
        m.zone_type = ztype
        m.cell_zones = [(ident, name, ztype,
                         np.arange(len(cells), dtype=np.int64))]
        meshes.append(m)
    return meshes
