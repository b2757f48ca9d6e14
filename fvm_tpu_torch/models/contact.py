"""ContactModel: the near-contact surface force closure
(``fvm_tpu/models/contact.py``).

The reference's ContactModel (ContactModel.h:17, ContactModel_impl.h:41
``computeSolidSurfaceForce``: gap-dependent forces between a deformable
surface and a rigid counter-surface for MEMS pull-in; scripts/
Simulator.py).  Per boundary face, per unit area, with g the gap to the
counter-surface: a penalty repulsion below ``g_c`` and an optional
attractive (van der Waals-like) term,

    f(g) = k_c max(0, g_c - g)^2 / g_c^2  -  A_h / (6 pi g^3),

along the face normal.  Host code (numpy and the k-NN tree), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np

from ..core.options import BoundaryCondition
from ..geom.search import KSearchTree


class ContactVC(BoundaryCondition):
    _defaults = {
        "contactStiffness": 1e6,  # k_c
        "contactGap": 1e-7,  # g_c
        "hamakerConstant": 0.0,  # A_h (the attractive term off)
        "minimumGap": 1e-9,
    }


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ContactModel:
    name = "ContactModel"

    def __init__(self, dmesh, counter_surface_points):
        """``dmesh``: a device mesh; ``counter_surface_points``: (np, dim)
        samples of the rigid counter-surface."""
        self.mesh = dmesh
        self.vc = ContactVC()
        self.tree = KSearchTree(np.asarray(counter_surface_points))

    def computeSolidSurfaceForce(self, group_name: str,
                                 node_displacement=None) -> np.ndarray:
        """Per-face force vectors (count, dim) on a boundary group
        (ContactModel_impl.h:41)."""
        mesh = self.mesh
        sl = mesh.group_faces(mesh.group_by_name(group_name))
        centers = _host(mesh.face_centroid)[sl]
        if node_displacement is not None:
            centers = centers + np.asarray(node_displacement)
        dist, _ = self.tree.query_batch(centers, 1)
        mag = self.gap_force(dist)
        area = _host(mesh.face_area)[sl]
        amag = _host(mesh.face_area_mag)[sl]
        nhat = area / np.maximum(amag, 1e-300)[:, None]
        # repulsion pushes back along the inward normal
        return -mag[:, None] * nhat * amag[:, None]

    def gap_force(self, gaps) -> np.ndarray:
        """Force magnitude per sample from the gap law (positive:
        repulsion); the entry point of the plate mid-surface coupling,
        where the gap to the counter-surface is known directly."""
        gap = np.maximum(np.asarray(gaps, dtype=float).reshape(-1),
                         float(self.vc["minimumGap"]))
        k_c = float(self.vc["contactStiffness"])
        g_c = float(self.vc["contactGap"])
        A_h = float(self.vc["hamakerConstant"])
        pen = np.where(gap < g_c, k_c * (g_c - gap) ** 2 / g_c**2, 0.0)
        vdw = -A_h / (6.0 * np.pi * gap**3)
        return pen + vdw
