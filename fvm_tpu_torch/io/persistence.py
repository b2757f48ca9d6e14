"""Checkpoint / resume (counterpart of ``fvm_tpu/io/persistence.py``).

The reference's HDF5 Persistence layer (Persistence.py:3-37 writeField /
readField / saveMeshes, with Model::getPersistenceData / restart,
Model.h:23-26) as one compressed ``.npz`` archive per checkpoint: every
registered model's persistence dict (all time levels) and the node
coordinates.  The archive's keys are the JAX package's, so a checkpoint of
either package restores into the other's models.
"""

from __future__ import annotations

import numpy as np


def host(a) -> np.ndarray:
    """A host numpy array of a numpy array, a number or a tensor (copied
    from the device once)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Persistence:
    """Save / restore the state of a set of models::

        p = Persistence("ckpt.npz", mode="w")
        p.save_model("flow", flow_model)
        p.save_mesh(mesh)
        p.close()

        p = Persistence("ckpt.npz", mode="r")
        p.restore_model("flow", flow_model)
    """

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._data: dict[str, np.ndarray] = {}
        if mode == "r":
            with np.load(path, allow_pickle=False) as z:
                self._data = {k: z[k] for k in z.files}

    # -- writing -----------------------------------------------------------

    def save_model(self, name: str, model) -> None:
        for k, v in model.getPersistenceData().items():
            self._data[f"model/{name}/{k}"] = host(v)

    def save_array(self, key: str, arr) -> None:
        self._data[f"array/{key}"] = host(arr)

    def save_mesh(self, mesh) -> None:
        self._data["mesh/coords"] = np.asarray(mesh.coords)

    def close(self) -> None:
        if self.mode == "w":
            np.savez_compressed(self.path, **self._data)

    # -- reading -----------------------------------------------------------

    def restore_model(self, name: str, model) -> None:
        prefix = f"model/{name}/"
        model.restart({k[len(prefix):]: v for k, v in self._data.items()
                       if k.startswith(prefix)})

    def load_array(self, key: str) -> np.ndarray:
        return self._data[f"array/{key}"]

    def keys(self):
        return list(self._data)
