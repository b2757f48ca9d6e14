"""Equation-of-state and property models coupling into flow and thermal
(``fvm_tpu/models/property_models.py``).

* IdealGasDensityModel (the reference's IdealGasDensityModel.h:38,
  IdealGasDensityModel_impl.h:50-75): the flow density from rho = (p +
  p_operating) / (R T) with under-relaxation, R = 8314 / molWt;
* RosselandModel (RosselandModel.h:36, RosselandModel_impl.h:50-66): the
  Rosseland radiative-diffusion conductivity k = 16 sigma gamma n^2 T^3,
  gamma = 1 / (3 (a + sigma_s) - C sigma_s).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.options import BoundaryCondition
from .base import Model, single_device_model

STEFAN_BOLTZMANN = 5.670374419e-8
R_UNIVERSAL = 8314.0  # J/(kmol K): the reference's Rgas = 8314 / molWt


class IdealGasVC(BoundaryCondition):
    _defaults = {
        "operatingPressure": 101325.0,
        "molecularWeight": 28.966,
        "urf": 1.0,
        "pressure": 0.0,  # gauge; constant or per cell
        "temperature": 300.0,
    }


class IdealGasDensityModel(Model):
    """Updates ``flow.params['rho']`` from the p and T fields (or the VC's
    values where a model is absent)."""

    name = "IdealGasDensityModel"

    def __init__(self, mesh, flow_model=None, thermal_model=None,
                 partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.vc = IdealGasVC()
        self.flow = flow_model
        self.thermal = thermal_model
        self._rho = None

    def init(self):
        self._initialized = True

    def advance(self, niter: int = 1) -> bool:
        vc, mesh = self.vc, self.mesh
        Rgas = R_UNIVERSAL / float(vc["molecularWeight"])
        p_op = float(vc["operatingPressure"])
        urf = float(vc["urf"])
        if self.flow is not None and "pressure" in self.flow.state:
            p = self.flow.state["pressure"]
        else:
            p = vc.resolve("pressure", mesh.n_cells, mesh.dtype, mesh.device)
        if self.thermal is not None and "T" in self.thermal.state:
            T = self.thermal.state["T"]
        else:
            T = vc.resolve("temperature", mesh.n_cells, mesh.dtype,
                           mesh.device)
        rho_new = (p + p_op) / (Rgas * torch.clamp(T, min=1e-300))
        if self.flow is not None:
            old = self.flow.params["rho"]
            self.flow.params["rho"] = urf * rho_new + (1.0 - urf) * old
        self._rho = rho_new
        return True

    def getDensity(self) -> np.ndarray:
        return self._rho[: self.mesh.n_interior_cells].cpu().numpy()


class RosselandVC(BoundaryCondition):
    _defaults = {
        "absorptionCoefficient": 1.0,  # a
        "scatteringCoefficient": 0.0,  # sigma_s
        "anisotropyFactor": 0.0,  # C
        "refractiveIndex": 1.0,  # n
    }


class RosselandModel(Model):
    """Sets the thermal model's conductivity to the Rosseland radiative
    conductivity of its current temperature."""

    name = "RosselandModel"

    def __init__(self, mesh, thermal_model, partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.vc = RosselandVC()
        self.thermal = thermal_model
        self._k = None

    def init(self):
        self._initialized = True

    def advance(self, niter: int = 1) -> bool:
        vc = self.vc
        a = float(vc["absorptionCoefficient"])
        sig_s = float(vc["scatteringCoefficient"])
        C = float(vc["anisotropyFactor"])
        n = float(vc["refractiveIndex"])
        gamma = 1.0 / (3.0 * (a + sig_s) - C * sig_s)
        T = self.thermal.state["T"]
        k_rad = 16.0 * STEFAN_BOLTZMANN * gamma * n * n * T**3
        self.thermal.params["k_cell"] = k_rad
        self._k = k_rad
        return True

    def getConductivity(self) -> np.ndarray:
        return self._k[: self.mesh.n_interior_cells].cpu().numpy()
