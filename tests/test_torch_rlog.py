"""The port's channel logging and phase tracer (``fvm_tpu_torch.core.rlog``):
the three cases of ``tests/test_rlog.py`` on the port's thermal model
(CPU, float64)."""

import io
import sys

import fvm_tpu_torch as fvm
from fvm_tpu_torch.core import rlog
from fvm_tpu_torch.models import ThermalModel


def make_thermal(**opts):
    dm = fvm.mesh.build_device_mesh(fvm.mesh.generate.quad_2d(8, 8),
                                    dtype="float64", device="cpu")
    t = ThermalModel(dm)
    t.options["verbose"] = False
    for k, v in opts.items():
        t.options[k] = v
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.bc["top"].bc_type = "Symmetry"
    t.bc["bottom"].bc_type = "Symmetry"
    t.init()
    return t


def test_channel_hierarchy():
    assert rlog.is_enabled("info/warning")  # on by default
    rlog.enable("solver")
    assert rlog.is_enabled("solver")
    rlog.disable("solver")
    assert not rlog.is_enabled("solver")
    rlog.enable("cdtor")
    assert rlog.is_enabled("cdtor/ctor")  # a prefix enables its subtree
    rlog.disable("cdtor")


def test_model_channel_captures_residuals():
    buf = io.StringIO()
    rlog.set_sink(buf)
    rlog.enable("model")
    try:
        t = make_thermal(relativeTolerance=1e-30, absoluteTolerance=0.0)
        t.advance(3)
    finally:
        rlog.disable("model")
        rlog.set_sink(sys.stderr)
    out = buf.getvalue()
    assert "[model] ThermalModel: 0:" in out
    assert out.count("[model]") == 3


def test_phase_tracer():
    rlog.tracer.reset()
    t = make_thermal(profile=True, relativeTolerance=1e-30,
                     absoluteTolerance=0.0)
    t.advance(4)
    rows = rlog.tracer.report()
    assert "ThermalModel/step" in rows
    assert rows["ThermalModel/step"]["calls"] >= 3  # may reach 0.0 early
    assert rows["ThermalModel/step"]["seconds"] > 0
    rlog.tracer.reset()
