"""The SOAP simulator and search of the port (counterpart of
``dlrm_flexflow_tpu/sim``): per-op costs (analytic, calibrated, or
measured on the CUDA card) on an H100 machine model, the event
simulator, the MCMC search in Python or native C++, and the closed
tuning loop (``tune.py``: calibration fits from ``op_time`` telemetry,
re-search, versioned strategy artifacts and the promotion gate)."""

from .cost_model import CostModel, H100MachineModel, PodTopology
from .search import mcmc_search
from .simulator import Simulator
from .tune import Calibration, fit_calibration, search_tune

__all__ = ["CostModel", "H100MachineModel", "PodTopology", "Simulator",
           "mcmc_search", "Calibration", "fit_calibration", "search_tune"]
