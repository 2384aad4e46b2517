"""The SOAP simulator and search of the port (counterpart of
``dlrm_flexflow_tpu/sim``): per-op costs (analytic, calibrated, or
measured on the CUDA card) on an H100 machine model, the event
simulator, and the MCMC search in Python or native C++.  The closed-loop
tuning (``tune.py`` beyond its strategy-artifact validator) comes with
the telemetry reports (ROADMAP.md item 6)."""

from .cost_model import CostModel, H100MachineModel, PodTopology
from .search import mcmc_search
from .simulator import Simulator

__all__ = ["CostModel", "H100MachineModel", "PodTopology", "Simulator",
           "mcmc_search"]
