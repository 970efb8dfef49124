"""In-process multi-node simulation (reference: src/simulation)."""

from .load_generator import LoadGenerator
from .simulation import Simulation
from . import topologies

__all__ = ["Simulation", "LoadGenerator", "topologies"]
