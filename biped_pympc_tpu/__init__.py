"""Batched MPC for bipedal locomotion in JAX.

A JAX re-implementation of the capabilities of rl-augmented-mpc/Biped-PyMPC:
batched SRBD convex MPC with a fixed-iteration Mehrotra PDIPM, full
swing/stance control stack, HECTOR and Booster T1 robot models — with zero
offline codegen and env-batch sharding over device meshes.

Public API mirrors the reference package root
(`/root/reference/biped_pympc/__init__.py`).
"""

from biped_pympc_tpu.config import ControllerConf, MPCConf, recommended_conf
from biped_pympc_tpu.wrapper import MPCController

__all__ = ["MPCController", "MPCConf", "ControllerConf", "recommended_conf"]
__version__ = "0.1.0"
