"""Training-side pieces of the port: the DV-DVFS controller (the serving
engine uses its actuator and ledger) and the straggler detector (the cluster
controller's drift tracker).  The training loop comes with a later slice
(ROADMAP Queue 1 item 11)."""
from repro_torch.train.dvfs_controller import (DVFSController, EnergyLedger,
                                               SimulatedActuator)
from repro_torch.train.straggler import StragglerDetector

__all__ = ["DVFSController", "EnergyLedger", "SimulatedActuator",
           "StragglerDetector"]
