"""Training-side pieces of the port.  Only the DV-DVFS controller is here for
now (the serving engine uses its actuator and ledger); the training loop
comes with a later slice (ROADMAP Queue 1 item 11)."""
from repro_torch.train.dvfs_controller import (DVFSController, EnergyLedger,
                                               SimulatedActuator)

__all__ = ["DVFSController", "EnergyLedger", "SimulatedActuator"]
