"""Training in the port: the fault-tolerant DV-DVFS training loop
(``Trainer``, ``make_train_step``), the DV-DVFS controller (the serving
engine uses its actuator and ledger) and the straggler detector (the
cluster controller's drift tracker)."""
from repro_torch.train.loop import (NodeFailure, TrainConfig, Trainer,
                                    make_train_step)
from repro_torch.train.dvfs_controller import (DVFSController, EnergyLedger,
                                               SimulatedActuator)
from repro_torch.train.straggler import StragglerDetector

__all__ = ["Trainer", "TrainConfig", "make_train_step", "NodeFailure",
           "DVFSController", "EnergyLedger", "SimulatedActuator",
           "StragglerDetector"]
