"""The experiment API's training half: RunSpecs and the Trainer facade
(the reference's ``api/``; the Server facade comes with serving's
remaining queue)."""
from repro_torch.api.specs import (
    CheckpointSpec,
    ModelSpec,
    PrecisionSpec,
    RunSpec,
    TrainSpec,
)
from repro_torch.api.trainer import Trainer, log_metrics

__all__ = ["CheckpointSpec", "ModelSpec", "PrecisionSpec", "RunSpec", "TrainSpec",
           "Trainer", "log_metrics"]
