"""The experiment API: RunSpecs and the Trainer and Server facades (the
reference's ``api/``).

    from repro_torch.api import ModelSpec, RunSpec, Server, Trainer, TrainSpec

    spec = RunSpec(model=ModelSpec("smollm2-1.7b", reduced=True),
                   train=TrainSpec(steps=200), checkpoint=CheckpointSpec("/tmp/run1"))
    Trainer(spec, device="cpu").fit()
    server = Server.from_checkpoint("/tmp/run1", device="cpu")   # zero flags
    rid = server.submit(prompt_tokens)
    tokens = server.run()[rid]
"""
from repro_torch.api.specs import (
    CheckpointSpec,
    ModelSpec,
    PrecisionSpec,
    RankScheduleSpec,
    RunSpec,
    ServeSpec,
    ShardingSpec,
    StreamingSpec,
    TrainSpec,
)
from repro_torch.api.server import Server, load_run_spec
from repro_torch.api.trainer import Trainer, log_metrics

__all__ = ["CheckpointSpec", "ModelSpec", "PrecisionSpec", "RankScheduleSpec", "RunSpec",
           "ServeSpec", "ShardingSpec", "StreamingSpec", "TrainSpec", "Server",
           "load_run_spec", "Trainer", "log_metrics"]
