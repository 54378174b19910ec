from repro_torch.session.evalsess import EvalSession
from repro_torch.session.infer import InferenceSession
from repro_torch.session.scheduler import (ContinuousBatchingScheduler, RequestQueue,
                                           ServingStats)
from repro_torch.session.train import TrainSession

__all__ = ["ContinuousBatchingScheduler", "EvalSession", "InferenceSession", "RequestQueue",
           "ServingStats", "TrainSession"]
