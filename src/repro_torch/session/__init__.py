from repro_torch.session.infer import InferenceSession
from repro_torch.session.scheduler import (ContinuousBatchingScheduler, RequestQueue,
                                           ServingStats)
from repro_torch.session.train import TrainSession

__all__ = ["ContinuousBatchingScheduler", "InferenceSession", "RequestQueue",
           "ServingStats", "TrainSession"]
