from repro_torch.session.infer import InferenceSession
from repro_torch.session.train import TrainSession

__all__ = ["InferenceSession", "TrainSession"]
