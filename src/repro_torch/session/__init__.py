from repro_torch.session.infer import InferenceSession

__all__ = ["InferenceSession"]
