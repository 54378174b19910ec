from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, TokenDataset, SyntheticLM, MemmapLM, make_dataset,
    batch_iterator, pack_segments,
)
