from repro_torch.checkpoint.store import (  # noqa: F401
    save_checkpoint, restore_latest, restore_step, list_steps, CheckpointError,
    CheckpointWriter, RetryPolicy,
)
from repro_torch.checkpoint.elastic import reshard_state  # noqa: F401
