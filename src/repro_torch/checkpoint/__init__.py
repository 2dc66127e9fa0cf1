from .checkpointer import Checkpointer  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
