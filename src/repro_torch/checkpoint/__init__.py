"""Crash-safe, asynchronous checkpointing of the port's state trees."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401

__all__ = ["Checkpointer"]
