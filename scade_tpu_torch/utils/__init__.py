"""Flags, checkpoints and logging of the train/test CLI."""
