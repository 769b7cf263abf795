"""Evaluation and checkpoints of the port."""
