"""Runnable demos (twins of the repository's ``examples/``): episodic
training with FSOS evaluation, and multi-stream serving over a mesh."""
