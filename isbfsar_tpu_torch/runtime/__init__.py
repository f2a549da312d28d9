"""The serving layer: the orchestrator, its command protocol and transports."""
