"""Serving of the port: request lifecycle and the dense slot engine."""
