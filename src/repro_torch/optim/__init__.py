"""Optimizer and gradient compression of the port."""
