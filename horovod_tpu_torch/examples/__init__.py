"""Runnable examples of the port, counterparts of ``examples/*.py``."""
