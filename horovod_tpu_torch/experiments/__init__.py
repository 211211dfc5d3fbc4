"""Experiments of the port: counterparts of the repository's
``experiments/`` scripts that run a kernel of the port on the card."""
