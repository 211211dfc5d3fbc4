"""Plain PyTorch references of the benchmark's configurations.

Each module computes its configuration's training step in plain ``torch``
operations, in float32 by default with TF32 switched off, and imports
nothing of the program under test, of ``jax`` or of the JAX package.  It
takes only what the benchmark hands to both sides: the seeded weights
and batches.
"""
