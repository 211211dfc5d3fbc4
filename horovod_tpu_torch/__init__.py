"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The JAX package (``horovod_tpu``) is the reference; this package mirrors
its module paths (``serve/engine.py`` here is the counterpart of
``horovod_tpu/serve/engine.py``) and is held against it by the
``tests/test_torch_port_*.py`` parity tests.  It never imports ``jax`` or
anything of ``horovod_tpu``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); without a GPU and without that
request they raise instead of falling back quietly.  Every TPU kernel on
a ported path is a hand-written Hopper kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``).

Ported so far: the paged-KV serving replica (``serve/``) over the dense
Llama model (``models/``) with the fused paged-attention decode kernel
(``ops/paged_attention.py``).
"""

from horovod_tpu_torch.common.device import resolve_device

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]
