"""devspace_tpu_torch: the PyTorch/CUDA port of devspace_tpu's serving and
LM training paths.

The JAX package ``devspace_tpu`` is the reference; this package computes
the same functions in PyTorch, and every Pallas kernel on its path is a
kernel written by hand for NVIDIA Hopper (``sm_90a``) under ``csrc/``.
It imports ``torch`` and numpy, never ``jax`` and nothing of
``devspace_tpu``.

Layout mirrors the reference: ``ops/`` (kernels and their plain
versions), ``models/`` (the Llama-family transformer), ``inference/``
(the continuous-batching engine), ``training/`` (synthetic corpora and
the LM train step) and ``serve.py`` (the HTTP server,
``python -m devspace_tpu_torch.serve --port N``).
"""

__version__ = "0.1.0"
