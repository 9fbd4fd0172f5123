"""devspace_tpu_torch: the PyTorch/CUDA port of devspace_tpu's serving,
LM training and model zoo.

The JAX package ``devspace_tpu`` is the reference; this package computes
the same functions in PyTorch, and every Pallas kernel on its path is a
kernel written by hand for NVIDIA Hopper (``sm_90a``) under ``csrc/``.
It imports ``torch`` and numpy, never ``jax`` and nothing of
``devspace_tpu``.

Layout mirrors the reference: ``ops/`` (kernels and their plain
versions), ``models/`` (the Llama-family transformer, the Mixtral-style
MoE, ResNet, ViT and the MLP), ``parallel/`` (the single-device MoE
routing), ``inference/`` (the continuous-batching engine), ``training/``
(synthetic data and the input pipeline, the classifier, LM and MoE train
steps, checkpoints, the profiler) and ``serve.py`` (the HTTP server,
``python -m devspace_tpu_torch.serve --port N``).
"""

__version__ = "0.1.0"
