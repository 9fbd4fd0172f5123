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
steps, checkpoints, the profiler), ``obs/`` (metrics, traces, events,
SLOs, the fleet collector), ``serving/`` (the replica fleet, the prefix
router and its gateway), ``resilience/`` (retry policies, the
supervisor) and ``serve.py`` (the HTTP server, ``python -m
devspace_tpu_torch.serve --port N``). The host side that takes a project
to a cluster: ``config/``, ``generator/``, ``deploy/``, ``lint/``,
``kube/`` (the API-server client and a fake cluster), ``builder/``,
``analyze/`` and ``cli/`` (``python -m devspace_tpu_torch deploy``).
"""

__version__ = "0.1.0"
