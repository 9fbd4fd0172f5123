"""Training of the port: synthetic data and the input pipeline, the
classifier, LM and MoE train steps, checkpoints and the profiler."""
