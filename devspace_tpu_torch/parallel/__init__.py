"""Parallelism of the port: the single-device part of expert parallelism
(the dense MoE routing). The mesh strategies wait for the port of the
reference's ``parallel/`` over ``torch.distributed``."""
