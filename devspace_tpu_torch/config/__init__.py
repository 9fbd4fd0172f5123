"""The port's project config: its own copy of ``devspace_tpu/config/``,
with a ``gpu`` block where the reference has its ``tpu`` block
(``latest.GPUConfig``)."""
