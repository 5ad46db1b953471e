"""Kernels of the port. Counterpart of ``mxnet_tpu/ops`` (the Pallas kernels
in ``pallas_kernels.py``); see :mod:`.cuda_kernels`."""
