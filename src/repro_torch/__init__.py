"""PyTorch/CUDA port of the eFPGA readout system (the ``repro`` package).

The JAX package ``repro`` is the reference; this package keeps its module
layout and names so each counterpart is easy to find, and imports nothing
of it (nor JAX). Numpy modules the port needs (synthesis, fabric,
bitstream, host oracles) are kept here as copies.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU request they
raise ``DeviceUnavailableError`` (see ``repro_torch.device``). Hot loops
are hand-written CUDA C++ kernels for sm_90a (``repro_torch/kernels/csrc``),
each with a plain PyTorch twin that CPU tensors run through.
"""
from repro_torch.device import (  # noqa: F401
    DeviceUnavailableError,
    resolve_device,
)
