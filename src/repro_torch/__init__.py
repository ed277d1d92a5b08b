"""PyTorch + CUDA port of ``repro`` (RRAM crossbar deployment with DoRA
calibration), module for module.

The package mirrors ``repro`` file for file and keeps its parameter-tree
layout (nested dicts and lists, scan-group leaves stacked on axis 0), so
trees cross between the two through numpy (``repro_torch.interop``).
It imports ``torch`` and numpy only. The fused crossbar + DoRA linear is
a CUDA kernel written for Hopper (``kernels/csrc/dora_linear.cu``),
built with ``nvcc`` at first use; a tensor on the CPU takes the kernel's
plain PyTorch version instead.

Entry points (``deploy.Deployment.program``, ``launch/serve.py``) run on
``device="cuda"`` unless the caller asks for the CPU, and raise when no
card is present.
"""
