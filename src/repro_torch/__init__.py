"""IPLS on PyTorch and CUDA: the port of ``repro`` (JAX) to NVIDIA Hopper.

Same module layout as ``repro``. Entry points run on CUDA unless the caller
passes ``device="cpu"``; see ``repro_torch.fl.make_simulation``.
"""
