"""Hopper kernels of the port and their plain PyTorch versions.

`wavefront` holds the path-tracing megakernels (the counterparts of
kytpu/kernels/wavefront.py's Pallas kernels): the forward K1, the residual
forward K2 that also writes the coefficient cache, and the cache backward
K3; their host-side scene tables; their plain torch transcriptions, used on
CPU tensors and as the on-card reference; and the wrappers that launch
`csrc/wavefront_fwd.cu` and `csrc/wavefront_bwd_res.cu` on CUDA tensors,
K2 and K3 behind the torch.autograd.Function of `make_cuda_diff_tracer`.
"""
