"""Hopper kernels of the port and their plain PyTorch versions.

`wavefront` holds the path-tracing megakernels (the counterparts of
kytpu/kernels/wavefront.py's Pallas kernels): the forward K1, the residual
forward K2 that also writes the coefficient cache, the cache backward K3
and the path-replay backward K4; their host-side scene tables; their plain
torch transcriptions, used on CPU tensors and as the on-card reference;
and the wrappers that launch `csrc/wavefront_fwd.cu` (K1, K2, K4) and
`csrc/wavefront_bwd_res.cu` (K3) on CUDA tensors, K2 and K3 (or K1 and
K4) behind the torch.autograd.Functions of `make_cuda_diff_tracer`.
"""
