"""Hopper kernels of the port and their plain PyTorch versions.

`route` applies kytpu's family rule for the entry points: the baked
megakernels of `wavefront` (K1-K4, the counterparts of
kytpu/kernels/wavefront.py's Pallas kernels: the forward K1, the residual
forward K2 that also writes the coefficient cache, the cache backward K3
and the path-replay backward K4) up to 64 surfaces, the table kernels of
`bigscene` (K5-K8) past that. Each family holds its scene tables, its plain
torch transcriptions (used on CPU tensors and as the on-card reference)
and the wrappers that launch its csrc/*.cu kernels on CUDA tensors. What
both families share is in public modules that import neither: `launch`
(the launch protocol), `shading` (the plain per-lane shading), `autodiff`
(the autograd Functions), `tag_sums` (the sums by tag), `cull` (the cull
geometry) and `tables` (the colour, texture and light records); `camera`
draws the rays.
"""
