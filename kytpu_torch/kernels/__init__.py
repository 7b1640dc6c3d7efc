"""Hopper kernels of the port and their plain PyTorch versions.

`wavefront` holds the forward path-tracing megakernel (the counterpart of
kytpu/kernels/wavefront.py's Pallas kernel): its host-side scene tables, the
plain torch transcription used on CPU tensors and as the on-card reference,
and the wrapper that launches `csrc/wavefront_fwd.cu` on CUDA tensors.
"""
