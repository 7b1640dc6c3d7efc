from kytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from kytpu_torch.utils.profiling import RenderTimer, trace_to

__all__ = ["save_checkpoint", "load_checkpoint", "RenderTimer", "trace_to"]
