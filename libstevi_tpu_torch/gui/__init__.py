"""Display adapters and the interactive viewer (counterpart of
`libstevi_tpu/gui/`): numpy and matplotlib on the host."""

from .display import (ArrayDisplayAdapter, GrayscaleArrayDisplayAdapter,
                      disparity_to_color)
from .viewer import InteractiveViewer, view

__all__ = ["ArrayDisplayAdapter", "GrayscaleArrayDisplayAdapter",
           "disparity_to_color", "InteractiveViewer", "view"]
