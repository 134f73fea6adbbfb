"""The app layer: driver, viewer server, checkpoints, input and the
headless GUI (counterpart of ``loupiote_tpu/app``); frame timing is the
package's span recorder (``loupiote_tpu_torch/spans.py``)."""

from .checkpoint import (checkpoint_info, load_session, load_session_torch,
                         save_session, save_session_torch)
from .driver import Driver, EditorCommand
from .server import ViewerServer

__all__ = ["checkpoint_info", "load_session", "load_session_torch",
           "save_session", "save_session_torch", "Driver",
           "EditorCommand", "ViewerServer"]
