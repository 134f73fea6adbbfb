"""The app layer: driver, viewer server, timing, checkpoints, input and
the headless GUI (counterpart of ``loupiote_tpu/app``)."""

from .checkpoint import (checkpoint_info, load_session, load_session_torch,
                         save_session, save_session_torch)
from .driver import Driver, EditorCommand
from .server import ViewerServer
from .timing import Queries, profiler_trace

__all__ = ["checkpoint_info", "load_session", "load_session_torch",
           "save_session", "save_session_torch", "Driver",
           "EditorCommand", "Queries", "profiler_trace", "ViewerServer"]
