"""Transport of the port."""
from .wire import (WireError, WireTruncationError, decode, default_key,
                   encode, recv_frame, send_frame)

__all__ = ["WireError", "WireTruncationError", "decode", "default_key",
           "encode", "recv_frame", "send_frame"]
