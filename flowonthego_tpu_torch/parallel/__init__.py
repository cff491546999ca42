from .frame_parallel import stream_flow

__all__ = ["stream_flow"]
