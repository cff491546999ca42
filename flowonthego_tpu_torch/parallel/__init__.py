from .frame_parallel import batched_flow, stream_flow
from .multistream import MultiStream, stream_video_chunks

__all__ = ["batched_flow", "stream_flow", "MultiStream",
           "stream_video_chunks"]
