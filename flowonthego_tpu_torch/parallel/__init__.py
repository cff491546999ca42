from .frame_parallel import (batched_flow, make_data_parallel_flow,
                             stream_flow)
from .mesh import (DATA_AXIS, SPACE_AXIS, Mesh, batch_sharding,
                   batch_space_sharding, make_mesh, replicated)
from .multistream import MultiStream, stream_video_chunks

__all__ = ["batched_flow", "make_data_parallel_flow", "stream_flow",
           "MultiStream", "stream_video_chunks", "make_mesh", "Mesh",
           "DATA_AXIS", "SPACE_AXIS", "batch_sharding",
           "batch_space_sharding", "replicated"]
