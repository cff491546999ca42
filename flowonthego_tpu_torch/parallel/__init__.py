from .frame_parallel import (batched_flow, make_data_parallel_flow,
                             stream_flow)
from .halo import (all_gather, exchange_accumulate_cols,
                   exchange_accumulate_rows, exchange_cols, exchange_rows)
from .mesh import (COL_AXIS, DATA_AXIS, ROW_AXIS, SPACE_AXIS, Mesh,
                   batch_sharding, batch_space_sharding, make_mesh,
                   make_tile_mesh, replicated)
from .multistream import MultiStream, stream_video_chunks
from .spatial import make_batch_spatial_flow, make_spatial_flow
from .spatial_fine import (displacement_bound, make_fine_spatial_flow,
                           make_fine_spatial_flow_recovering,
                           sharded_scale_levels, with_replicated_recovery)
from .spatial_tile2d import (make_tile2d_flow, make_tile2d_flow_recovering,
                             tiled2d_scale_levels)
from .varref_sharded import variational_refine_sharded
from .varref_tiled2d import make_tiled_varref, variational_refine_tile

__all__ = ["batched_flow", "make_data_parallel_flow", "stream_flow",
           "MultiStream", "stream_video_chunks", "make_mesh", "Mesh",
           "DATA_AXIS", "SPACE_AXIS", "ROW_AXIS", "COL_AXIS",
           "batch_sharding", "batch_space_sharding", "replicated",
           "exchange_rows", "exchange_accumulate_rows", "exchange_cols",
           "exchange_accumulate_cols", "all_gather",
           "make_spatial_flow", "make_batch_spatial_flow",
           "make_fine_spatial_flow", "make_fine_spatial_flow_recovering",
           "with_replicated_recovery", "sharded_scale_levels",
           "displacement_bound", "make_tile_mesh", "make_tile2d_flow",
           "make_tile2d_flow_recovering", "tiled2d_scale_levels",
           "make_tiled_varref", "variational_refine_sharded",
           "variational_refine_tile"]
