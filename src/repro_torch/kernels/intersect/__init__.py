from .ops import (LAST_SHAPE, LAUNCHES, LIBRARY, OP_AND, OP_ANDNOT,
                  OP_OR, bitmap_to_docs, combine_batch, combine_cluster,
                  intersect, intersect_batch, launch, pack_cluster_programs,
                  pack_programs, postings_to_bitmap, postings_to_bitmap_batch,
                  reset_launches, resolve_device, to_numpy)
from .ref import (combine_batch_ref, combine_cluster_ref, intersect_batch_ref,
                  intersect_ref, popcount)

__all__ = ["LAST_SHAPE", "LAUNCHES", "LIBRARY", "OP_AND", "OP_ANDNOT",
           "OP_OR", "bitmap_to_docs", "combine_batch", "combine_cluster",
           "intersect", "intersect_batch", "launch", "pack_cluster_programs",
           "pack_programs", "postings_to_bitmap", "postings_to_bitmap_batch",
           "reset_launches", "resolve_device", "to_numpy",
           "combine_batch_ref", "combine_cluster_ref", "intersect_batch_ref",
           "intersect_ref", "popcount"]
