from .ops import (LAST_SHAPE, LAUNCHES, LIBRARY, OP_AND, OP_ANDNOT, OP_OR,
                  bitmap_to_docs, combine_batch, combine_cluster,
                  combine_keys, intersect, intersect_batch, intersect_keys,
                  keys_per_row, launch, pack_cluster_programs, pack_programs,
                  postings_to_bitmap, postings_to_bitmap_batch,
                  rank_postings, reset_launches, resolve_device, to_numpy)
from .ref import (bits_to_keys_ref, combine_batch_ref, combine_cluster_ref,
                  combine_postings_ref, intersect_batch_ref, intersect_ref,
                  popcount)

__all__ = ["LAST_SHAPE", "LAUNCHES", "LIBRARY", "OP_AND", "OP_ANDNOT",
           "OP_OR", "bitmap_to_docs", "combine_batch", "combine_cluster",
           "combine_keys", "intersect", "intersect_batch", "intersect_keys",
           "keys_per_row", "launch", "pack_cluster_programs",
           "pack_programs", "postings_to_bitmap", "postings_to_bitmap_batch",
           "rank_postings", "reset_launches", "resolve_device", "to_numpy",
           "bits_to_keys_ref", "combine_batch_ref", "combine_cluster_ref",
           "combine_postings_ref", "intersect_batch_ref", "intersect_ref",
           "popcount"]
