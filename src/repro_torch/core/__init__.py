"""IoU Sketch core: hashing, sketch structure, accuracy analysis, optimizer."""

from .analysis import (CorpusProfile, F_approx, F_exact, L_star_per_doc,
                       fast_region_bound, feasibility_lower_bound,
                       hoeffding_epsilon, q_approx, q_exact, sigma_x)
from .hashing import HashFamily, fingerprints, word_fingerprint
from .optimizer import InfeasibleSketchError, LayerChoice, minimize_layers
from .sketch import IoUSketch, SketchSpec, intersect_sorted, union_sorted
from .topk import sample_size

__all__ = [
    "CorpusProfile", "F_approx", "F_exact", "L_star_per_doc",
    "fast_region_bound", "feasibility_lower_bound", "hoeffding_epsilon",
    "q_approx", "q_exact", "sigma_x", "HashFamily", "fingerprints",
    "word_fingerprint", "InfeasibleSketchError", "LayerChoice",
    "minimize_layers", "IoUSketch", "SketchSpec", "intersect_sorted",
    "union_sorted", "sample_size",
]
