"""Index lifecycle + build/search: Index façade, Builder, query language,
logical/physical planner, Searcher, segmented writer, compaction codec,
baselines."""

from .builder import Builder, BuilderConfig, BuildReport
from .fetch_plan import coalesce_requests, slice_payloads
from .lifecycle import (GCReport, Index, IndexWriter, MultiSegmentSearcher,
                        collect_garbage, reachable_blobs)
from .nrt import Lease, LeaseRegistry, MemorySegment
from .planner import (GramlessIndexError, PhysicalPlan, PureNegationError,
                      physical_plan)
from .query import (And, Not, Or, Phrase, Query, QuerySyntaxError, Regex,
                    Term, normalize, parse, query_words, to_string)
from .searcher import QueryResult, QueryStats, Searcher

__all__ = ["Builder", "BuilderConfig", "BuildReport", "And", "Or", "Not",
           "Phrase", "Query", "QuerySyntaxError", "Regex", "Term",
           "normalize", "parse", "query_words", "to_string",
           "PhysicalPlan", "PureNegationError", "GramlessIndexError",
           "physical_plan", "QueryResult", "QueryStats", "Searcher",
           "coalesce_requests", "slice_payloads", "Index", "IndexWriter",
           "MultiSegmentSearcher", "GCReport", "collect_garbage",
           "reachable_blobs", "MemorySegment", "Lease", "LeaseRegistry"]
