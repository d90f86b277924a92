"""Cross-request fetch planning: range coalescing for batched reads.

Cloud object stores price and throttle per *request*, and the simulated
`NetworkModel` charges every request a first-byte latency — so two range
reads that land near each other in the same block are strictly cheaper as
one spanning read plus local slicing, as long as the gap bytes cost less
than a round of first-byte latency (gap ≈ first_byte_s × bandwidth is the
break-even; the default 4 KiB is far below it for any realistic link).

`coalesce_requests` merges overlapping / adjacent / near-adjacent ranges
within the same blob and returns slice records so callers can recover the
exact per-request payloads — byte-identical to issuing the originals.
"""

from __future__ import annotations

from ..storage.blobstore import RangeRequest

# (merged request index, byte offset of the original range inside it)
Slice = tuple[int, int]


def coalesce_requests(requests: list[RangeRequest], gap: int = 0,
                      ) -> tuple[list[RangeRequest], list[Slice]]:
    """Merge same-blob ranges whose gaps are <= `gap` bytes.

    Returns `(merged, slices)` with `slices[i] = (j, start)` meaning
    original request `i` is bytes `[start, start + requests[i].length)` of
    `merged[j]`'s payload. Unbounded requests (`length=-1`) pass through
    unmerged. Output order is deterministic: unbounded requests in input
    order first-seen, then merged runs grouped by blob (first-appearance
    order) ascending by offset.
    """
    merged: list[RangeRequest] = []
    slices: list[Slice | None] = [None] * len(requests)
    by_blob: dict[str, list[int]] = {}
    for i, r in enumerate(requests):
        if r.length < 0:
            slices[i] = (len(merged), 0)
            merged.append(r)
        else:
            by_blob.setdefault(r.blob, []).append(i)

    for blob, idxs in by_blob.items():
        idxs.sort(key=lambda i: (requests[i].offset, requests[i].length))
        run: list[int] = []
        run_start = run_end = 0
        for i in idxs:
            r = requests[i]
            if run and r.offset <= run_end + gap:
                run.append(i)
                run_end = max(run_end, r.offset + r.length)
            else:
                _flush(run, run_start, run_end, blob, requests, merged, slices)
                run = [i]
                run_start, run_end = r.offset, r.offset + r.length
        _flush(run, run_start, run_end, blob, requests, merged, slices)
    return merged, slices  # type: ignore[return-value]


def _flush(run: list[int], start: int, end: int, blob: str,
           requests: list[RangeRequest], merged: list[RangeRequest],
           slices: list[Slice | None]) -> None:
    if not run:
        return
    j = len(merged)
    merged.append(RangeRequest(blob, start, end - start))
    for i in run:
        slices[i] = (j, requests[i].offset - start)


def slice_payloads(requests: list[RangeRequest],
                   merged_payloads: list[bytes | None],
                   slices: list[Slice]) -> list[bytes | None]:
    """Recover each original request's payload from the merged fetches."""
    out: list[bytes | None] = []
    for req, (j, start) in zip(requests, slices):
        blob = merged_payloads[j]
        if blob is None:
            out.append(None)
        elif req.length < 0:
            out.append(blob)
        else:
            out.append(blob[start:start + req.length])
    return out
