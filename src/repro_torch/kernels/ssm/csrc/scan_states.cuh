// The steps between the states that scan_fused (selective_scan.cu) saves
// for the backward and the chunk that scan_bwd (selective_scan_bwd.cu)
// recomputes from each: (B, ceil(S / SCAN_STATE_STEPS), D, N) float32.
// Included by both, never compiled on its own.

#pragma once

#define SCAN_STATE_STEPS 8
